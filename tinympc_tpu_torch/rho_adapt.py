"""Adaptive rho in plain PyTorch (counterpart of ``tinympc_tpu.rho_adapt``).

The reference builds the stacked OSQP-form matrices of the whole horizon and
takes dense matrix-vector products (rho_benchmark.cpp:14-42). Here their
action is computed on the trajectory arrays directly: the stacked
constraint matrix has only identity rows for the inputs and ``[A B -I]``
rows for the dynamics (rho_benchmark.cpp:78-94), so nothing quadratic in the
horizon is built and every function batches over ``*b``.

Parity quirk kept: the Taylor update writes Kinf, Pinf and the C1/C2
aliases, not the Quu_inv/AmBKt matrices the backward sweep reads
(rho_benchmark.cpp:204-209 against admm.cpp:17-18).
``Settings.adaptive_rho_apply_c=True`` writes those too.
"""
from __future__ import annotations

import dataclasses

import torch

from .types import Cache, Settings

RHO_EPS = 1e-10  # rho_benchmark.cpp:183


def _maxabs(a):
    """max|a| over the time and feature axes: (T, *b, F) -> (*b,)."""
    return torch.amax(torch.abs(a), dim=(0, a.ndim - 1))


def _mv(M, v):
    """M @ v on the trailing axis; a per-problem ``M`` (*b, i, j)
    broadcasts against ``v`` (..., *b, j)."""
    if M.ndim == 2:
        return v @ M.T
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    """M.T @ v on the trailing axis."""
    return _mv(M.transpose(-1, -2), v)


def osqp_residuals(A, B, Qdiag, Rdiag, Pinf, x, u, vnew, znew, g, y,
                   dPinf=None, drho=None):
    """OSQP primal/dual residuals and their normalisations of the stacked
    problem (rho_benchmark.cpp:44-173), matrix-free.

    Input rows select ``u_i``; dynamics rows form ``A x_i + B u_i -
    x_{i+1}`` (no ``f``, as in the reference). Slacks and duals pair input
    rows with (znew, y) and dynamics rows with (vnew, g) shifted one step
    (rho_benchmark.cpp:97-103). The q vector is built against a zero
    reference with Q on every stage, the terminal one included
    (rho_benchmark.cpp:127-143). ``dPinf``/``drho`` telescope a
    per-problem terminal cost ``Pinf + drho * dPinf``. Returns (pri_res,
    dual_res, pri_norm, dual_norm), each (*b,)."""
    y_dyn = g[1:]                                  # (N-1, *b, nx)
    ax_in = u
    ax_dyn = _mv(A, x[:-1]) + _mv(B, u) - x[1:]

    pri_res = torch.maximum(_maxabs(ax_in - znew),
                            _maxabs(ax_dyn - vnew[1:]))
    pri_norm = torch.maximum(
        torch.maximum(_maxabs(ax_in), _maxabs(ax_dyn)),
        torch.maximum(_maxabs(znew), _maxabs(vnew[1:])))

    # P x: Q on the stages, Pinf on the terminal state, R on the inputs
    # (rho_benchmark.cpp:105-124).
    pxN = _mv(Pinf, x[-1])
    if drho is not None:
        pxN = pxN + drho[..., None] * _mv(dPinf, x[-1])
    px_state = torch.cat([Qdiag * x[:-1], pxN[None]], dim=0)
    px_input = Rdiag * u
    q_state = Qdiag * x
    q_input = Rdiag * u

    zero_row = torch.zeros_like(x[:1])
    aty_state = (torch.cat([_mtv(A, y_dyn), zero_row], dim=0)
                 - torch.cat([zero_row, y_dyn], dim=0))
    aty_input = y + _mtv(B, y_dyn)

    dual_res = torch.maximum(_maxabs(px_state + q_state + aty_state),
                             _maxabs(px_input + q_input + aty_input))
    dual_norm = torch.maximum(
        torch.maximum(
            torch.maximum(_maxabs(px_state), _maxabs(px_input)),
            torch.maximum(_maxabs(aty_state), _maxabs(aty_input))),
        torch.maximum(_maxabs(q_state), _maxabs(q_input)))
    return pri_res, dual_res, pri_norm, dual_norm


def predict_rho(pri_res, dual_res, pri_norm, dual_norm, rho,
                settings: Settings):
    """rho * sqrt(normalised primal / normalised dual residual), clipped
    to [adaptive_rho_min, adaptive_rho_max] when adaptive_rho_clip
    (rho_benchmark.cpp:175-197). The raw prediction: the guard of
    ``adaptive_rho_tolerance > 1`` lives in the callers."""
    normalized_pri = pri_res / (pri_norm + RHO_EPS)
    normalized_dual = dual_res / (dual_norm + RHO_EPS)
    ratio = normalized_pri / (normalized_dual + RHO_EPS)
    new_rho = rho * torch.sqrt(ratio)
    if settings.adaptive_rho_clip:
        new_rho = torch.clamp(new_rho, settings.adaptive_rho_min,
                              settings.adaptive_rho_max)
    return new_rho


def taylor_update(cache: Cache, new_rho, settings: Settings) -> Cache:
    """First-order cache update ``M += (new_rho - rho) * dM/drho``
    (rho_benchmark.cpp:199-212). ``new_rho`` is a scalar or a (*b,) row
    (per problem); unbatched leaves gain its batch axes."""
    delta = (new_rho - cache.rho)[..., None, None]
    upd = dict(rho=new_rho,
               Kinf=cache.Kinf + delta * cache.dKinf_drho,
               Pinf=cache.Pinf + delta * cache.dPinf_drho,
               C1=cache.C1 + delta * cache.dC1_drho,
               C2=cache.C2 + delta * cache.dC2_drho)
    if settings.adaptive_rho_apply_c:
        upd["Quu_inv"] = cache.Quu_inv + delta * cache.dC1_drho
        upd["AmBKt"] = cache.AmBKt + delta * cache.dC2_drho
    return dataclasses.replace(cache, **upd)


def adapt_rho(prob, cache: Cache, state, settings: Settings) -> Cache:
    """One adaptation step: residuals, prediction, Taylor update
    (rho_benchmark.cpp:214-250, without the reference's second Taylor call
    at admm.cpp:421, whose delta is always zero)."""
    pri_res, dual_res, pri_norm, dual_norm = osqp_residuals(
        prob.A, prob.B, prob.Qdiag, prob.Rdiag, cache.Pinf,
        state.x, state.u, state.vnew, state.znew, state.g, state.y)
    new_rho = predict_rho(pri_res, dual_res, pri_norm, dual_norm, cache.rho,
                          settings)
    return taylor_update(cache, new_rho, settings)


def telescoped_osqp_residuals(prob, cache: Cache, drho, state):
    """OSQP residuals with the per-problem terminal cost telescoped as
    ``Pinf + drho * dPinf_drho``; ``cache`` holds the base matrices the
    ``drho`` offsets are taken from (see ``admm.Telescope``)."""
    return osqp_residuals(
        prob.A, prob.B, prob.Qdiag, prob.Rdiag, cache.Pinf,
        state.x, state.u, state.vnew, state.znew, state.g, state.y,
        dPinf=cache.dPinf_drho, drho=drho)
