"""The box-constrained ADMM solve in plain PyTorch (counterpart of
``tinympc_tpu.admm``).

This is the port's semantic reference: it runs at any dtype and any batch
shape ``*b`` on any device, launches no kernel of its own, and is what the
fused kernel (:mod:`tinympc_tpu_torch.kernels.admm_fused`) is held against.
Structural map (reference admm.cpp -> here):

  backward_pass_grad (admm.cpp:13-20)   -> :func:`backward_pass`
  forward_pass       (admm.cpp:25-32)   -> :func:`forward_pass`
  update_slack       (admm.cpp:81-213)  -> :func:`update_slack` (box)
  update_dual        (admm.cpp:219-256) -> :func:`update_dual`
  update_linear_cost (admm.cpp:262-304) -> :func:`update_linear_cost`
  termination_condition (admm.cpp:310-328) -> :func:`compute_residuals`
  solve              (admm.cpp:331-455) -> :func:`solve`

Convergence is tracked per problem and converged problems freeze, so
per-problem iteration counts match a single-problem solve. The loop ends
when every problem converged or ``max_iter`` is reached. The adaptive-rho,
consensus, extra-family and horizon-parallel branches of the JAX package
are not ported yet; :func:`solve` rejects them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .projections import project_box
from .types import (Cache, ConstraintData, ProblemSpec, Solution,
                    SolverState, TinyProblem, TINY_SOLVED, TINY_UNSOLVED,
                    check_supported_settings, check_supported_spec)


# ---------------------------------------------------------------- helpers

def mv(M, v):
    """M @ v on the trailing axis: M (i, j), v (..., j) -> (..., i)."""
    return v @ M.transpose(-1, -2)


def mtv(M, v):
    """M.T @ v on the trailing axis."""
    return v @ M


def _emid(a, nb: int):
    """Insert ``nb`` singleton batch axes after the leading (time) axis so
    an unbatched (T, F) table broadcasts against (T, *b, F) state."""
    if nb == 0 or a is None:
        return a
    return a.reshape(a.shape[0], *([1] * nb), *a.shape[1:])


def _maxabs_tf(a):
    """max|a| over the time and feature axes: (T, *b, F) -> (*b,)."""
    return torch.amax(torch.abs(a), dim=(0, a.ndim - 1))


def _where_tf(mask, new, old):
    """Masked commit for a (T, *b, F) leaf given a (*b,) mask."""
    return torch.where(mask[None, ..., None], new, old)


# ----------------------------------------------------------- linear cost

def update_linear_cost(prob: TinyProblem, state: SolverState, Xref, Uref
                       ) -> SolverState:
    """q/r/p[N-1] from references, slacks and duals (admm.cpp:262-304)."""
    rho = prob.cache.rho
    q = -(Xref * prob.Qdiag) - rho * (state.vnew - state.g)
    r = -(Uref * prob.Rdiag) - rho * (state.znew - state.y)
    # Terminal cost p[N-1] = -Pinf^T Xref[N-1] - rho (vnew[N-1] - g[N-1])
    # (admm.cpp:292-303: the reference's row-vector product is x^T Pinf,
    # i.e. Pinf^T x; Pinf is symmetric only up to round-off).
    pN = -mtv(prob.cache.Pinf, Xref[-1]) - rho * (state.vnew[-1]
                                                  - state.g[-1])
    p = torch.cat([state.p[:-1], torch.broadcast_to(
        pN, state.p.shape[1:])[None]], dim=0)
    return state.replace(q=q, r=r, p=p)


# --------------------------------------------------------- Riccati sweeps

def backward_pass(cache: Cache, B, state: SolverState) -> SolverState:
    """Linear (gradient) Riccati backward recursion (admm.cpp:13-20)::

        d[i] = Quu_inv (B' p[i+1] + r[i] + BPf)
        p[i] = q[i] + AmBKt p[i+1] - Kinf' r[i] + APf      i = N-2 .. 0

    ``B'`` and ``AmBKt`` multiply the same costate, so they are stacked
    into one product per step, as in the JAX package."""
    nu = B.shape[-1]
    Mback = torch.cat([B.T, cache.AmBKt], dim=0)
    KinfT = cache.Kinf.T
    N = state.p.shape[0]
    p_next = state.p[-1]
    ps, ds = [None] * (N - 1), [None] * (N - 1)
    for i in range(N - 2, -1, -1):
        out = mv(Mback, p_next)
        bp, ap = out[..., :nu], out[..., nu:]
        r_i = state.r[i]
        ds[i] = mv(cache.Quu_inv, bp + r_i + cache.BPf)
        p_next = state.q[i] + ap - mv(KinfT, r_i) + cache.APf
        ps[i] = p_next
    p = torch.stack(ps + [state.p[-1]])
    return state.replace(p=p, d=torch.stack(ds))


def forward_pass(A, B, f, cache: Cache, state: SolverState) -> SolverState:
    """LQR rollout (admm.cpp:25-32)::

        u[i] = -Kinf x[i] - d[i];  x[i+1] = A x[i] + B u[i] + f

    ``u`` is formed as an exact subtract before ``B u`` rounds; folding it
    into ``(A - B Kinf) x`` changes convergence (admm_pallas.py:442-455)."""
    nu = B.shape[-1]
    Mfwd = torch.cat([cache.Kinf, A], dim=0)
    x_i = state.x[0]
    xs, us = [x_i], []
    for i in range(state.d.shape[0]):
        out = mv(Mfwd, x_i)
        kx, ax = out[..., :nu], out[..., nu:]
        u_i = -kx - state.d[i]
        x_i = ax + mv(B, u_i) + f
        us.append(u_i)
        xs.append(x_i)
    return state.replace(x=torch.stack(xs), u=torch.stack(us))


# ----------------------------------------------------------- slack / dual

def update_slack(spec: ProblemSpec, cons: ConstraintData, state: SolverState,
                 nb: int) -> SolverState:
    """Project the candidate slacks into the box (admm.cpp:81-97)."""
    vnew = state.x + state.g
    znew = state.u + state.y
    if spec.en_state_bound:
        vnew = project_box(vnew, _emid(cons.x_min, nb), _emid(cons.x_max, nb))
    if spec.en_input_bound:
        znew = project_box(znew, _emid(cons.u_min, nb), _emid(cons.u_max, nb))
    return state.replace(vnew=vnew, znew=znew)


def update_dual(state: SolverState) -> SolverState:
    """Scaled-dual ascent (admm.cpp:219-256)."""
    return state.replace(g=state.g + state.x - state.vnew,
                         y=state.y + state.u - state.znew)


# ----------------------------------------------------------- termination

def compute_residuals(state: SolverState, rho):
    """Max-abs primal/dual residuals (admm.cpp:314-317). Shapes (*b,)."""
    pri_state = _maxabs_tf(state.x - state.vnew)
    dua_state = _maxabs_tf(state.v - state.vnew) * rho
    pri_input = _maxabs_tf(state.u - state.znew)
    dua_input = _maxabs_tf(state.z - state.znew) * rho
    return pri_state, pri_input, dua_state, dua_input


# ------------------------------------------------------------- iteration

def admm_iteration(prob: TinyProblem, state: SolverState, Xref, Uref,
                   nb: int) -> SolverState:
    """One full ADMM iteration (the body of admm.cpp:378-394)."""
    state = update_linear_cost(prob, state, Xref, Uref)
    state = backward_pass(prob.cache, prob.B, state)
    state = forward_pass(prob.A, prob.B, prob.f, prob.cache, state)
    state = update_slack(prob.spec, prob.cons, state, nb)
    return update_dual(state)


# ------------------------------------------------------------------ solve

def solve(prob: TinyProblem, state: SolverState, Xref=None, Uref=None,
          x0=None) -> Tuple[Solution, SolverState, Cache]:
    """Run ADMM to convergence (admm.cpp:331-455), functionally.

    Args:
      prob: configured problem.
      state: warm-start iterates from a previous solve, or
        :func:`~tinympc_tpu_torch.api.init_state`.
      Xref/Uref: reference trajectories, (N, nx)/(N-1, nu) or batched
        (N, *b, nx). Default zeros.
      x0: initial state, (nx,) or (*b, nx), written into x[0].

    Returns (solution, final_state, cache).
    """
    check_supported_settings(prob.settings)
    check_supported_spec(prob.spec)
    return _solve_impl(prob, state, Xref, Uref, x0)


def _solve_impl(prob, state, Xref, Uref, x0):
    spec, settings = prob.spec, prob.settings
    b = state.batch_shape
    nb = len(b)
    kw = dict(dtype=prob.dtype, device=prob.device)

    Xref = torch.zeros((spec.N, spec.nx), **kw) if Xref is None \
        else torch.as_tensor(Xref, **kw)
    Uref = torch.zeros((spec.N - 1, spec.nu), **kw) if Uref is None \
        else torch.as_tensor(Uref, **kw)
    Xref = _emid(Xref, nb) if Xref.ndim == 2 else Xref
    Uref = _emid(Uref, nb) if Uref.ndim == 2 else Uref
    if x0 is not None:
        x = state.x.clone()
        x[0] = torch.as_tensor(x0, **kw)
        state = state.replace(x=x)

    # Per-solve reset (admm.cpp:334-337).
    dev = prob.device
    state = state.replace(
        iter=torch.zeros(b, dtype=torch.int32, device=dev),
        solved=torch.zeros(b, dtype=torch.bool, device=dev),
        status=torch.full(b, TINY_UNSOLVED, dtype=torch.int32, device=dev),
    )
    rho = prob.cache.rho
    tol_p, tol_d = settings.abs_pri_tol, settings.abs_dua_tol
    converged = torch.zeros(b, dtype=torch.bool, device=dev)

    for it in range(settings.max_iter):
        active = ~converged
        new = admm_iteration(prob, state, Xref, Uref, nb)
        it1 = it + 1

        # Termination check every check_termination iterations
        # (admm.cpp:310-328, 430). Residual fields refresh only then.
        if it1 % settings.check_termination == 0:
            prs, pri, drs, dri = compute_residuals(new, rho)
            ok = (prs < tol_p) & (pri < tol_p) & (drs < tol_d) & (dri < tol_d)
            just_conv = ok & active
            new = new.replace(
                pri_res_state=torch.where(active, prs, state.pri_res_state),
                pri_res_input=torch.where(active, pri, state.pri_res_input),
                dua_res_state=torch.where(active, drs, state.dua_res_state),
                dua_res_input=torch.where(active, dri, state.dua_res_input),
            )
        else:
            just_conv = torch.zeros_like(active)

        # v/z carry-over happens only when the loop continues
        # (admm.cpp:444-446 is skipped by the converged early return).
        keep_vz = active & ~just_conv
        new = new.replace(
            v=_where_tf(keep_vz, new.vnew, state.v),
            z=_where_tf(keep_vz, new.znew, state.z),
            iter=state.iter + active.to(torch.int32),
            solved=state.solved | just_conv,
            status=torch.where(just_conv, TINY_SOLVED, state.status
                               ).to(torch.int32),
        )
        # Freeze every field of converged problems.
        state = _commit(new, state, active)
        converged = converged | just_conv
        if it1 % settings.check_termination == 0 and bool(converged.all()):
            break

    solution = Solution(iter=state.iter, solved=state.solved,
                        x=state.vnew, u=state.znew)
    return solution, state, prob.cache


def _commit(new: SolverState, old: SolverState, active) -> SolverState:
    """Commit per-problem updates only where ``active`` (shape (*b,))."""
    upd = {}
    for fld in dataclasses.fields(new):
        n, o = getattr(new, fld.name), getattr(old, fld.name)
        if n is o or n.ndim == active.ndim:   # per-problem scalars are
            continue                          # already masked
        upd[fld.name] = _where_tf(active, n, o)
    return new.replace(**upd)
