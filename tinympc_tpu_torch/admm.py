"""The ADMM solve in plain PyTorch (counterpart of ``tinympc_tpu.admm``).

This is the port's semantic reference: it runs at any dtype and any batch
shape ``*b`` on any device, launches no kernel of its own, and is what the
fused kernel (:mod:`tinympc_tpu_torch.kernels.admm_fused`) is held against.
Structural map (reference admm.cpp -> here):

  backward_pass_grad (admm.cpp:13-20)   -> :func:`backward_pass`
  forward_pass       (admm.cpp:25-32)   -> :func:`forward_pass`
  update_slack       (admm.cpp:81-213)  -> :func:`update_slack`
  update_dual        (admm.cpp:219-256) -> :func:`update_dual`
  update_linear_cost (admm.cpp:262-304) -> :func:`update_linear_cost`
  termination_condition (admm.cpp:310-328) -> :func:`compute_residuals`
  slack seeding      (admm.cpp:352-376) -> :func:`seed_extra_slacks`
  solve              (admm.cpp:331-455) -> :func:`solve`

The constraint families are box, second-order cones, hyperplanes and
time-varying hyperplanes. Termination reads the box family's residuals
only, like the reference, and the solution is the box slack.

Convergence is tracked per problem and converged problems freeze, so
per-problem iteration counts match a single-problem solve. The loop ends
when every problem converged or ``max_iter`` is reached.

Adaptive rho (``Settings.adaptive_rho``) carries one rho per problem and
never builds per-problem cache copies: every matrix the Taylor update moves
is applied as the base product plus a ``drho``-scaled sensitivity product
(:class:`Telescope`).

Consensus (``ProblemSpec.en_consensus``, :func:`~.api.with_consensus`)
couples the problems of a scenario group, the last batch axis: the slack
``zc0new`` is the group mean of ``u[0] + yc0``, the consensus term
``-rho_c (zc0new - yc0)`` joins r[0], step 0 of both sweeps takes the
exact-prox gains ``Cache.Quu0_inv`` / ``Kinf0``, and a problem converges
only once ``max|u[0] - zc0new|`` is below ``abs_pri_tol`` too. Every
problem of a batch computes every iteration and converged ones commit
nothing, so a converged problem keeps feeding its group the ``u[0] +
yc0`` of one iteration past its frozen iterate, as the JAX package's XLA
path does. The horizon-parallel branch of the JAX package is not ported
yet; :func:`solve` rejects it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from .projections import (project_box, project_hyperplane_if_violated,
                          project_soc)
from .rho_adapt import (predict_rho, taylor_update,
                         telescoped_osqp_residuals)
from .types import (ADAPTIVE_RHO_PERIOD, Cache, ConstraintData, ProblemSpec,
                    Solution, SolverState, TinyProblem, TINY_SOLVED,
                    TINY_UNSOLVED, check_supported_settings,
                    check_supported_spec)


class Telescope(NamedTuple):
    """The per-problem cache of adaptive rho, never built. The Taylor
    update is linear in rho, so after any number of adaptations
    ``M_b = M_base + drho_b * dM/drho`` exactly (the deltas telescope), and
    each per-problem product is the base product plus a ``drho``-scaled
    sensitivity product. ``dC1``/``dC2`` are None unless
    ``Settings.adaptive_rho_apply_c`` retargets the matrices the sweeps
    read."""

    drho: torch.Tensor                  # (*b,) rho_b - rho_base
    dK: torch.Tensor                    # dKinf/drho
    dP: torch.Tensor                    # dPinf/drho
    dC1: Optional[torch.Tensor] = None  # dQuu_inv/drho under apply_c
    dC2: Optional[torch.Tensor] = None  # dAmBKt/drho under apply_c


# ---------------------------------------------------------------- helpers

def mv(M, v):
    """M @ v on the trailing axis: M (i, j), v (..., j) -> (..., i). A
    per-problem M (*b, i, j), the final cache of an adaptive solve,
    broadcasts against v (..., *b, j)."""
    if M.ndim == 2:
        return v @ M.transpose(-1, -2)
    return (M @ v[..., None])[..., 0]


def mtv(M, v):
    """M.T @ v on the trailing axis."""
    if M.ndim == 2:
        return v @ M
    return mv(M.transpose(-1, -2), v)


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

def _state_pairs(spec: ProblemSpec, state: SolverState):
    """(slack, dual) of each enabled state-side family, in the order box,
    SOC, hyperplane, time-varying hyperplane."""
    pairs = [(state.vnew, state.g)]
    if spec.en_state_soc and spec.state_cones:
        pairs.append((state.vcnew, state.gc))
    if spec.en_state_linear:
        pairs.append((state.vlnew, state.gl))
    if spec.en_tv_state_linear:
        pairs.append((state.vlnew_tv, state.gl_tv))
    return pairs


def _input_pairs(spec: ProblemSpec, state: SolverState):
    """(slack, dual) of each enabled input-side family, in that order."""
    pairs = [(state.znew, state.y)]
    if spec.en_input_soc and spec.input_cones:
        pairs.append((state.zcnew, state.yc))
    if spec.en_input_linear:
        pairs.append((state.zlnew, state.yl))
    if spec.en_tv_input_linear:
        pairs.append((state.zlnew_tv, state.yl_tv))
    return pairs


def consensus_rho(prob: TinyProblem):
    """The consensus weight rho_c: ``Settings.consensus_rho``, else rho."""
    rho_c = prob.settings.consensus_rho
    return prob.cache.rho if rho_c is None else rho_c


def update_linear_cost(prob: TinyProblem, state: SolverState, Xref, Uref,
                       tel: Optional[Telescope] = None) -> SolverState:
    """q/r/p[N-1] from references, slacks and duals (admm.cpp:262-304),
    each family's term subtracted in turn: box, SOC, hyperplane,
    time-varying hyperplane. With adaptive rho, ``prob.cache.rho`` is the
    (*b,) row and ``tel`` moves the terminal Pinf by ``drho * dPinf``,
    subtracted after the box term, as the JAX package does."""
    rho = prob.cache.rho
    if rho.ndim > 0:
        rho = rho[..., None]           # (*b, 1) against (T, *b, F)
    spec = prob.spec
    q = -(Xref * prob.Qdiag)
    for v, g in _state_pairs(spec, state):
        q = q - rho * (v - g)
    r = -(Uref * prob.Rdiag)
    for z, y in _input_pairs(spec, state):
        r = r - rho * (z - y)
    # Terminal cost p[N-1] = -Pinf^T Xref[N-1] - rho sum(v[N-1] - g[N-1])
    # (admm.cpp:292-303: the reference's row-vector product is x^T Pinf,
    # i.e. Pinf^T x; Pinf is symmetric only up to round-off).
    if spec.en_consensus:
        # The u[0]-only consensus prox, weighted by rho_c rather than rho.
        r = torch.cat([r[:1] - consensus_rho(prob) * (state.zc0new
                                                      - state.yc0)[None],
                       r[1:]])
    pN = -mtv(prob.cache.Pinf, Xref[-1])
    for k, (v, g) in enumerate(_state_pairs(spec, state)):
        pN = pN - rho * (v[-1] - g[-1])
        if k == 0 and tel is not None:
            pN = pN - tel.drho[..., None] * mtv(tel.dP, Xref[-1])
    p = torch.cat([state.p[:-1], torch.broadcast_to(
        pN, state.p.shape[1:])[None]], dim=0)
    return state.replace(q=q, r=r, p=p)


# --------------------------------------------------------- Riccati sweeps

def backward_pass(cache: Cache, B, state: SolverState,
                  tel: Optional[Telescope] = None,
                  consensus: bool = False) -> SolverState:
    """Linear (gradient) Riccati backward recursion (admm.cpp:13-20)::

        d[i] = Quu_inv (B' p[i+1] + r[i] + BPf)
        p[i] = q[i] + AmBKt p[i+1] - Kinf' r[i] + APf      i = N-2 .. 0

    ``B'`` and ``AmBKt`` multiply the same costate, so they are stacked
    into one product per step, as in the JAX package. With ``tel``
    (adaptive rho) each product of a matrix the Taylor update moves gains
    its ``drho``-scaled sensitivity product, in the JAX package's order.
    With ``consensus``, d[0] takes the step-0 gain ``Quu0_inv`` from its
    own ``B' p[1]`` product, as the JAX package forms it; p[0] is never
    read."""
    if tel is not None:
        return _backward_pass_telescoped(cache, B, state, tel)
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
    if consensus:
        p1 = ps[1] if N > 2 else state.p[-1]
        ds[0] = mv(cache.Quu0_inv, mtv(B, p1) + state.r[0] + cache.BPf)
    p = torch.stack(ps + [state.p[-1]])
    return state.replace(p=p, d=torch.stack(ds))


def _backward_pass_telescoped(cache: Cache, B, state: SolverState,
                              tel: Telescope) -> SolverState:
    dr = tel.drho[..., None]
    KinfT = cache.Kinf.transpose(-1, -2)
    N = state.p.shape[0]
    p_next = state.p[-1]
    ps, ds = [None] * (N - 1), [None] * (N - 1)
    for i in range(N - 2, -1, -1):
        bp, ap = mtv(B, p_next), mv(cache.AmBKt, p_next)
        r_i = state.r[i]
        w = bp + r_i + cache.BPf
        d_i = mv(cache.Quu_inv, w)
        p_i = state.q[i] + ap - mv(KinfT, r_i) + cache.APf
        p_i = p_i - dr * mtv(tel.dK, r_i)
        if tel.dC1 is not None:
            d_i = d_i + dr * mv(tel.dC1, w)
        if tel.dC2 is not None:
            p_i = p_i + dr * mv(tel.dC2, p_next)
        ps[i], ds[i], p_next = p_i, d_i, p_i
    p = torch.stack(ps + [state.p[-1]])
    return state.replace(p=p, d=torch.stack(ds))


def forward_pass(A, B, f, cache: Cache, state: SolverState,
                 tel: Optional[Telescope] = None,
                 consensus: bool = False) -> SolverState:
    """LQR rollout (admm.cpp:25-32)::

        u[i] = -Kinf x[i] - d[i];  x[i+1] = A x[i] + B u[i] + f

    ``u`` is formed as an exact subtract before ``B u`` rounds; folding it
    into ``(A - B Kinf) x`` changes convergence (admm_pallas.py:442-455).
    With ``tel`` (adaptive rho), ``Kinf x`` gains ``drho * dKinf x``. With
    ``consensus``, u[0] takes the step-0 gain ``Kinf0``, and step 0 its two
    products apart, as the JAX package forms them."""
    nu = B.shape[-1]
    Mfwd = None if tel is not None else torch.cat([cache.Kinf, A], dim=0)
    x_i = state.x[0]
    xs, us = [x_i], []
    for i in range(state.d.shape[0]):
        if consensus and i == 0:
            kx, ax = mv(cache.Kinf0, x_i), mv(A, x_i)
        elif tel is None:
            out = mv(Mfwd, x_i)
            kx, ax = out[..., :nu], out[..., nu:]
        else:
            kx = mv(cache.Kinf, x_i) + tel.drho[..., None] * mv(tel.dK, x_i)
            ax = mv(A, x_i)
        u_i = -kx - state.d[i]
        x_i = ax + mv(B, u_i) + f
        us.append(u_i)
        xs.append(x_i)
    return state.replace(x=torch.stack(xs), u=torch.stack(us))


# ----------------------------------------------------------- slack / dual

def apply_cones(cand, cones, mus):
    """SOC projections applied in turn on the last axis (admm.cpp:112-135):
    each (start, dim) cone sees the result of the one before, like the
    reference's k-loop. ``mus[k]`` broadcasts against ``cand[..., 0]``."""
    for k, (start, dim) in enumerate(cones):
        seg = project_soc(cand[..., start:start + dim], mus[k])
        cand = torch.cat([cand[..., :start], seg, cand[..., start + dim:]],
                         dim=-1)
    return cand


def apply_hyperplanes(cand, rows):
    """Violated-only hyperplane projections applied in turn
    (admm.cpp:148-211): constraint k sees the result of constraint k-1.
    ``rows`` yields (a, b) or (a, b, ||a||^2) broadcasting against ``cand``
    and ``cand[..., 0]``."""
    for row in rows:
        cand = project_hyperplane_if_violated(cand, *row)
    return cand


def tv_rows(A, b, count: int, nb: int):
    """(a, b) of the first ``count`` constraints of a time-varying (T, S, F)
    / (T, S) table, with ``nb`` singleton batch axes after the time axis."""
    return [(_emid(A[:, k, :], nb), _emid(b[:, k, None], nb)[..., 0])
            for k in range(count)]


def update_slack(spec: ProblemSpec, cons: ConstraintData, state: SolverState,
                 nb: int) -> SolverState:
    """Project each enabled family's candidate slack into its set
    (admm.cpp:81-213). Every candidate is formed from the duals as they
    were before the update."""
    vnew = state.x + state.g
    znew = state.u + state.y
    if spec.en_state_bound:
        vnew = project_box(vnew, _emid(cons.x_min, nb), _emid(cons.x_max, nb))
    if spec.en_input_bound:
        znew = project_box(znew, _emid(cons.u_min, nb), _emid(cons.u_max, nb))
    upd = dict(vnew=vnew, znew=znew)
    if spec.en_state_soc and spec.state_cones:
        upd["vcnew"] = apply_cones(state.x + state.gc, spec.state_cones,
                                   cons.cx)
    if spec.en_input_soc and spec.input_cones:
        upd["zcnew"] = apply_cones(state.u + state.yc, spec.input_cones,
                                   cons.cu)
    if spec.en_state_linear:
        upd["vlnew"] = apply_hyperplanes(
            state.x + state.gl,
            [(cons.Alin_x[k], cons.blin_x[k])
             for k in range(spec.num_state_linear)])
    if spec.en_input_linear:
        upd["zlnew"] = apply_hyperplanes(
            state.u + state.yl,
            [(cons.Alin_u[k], cons.blin_u[k])
             for k in range(spec.num_input_linear)])
    if spec.en_tv_state_linear:
        upd["vlnew_tv"] = apply_hyperplanes(
            state.x + state.gl_tv,
            tv_rows(cons.tv_Alin_x, cons.tv_blin_x,
                    spec.num_tv_state_linear, nb))
    if spec.en_tv_input_linear:
        upd["zlnew_tv"] = apply_hyperplanes(
            state.u + state.yl_tv,
            tv_rows(cons.tv_Alin_u, cons.tv_blin_u,
                    spec.num_tv_input_linear, nb))
    if spec.en_consensus:
        # Projection onto the all-equal subspace of a scenario group (the
        # last batch axis): the group mean.
        cand = state.u[0] + state.yc0                      # (*b, nu)
        m = cand.mean(dim=-2, keepdim=True) if nb >= 1 else cand
        upd["zc0new"] = m.expand(cand.shape)
    return state.replace(**upd)


def update_dual(spec: ProblemSpec, state: SolverState) -> SolverState:
    """Scaled-dual ascent for each enabled family (admm.cpp:219-256)."""
    upd = dict(g=state.g + state.x - state.vnew,
               y=state.y + state.u - state.znew)
    if spec.en_state_soc and spec.state_cones:
        upd["gc"] = state.gc + state.x - state.vcnew
    if spec.en_input_soc and spec.input_cones:
        upd["yc"] = state.yc + state.u - state.zcnew
    if spec.en_state_linear:
        upd["gl"] = state.gl + state.x - state.vlnew
    if spec.en_input_linear:
        upd["yl"] = state.yl + state.u - state.zlnew
    if spec.en_tv_state_linear:
        upd["gl_tv"] = state.gl_tv + state.x - state.vlnew_tv
    if spec.en_tv_input_linear:
        upd["yl_tv"] = state.yl_tv + state.u - state.zlnew_tv
    if spec.en_consensus:
        upd["yc0"] = state.yc0 + state.u[0] - state.zc0new
    return state.replace(**upd)


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
                   nb: int, tel: Optional[Telescope] = None) -> SolverState:
    """One full ADMM iteration (the body of admm.cpp:378-394)."""
    consensus = prob.spec.en_consensus
    state = update_linear_cost(prob, state, Xref, Uref, tel)
    state = backward_pass(prob.cache, prob.B, state, tel, consensus)
    state = forward_pass(prob.A, prob.B, prob.f, prob.cache, state, tel,
                         consensus)
    state = update_slack(prob.spec, prob.cons, state, nb)
    return update_dual(prob.spec, state)


def seed_extra_slacks(spec: ProblemSpec, state: SolverState) -> SolverState:
    """Per-solve start of the SOC and hyperplane slacks from the current
    primal iterates (admm.cpp:352-376)."""
    upd = {}
    if spec.en_state_soc and spec.state_cones:
        upd["vcnew"] = state.x
    if spec.en_input_soc and spec.input_cones:
        upd["zcnew"] = state.u
    if spec.en_state_linear:
        upd["vlnew"] = state.x
    if spec.en_input_linear:
        upd["zlnew"] = state.u
    if spec.en_tv_state_linear:
        upd["vlnew_tv"] = state.x
    if spec.en_tv_input_linear:
        upd["zlnew_tv"] = state.u
    if spec.en_consensus:
        upd["zc0new"] = state.u[0]
    return state.replace(**upd) if upd else state


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

    Returns (solution, final_state, final_cache). ``final_cache`` is
    ``prob.cache`` unless adaptive rho is on; then it is the per-problem
    cache of each problem's final rho (leaves (*b, ...) for a batch), which
    a later solve takes back as its problem's cache.
    """
    check_supported_settings(prob.settings)
    check_supported_spec(prob.spec, prob.settings)
    if prob.spec.en_consensus and prob.cache.Kinf0 is None:
        raise ValueError("en_consensus requires the step-0 consensus gains; "
                         "configure the problem via with_consensus(...)")
    if prob.settings.adaptive_rho and prob.cache.dKinf_drho is None:
        raise ValueError("adaptive rho needs the rho sensitivities; attach "
                         "them with api.with_sensitivities(prob)")
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
    state = seed_extra_slacks(spec, state)
    cache = prob.cache
    adaptive = settings.adaptive_rho
    rho0 = cache.rho
    # Adaptive rho carries one rho per problem (and the guard's virtual
    # rho), starting from the cache's rho, itself per problem when a solve
    # is entered again with an earlier adaptive solve's final cache.
    rho = rho0.expand(b).clone() if adaptive and rho0.ndim == 0 else rho0
    rho_v = rho
    tol_p, tol_d = settings.abs_pri_tol, settings.abs_dua_tol
    converged = torch.zeros(b, dtype=torch.bool, device=dev)

    for it in range(settings.max_iter):
        active = ~converged
        if adaptive:
            tel = _telescope(cache, settings, rho - rho0)
            new = admm_iteration(prob.replace(cache=dataclasses.replace(
                cache, rho=rho)), state, Xref, Uref, nb, tel)
            # Every ADAPTIVE_RHO_PERIOD iterations, on the problems still
            # active (admm.cpp:397-422): only the rho row moves; the next
            # iteration's drho carries the Taylor update into every product.
            if it > 0 and it % ADAPTIVE_RHO_PERIOD == 0:
                rho, rho_v = _adapt(prob, cache, tel, new, rho, rho_v,
                                    active, settings)
        else:
            new = admm_iteration(prob, state, Xref, Uref, nb)
        it1 = it + 1

        # Termination check every check_termination iterations
        # (admm.cpp:310-328, 430). Residual fields refresh only then.
        if it1 % settings.check_termination == 0:
            prs, pri, drs, dri = compute_residuals(new, rho)
            ok = (prs < tol_p) & (pri < tol_p) & (drs < tol_d) & (dri < tol_d)
            if spec.en_consensus:     # the consensus residual gates it too
                ok = ok & (torch.amax(torch.abs(new.u[0] - new.zc0new),
                                      dim=-1) < tol_p)
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

    if adaptive:    # the per-problem cache of the final rho
        cache = taylor_update(cache, rho, settings)
    solution = Solution(iter=state.iter, solved=state.solved,
                        x=state.vnew, u=state.znew)
    return solution, state, cache


def _telescope(cache: Cache, settings, drho) -> Telescope:
    apply_c = settings.adaptive_rho_apply_c
    return Telescope(drho=drho, dK=cache.dKinf_drho, dP=cache.dPinf_drho,
                     dC1=cache.dC1_drho if apply_c else None,
                     dC2=cache.dC2_drho if apply_c else None)


def _adapt(prob, cache, tel, new, rho, rho_v, active, settings):
    """The new (rho, virtual rho) of the active problems from the OSQP
    residuals of this iterate. With ``adaptive_rho_tolerance > 1`` every
    prediction moves the virtual rho, which commits into rho only once it
    has drifted tolerance-fold from it (the OSQP guard); else each
    prediction commits."""
    res = telescoped_osqp_residuals(prob, cache, tel.drho, new)
    tol = settings.adaptive_rho_tolerance
    if tol > 1.0:
        new_v = predict_rho(*res, rho_v, settings)
        commit = (new_v >= tol * rho) | (new_v * tol <= rho)
        return (torch.where(active & commit, new_v, rho),
                torch.where(active, new_v, rho_v))
    return torch.where(active, predict_rho(*res, rho, settings), rho), rho_v


def _commit(new: SolverState, old: SolverState, active) -> SolverState:
    """Commit per-problem updates only where ``active`` (shape (*b,)):
    (T, *b, F) iterates and the (*b, F) consensus pair."""
    upd = {}
    for fld in dataclasses.fields(new):
        n, o = getattr(new, fld.name), getattr(old, fld.name)
        if n is o or n is None or n.ndim == active.ndim:
            continue          # per-problem scalars are already masked
        upd[fld.name] = torch.where(active[..., None], n, o) \
            if n.ndim == active.ndim + 1 else _where_tf(active, n, o)
    return new.replace(**upd)
