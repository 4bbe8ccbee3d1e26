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
when every problem converged or ``max_iter`` is reached. The adaptive-rho,
consensus and horizon-parallel branches of the JAX package are not ported
yet; :func:`solve` rejects them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .projections import (project_box, project_hyperplane_if_violated,
                          project_soc)
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


def update_linear_cost(prob: TinyProblem, state: SolverState, Xref, Uref
                       ) -> SolverState:
    """q/r/p[N-1] from references, slacks and duals (admm.cpp:262-304),
    each family's term subtracted in turn: box, SOC, hyperplane,
    time-varying hyperplane."""
    rho = prob.cache.rho
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
    pN = -mtv(prob.cache.Pinf, Xref[-1])
    for v, g in _state_pairs(spec, state):
        pN = pN - rho * (v[-1] - g[-1])
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
                   nb: int) -> SolverState:
    """One full ADMM iteration (the body of admm.cpp:378-394)."""
    state = update_linear_cost(prob, state, Xref, Uref)
    state = backward_pass(prob.cache, prob.B, state)
    state = forward_pass(prob.A, prob.B, prob.f, prob.cache, state)
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
    state = seed_extra_slacks(spec, state)
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
        if n is o or n is None or n.ndim == active.ndim:
            continue          # per-problem scalars are already masked
        upd[fld.name] = _where_tf(active, n, o)
    return new.replace(**upd)
