"""Batched closed-loop MPC with plant = model, in plain PyTorch (counterpart
of ``tinympc_tpu.closed_loop``).

Each step solves the receding-horizon problem with :func:`admm.solve` from
the previous step's workspace, applies the first input to the model, and
moves on; it runs at any dtype and batch shape on any device, and is what
the fused closed-loop kernel (:func:`tinympc_tpu_torch.kernels.
closed_loop_fused`) is held against.
"""
from __future__ import annotations

import torch

from . import admm
from .types import SolverState, TinyProblem

# Time-indexed iterates of the workspace, the families' included.
_TIME_FIELDS = ("x", "u", "v", "vnew", "z", "znew", "g", "y",
                "vcnew", "gc", "zcnew", "yc", "vlnew", "gl", "zlnew", "yl",
                "vlnew_tv", "gl_tv", "zlnew_tv", "yl_tv")


def shift_state(state: SolverState) -> SolverState:
    """Advance a warm-start state one timestep for receding-horizon reuse
    (the classic MPC shift warm start; the plain twin of
    :func:`~tinympc_tpu_torch.kernels.shift_carry`): every time-indexed
    iterate drops its first row and repeats the last, so the previous
    solve's tail seeds the overlapping window of the next horizon.
    Per-problem scalars and the fields of families that are off (None)
    pass through."""
    return state.replace(**{
        f: torch.cat([getattr(state, f)[1:], getattr(state, f)[-1:]], dim=0)
        for f in _TIME_FIELDS if getattr(state, f) is not None})


def closed_loop(prob: TinyProblem, state: SolverState, x0, Xref_total,
                n_steps: int, Uref=None, reset_duals: bool = False,
                shift_warm: bool = False):
    """Run ``n_steps`` of receding-horizon MPC with plant = model.

    Args:
      prob: configured problem.
      state: initial solver state (the warm-start carrier).
      x0: initial plant state, (*b, nx).
      Xref_total: (N, nx) to hold one window fixed, or a full reference
        trajectory (T, nx): step k tracks the window starting at
        ``min(k, T - N)`` (a clamped start, like ``lax.dynamic_slice``).
      Uref: optional input reference (N-1, nu).
      reset_duals: zero y/g before each solve (quadrotor_tracking.cpp:92-93).
      shift_warm: advance the warm state one timestep after each solve
        (:func:`shift_state`).

    Returns (xs, us, iters, solved, final_state): xs (n_steps, *b, nx) is the
    plant state before each step, us the applied first inputs -- the primal
    ``u[0]`` of the committed state, the raw forward-pass input, not the
    slack -- and iters/solved (n_steps, *b).
    """
    N = prob.spec.N
    kw = dict(dtype=prob.dtype, device=prob.device)
    Xref_total = torch.as_tensor(Xref_total, **kw)
    windowed = Xref_total.shape[0] != N
    x = torch.as_tensor(x0, **kw)
    xs, us, iters, solved = [], [], [], []
    for k in range(n_steps):
        if reset_duals:
            state = state.replace(y=torch.zeros_like(state.y),
                                  g=torch.zeros_like(state.g))
        if windowed:
            start = max(0, min(k, Xref_total.shape[0] - N))
            Xref = Xref_total[start:start + N]
        else:
            Xref = Xref_total
        sol, state, _ = admm.solve(prob, state, Xref, Uref, x)
        u0 = state.u[0]
        x_next = admm.mv(prob.A, x) + admm.mv(prob.B, u0) + prob.f
        if shift_warm:
            state = shift_state(state)
        xs.append(x)
        us.append(u0)
        iters.append(sol.iter)
        solved.append(sol.solved)
        x = x_next
    return (torch.stack(xs), torch.stack(us), torch.stack(iters),
            torch.stack(solved), state)
