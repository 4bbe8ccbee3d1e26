"""Fused closed-loop MPC on the GPU (counterpart of
``tinympc_tpu.kernels.closed_loop_pallas``).

:func:`closed_loop_fused` runs ``n_steps`` receding-horizon MPC steps for a
batch of plants -- warm-started box solve at fixed rho, apply u[0], step the
plant ``x+ = A x + B u0 + f``, slide the reference window -- in one launch
of the hand-written CUDA kernel ``csrc/closed_loop_fused.cu`` (it replaces
the TPU kernel ``closed_loop_pallas._kernel``). On CPU tensors it runs the
kernel's plain PyTorch version, :func:`closed_loop_fused_reference`,
instead; on CUDA tensors it launches the kernel or raises.

Layout as in the JAX package: x0s (B, nx); Xref_total (N, nx) or at least
(n_steps + N - 1, nx); results xs (T, B, nx), us (T, B, nu), iters (T, B)
int32, solved (T, B) bool; float32 throughout. Any B is taken.
"""
from __future__ import annotations

import ctypes

import torch

from ..types import TinyProblem
from . import _build
from .admm_fused import (_check, _check_arg, _prepare, _solve_plain,
                         _table_slice, _unpack_tables, _zero_carry,
                         shift_carry)

KERNEL = "closed_loop_fused"
BLOCK = 32                           # threads (= plants) per block
KERNEL_DIMS = ((12, 4),)             # (nx, nu) csrc/closed_loop_fused.cu
#                                      instantiates

# Launches of the CUDA kernel in this process; chip_smoke.py resets and
# reads it to show that the serving path went through the kernel.
launch_count = 0


def _check_loop(prob: TinyProblem) -> None:
    """Raise ``ValueError`` for a problem the closed loop does not cover.
    It takes box constraints at fixed rho only, as the JAX closed loop does
    (closed_loop_pallas.py:326): the other families and adaptive rho would
    otherwise be ignored in silence."""
    if prob.spec.any_extra_family or prob.settings.adaptive_rho:
        raise ValueError("closed_loop_fused supports box-constraint specs "
                         "with fixed rho; use tinympc_tpu_torch.closed_loop "
                         "(or solve_fused_warm in a host loop)")
    _check(prob)
    spec = prob.spec
    if (spec.nx, spec.nu) not in KERNEL_DIMS:
        raise ValueError(f"(nx, nu) = ({spec.nx}, {spec.nu}) is not one of "
                         f"the closed-loop kernel's instantiations "
                         f"{KERNEL_DIMS}")


def closed_loop_fused_supported(prob: TinyProblem) -> bool:
    """True if :func:`closed_loop_fused` handles this problem: box
    constraints only, fixed rho, ``matmul_precision="highest"``, no coarse
    schedule, and an (nx, nu) pair the kernel is instantiated for."""
    try:
        _check_loop(prob)
    except ValueError:
        return False
    return True


def _prepare_loop(prob: TinyProblem, Xref_total, x0s, n_steps, Uref):
    """Check the inputs; return the packed tables, the (n_steps + N - 1, nx)
    float32 reference trajectory, x0 and the solver parameters."""
    spec = prob.spec
    N, nx = spec.N, spec.nx
    _check_loop(prob)
    if prob.settings.max_iter < 1:
        raise ValueError("closed_loop_fused needs max_iter >= 1: the "
                         "applied input is an iterate's u[0]")
    n_steps = int(n_steps)
    if n_steps < 1:
        raise ValueError("closed_loop_fused needs n_steps >= 1")
    xtot = torch.as_tensor(Xref_total, dtype=torch.float32,
                           device=prob.device)
    if xtot.ndim != 2 or xtot.shape[1] != nx:
        raise ValueError(f"Xref_total must be (rows, {nx}), got "
                         f"{tuple(xtot.shape)}")
    if xtot.shape[0] == N:
        # One fixed window: tile its last row (closed_loop_pallas.py:336-338).
        xtot = torch.cat([xtot, xtot[-1:].expand(n_steps - 1, nx)])
    if xtot.shape[0] < n_steps + N - 1:
        raise ValueError(f"Xref_total must cover n_steps + N - 1 = "
                         f"{n_steps + N - 1} rows, got {xtot.shape[0]}")
    xtot = xtot[:n_steps + N - 1].contiguous()
    tables, x0, params = _prepare(prob, xtot[:N], Uref, x0s)
    params.pop("fam")           # box at fixed rho: _check_loop refused
    params.pop("adapt")         # the rest
    return tables, xtot, x0, n_steps, params


def closed_loop_fused(prob: TinyProblem, Xref_total, x0s, n_steps: int,
                      Uref=None, *, reset_duals: bool = False,
                      shift_warm: bool = False):
    """Run ``n_steps`` receding-horizon MPC steps for a batch of plants in
    one launch of the fused closed-loop kernel.

    Args:
      Xref_total: (n_steps + N - 1, nx) sliding reference (step k tracks
        rows k .. k+N-1), or (N, nx), which is then tiled with its last row.
      x0s: (B, nx) initial plant states.
      reset_duals: zero y/g before each solve (quadrotor_tracking.cpp:92-93).
      shift_warm: advance the carried slacks and duals one timestep between
        solves (the classic MPC shift warm start).

    Returns (xs, us, iters, solved): xs (n_steps, B, nx) the plant state
    before each step, us (n_steps, B, nu) the applied inputs (the raw
    forward-pass u[0] of the converging or last iteration), iters and solved
    (n_steps, B). Raises ``ValueError`` for a problem outside
    :func:`closed_loop_fused_supported`, a short ``Xref_total`` or
    ``max_iter`` 0."""
    tables, xtot, x0, T, params = _prepare_loop(prob, Xref_total, x0s,
                                                n_steps, Uref)
    args = (tables, xtot, x0, T, prob.spec.N, prob.spec.nx, prob.spec.nu)
    opts = dict(params, reset_duals=bool(reset_duals),
                shift_warm=bool(shift_warm))
    if x0.device.type == "cpu":
        return _loop_plain(*args, **opts)
    if x0.device.type == "cuda":
        return _loop_kernel(*args, **opts)
    raise ValueError(f"closed_loop_fused runs on cuda or cpu, not "
                     f"{x0.device}")


def closed_loop_fused_reference(prob: TinyProblem, Xref_total, x0s,
                                n_steps: int, Uref=None, *,
                                reset_duals: bool = False,
                                shift_warm: bool = False):
    """The kernel's plain PyTorch version, on the problem's device: each
    step is the warm fused solve's plain version with the kernel's load,
    freeze and carry rules, then the plant step. Returns what
    :func:`closed_loop_fused` returns."""
    tables, xtot, x0, T, params = _prepare_loop(prob, Xref_total, x0s,
                                                n_steps, Uref)
    return _loop_plain(tables, xtot, x0, T, prob.spec.N, prob.spec.nx,
                       prob.spec.nu, reset_duals=bool(reset_duals),
                       shift_warm=bool(shift_warm), **params)


def _loop_plain(tables, xtot, x0, T, N, nx, nu, *, reset_duals, shift_warm,
                **params):
    """The closed loop in the kernel's lane-last layout. Each step's warm
    solve starts from the carry the previous one handed over (the merged
    final slack, duals and stale slacks of closed_loop_pallas.py:255-290),
    after the optional dual reset, on the step's window of the reference;
    the carry is shifted after the solve when asked, and the plant steps
    with the applied u0."""
    t = _unpack_tables(tables, nx, nu, N)
    A, Bm, f = t["Mfwd"][nu:], t["Bm"], t["f"]
    win = _table_slice("Xref", nx, nu, N)
    carry = _zero_carry(N, nx, nu, x0.shape[0], x0.device)
    x = x0
    xs, us, iters, solved = [], [], [], []
    for step in range(T):
        if reset_duals:
            carry = carry.replace(g=torch.zeros_like(carry.g),
                                  y=torch.zeros_like(carry.y))
        tab = tables.clone()
        tab[win] = xtot[step:step + N].reshape(-1)
        sol, _, carry, u0 = _solve_plain(tab, x, N, nx, nu, carry=carry,
                                         **params)
        if shift_warm:
            carry = shift_carry(carry)
        xs.append(x)
        us.append(u0.T)
        iters.append(sol.iter)
        solved.append(sol.solved)
        x = x @ A.T + u0.T @ Bm.T + f
    return (torch.stack(xs), torch.stack(us), torch.stack(iters),
            torch.stack(solved))


# ------------------------------------------------------------ CUDA kernel

_PTR = ctypes.c_void_p


def _kernel_fn():
    """The C entry point of csrc/closed_loop_fused.cu, built and loaded on
    first use."""
    lib = _build.load(KERNEL)
    if lib.tinympc_closed_loop_fused_block() != BLOCK:
        raise RuntimeError("csrc/closed_loop_fused.cu and "
                           "closed_loop_fused.BLOCK disagree on the block "
                           "size")
    fn = lib.tinympc_closed_loop_fused_box
    # nx nu N B T max_iter ct | rho tol_pri tol_dua | reset shift |
    # 14 buffers, the stream
    fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_float] * 3
                   + [ctypes.c_int] * 2 + [_PTR] * 15)
    fn.restype = ctypes.c_int
    return fn


def _loop_kernel(tables, xtot, x0, T, N, nx, nu, *, max_iter, ct, rho,
                 tol_pri, tol_dua, reset_duals, shift_warm):
    """Launch csrc/closed_loop_fused.cu on the current stream of x0's
    device. Outputs and scratch are allocated here; the kernel initialises
    the scratch it reads."""
    global launch_count
    dev, B = x0.device, x0.shape[0]
    f32 = torch.float32
    _check_arg(x0, (B, nx), f32, dev)
    _check_arg(xtot, (T + N - 1, nx), f32, dev)
    _check_arg(tables, (_table_slice("umax", nx, nu, N).stop,), f32, dev)
    kw = dict(dtype=f32, device=dev)
    scratch = [torch.empty((2, N, nx, B), **kw),      # vnew halves
               torch.empty((2, N - 1, nu, B), **kw),  # znew halves
               torch.empty((N, nx, B), **kw),         # g
               torch.empty((N - 1, nu, B), **kw),     # y
               torch.empty((N, nx, B), **kw),         # vstale
               torch.empty((N - 1, nu, B), **kw),     # zstale
               torch.empty((N - 1, nu, B), **kw)]     # d
    xs = torch.empty((T, B, nx), **kw)
    us = torch.empty((T, B, nu), **kw)
    iters = torch.empty((T, B), dtype=torch.int32, device=dev)
    solved = torch.empty((T, B), dtype=torch.bool, device=dev)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(nx, nu, N, B, T, max_iter, ct, rho, tol_pri, tol_dua,
                 int(reset_duals), int(shift_warm), tables.data_ptr(),
                 xtot.data_ptr(), x0.data_ptr(),
                 *(a.data_ptr() for a in scratch), xs.data_ptr(),
                 us.data_ptr(), iters.data_ptr(), solved.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"closed_loop_fused kernel launch failed: CUDA "
                           f"error {err}")
    launch_count += 1
    return xs, us, iters, solved
