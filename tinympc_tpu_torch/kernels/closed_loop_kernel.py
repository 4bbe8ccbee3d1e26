"""Fused closed-loop MPC on the GPU (counterpart of
``tinympc_tpu.kernels.closed_loop_pallas``).

:func:`closed_loop_fused` runs ``n_steps`` receding-horizon MPC steps for a
batch of plants -- warm-started box solve at fixed rho, apply u[0], step the
plant ``x+ = A x + B u0 + f``, slide the reference window -- in one launch
of a hand-written CUDA kernel (each replaces the TPU kernel
``closed_loop_pallas._kernel``): at (12, 4) ``csrc/closed_loop_fused.cu``, a
plant a group of 16 threads (:data:`KERNEL_DIMS`); at the rocket's (6, 3),
cartpole's (4, 1) and the degenerate (2, 2), (2, 1), (3, 3), (1, 1)
``csrc/closed_loop_thread.cu``, one thread a plant
(:data:`THREAD_LOOP_DIMS`). On CPU tensors it runs the kernels' plain
PyTorch version, :func:`closed_loop_fused_reference`, instead; on CUDA
tensors it launches the kernel or raises.

Layout as in the JAX package: x0s (B, nx); Xref_total (N, nx) or at least
(n_steps + N - 1, nx); results xs (T, B, nx), us (T, B, nu), iters (T, B)
int32, solved (T, B) bool; float32 throughout. Any B is taken.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..types import TinyProblem
from . import _build
from .admm_fused import (GROUP, GROUP_MAX_THREADS, _check, _check_arg,
                         _prepare, _solve_plain, _table_slice,
                         _unpack_tables, _zero_carry, check_group_geometry,
                         group_geometry, group_saved, shift_carry)

KERNEL = "closed_loop_fused"
KERNEL_DIMS = ((12, 4),)             # (nx, nu) csrc/closed_loop_fused.cu
#                                      instantiates
# The one-thread-a-plant loop, csrc/closed_loop_thread.cu: the (nx, nu) it
# serves (it also instantiates (12, 4), which only the private pin of
# _closed_loop_fused reaches: the A/B of the two designs), and its block.
THREAD_KERNEL = "closed_loop_thread"
THREAD_LOOP_DIMS = ((6, 3), (4, 1), (2, 2), (2, 1), (3, 3), (1, 1))
THREAD_BLOCK = 32                    # threads (= plants) a block

# Launches of the CUDA kernels in this process, both kernels together and
# by source; chip_smoke.py resets and reads them to show that the serving
# path went through the kernel its pair takes.
launch_count = 0
launch_counts = {KERNEL: 0, THREAD_KERNEL: 0}


def _check_loop(prob: TinyProblem) -> None:
    """Raise ``ValueError`` for a problem the closed loop does not cover.
    It takes box constraints at fixed rho only, as the JAX closed loop does
    (closed_loop_pallas.py:326, :431): the other families, adaptive rho
    and consensus would otherwise be ignored in silence."""
    if prob.spec.any_extra_family or prob.settings.adaptive_rho \
            or prob.spec.en_consensus:
        raise ValueError("closed_loop_fused supports box-constraint specs "
                         "with fixed rho and no consensus, as the JAX fused "
                         "closed loop does (ROADMAP.md); use "
                         "tinympc_tpu_torch.closed_loop (or solve_fused_warm "
                         "in a host loop)")
    spec = prob.spec
    if (spec.nx, spec.nu) not in KERNEL_DIMS + THREAD_LOOP_DIMS:
        raise ValueError(f"(nx, nu) = ({spec.nx}, {spec.nu}) is not one of "
                         f"the closed-loop kernels' instantiations: "
                         f"{KERNEL_DIMS} on thread groups, "
                         f"{THREAD_LOOP_DIMS} on one thread a plant; other "
                         "sizes are not ported yet (ROADMAP.md, Queue 2 "
                         "item 1c); use tinympc_tpu_torch.closed_loop (or "
                         "solve_fused_warm in a host loop)")
    _check(prob)


def closed_loop_fused_supported(prob: TinyProblem) -> bool:
    """True if :func:`closed_loop_fused` handles this problem: box
    constraints only, fixed rho, ``matmul_precision="highest"``, no coarse
    schedule, tables that fit a block's shared memory, and an (nx, nu)
    pair a kernel is instantiated for: (12, 4) (thread groups), (6, 3),
    (4, 1), (2, 2), (2, 1), (3, 3) or (1, 1) (one thread a plant)."""
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
    params.pop("cons")
    return tables, xtot, x0, n_steps, params


def closed_loop_fused(prob: TinyProblem, Xref_total, x0s, n_steps: int,
                      Uref=None, *, reset_duals: bool = False,
                      shift_warm: bool = False):
    """Run ``n_steps`` receding-horizon MPC steps for a batch of plants in
    one launch of a fused closed-loop kernel: at (12, 4) the thread-group
    loop (csrc/closed_loop_fused.cu), at (6, 3), (4, 1), (2, 2), (2, 1),
    (3, 3) and (1, 1) the one-thread-a-plant loop
    (csrc/closed_loop_thread.cu).

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
    return _closed_loop_fused(prob, Xref_total, x0s, n_steps, Uref,
                              reset_duals=reset_duals, shift_warm=shift_warm)


def _closed_loop_fused(prob: TinyProblem, Xref_total, x0s, n_steps: int,
                       Uref=None, *, reset_duals: bool = False,
                       shift_warm: bool = False, thread: bool = False):
    """:func:`closed_loop_fused`; ``thread=True`` pins the one-thread loop,
    which then also runs (12, 4) (the A/B against the group loop)."""
    tables, xtot, x0, T, params = _prepare_loop(prob, Xref_total, x0s,
                                                n_steps, Uref)
    nx, nu = prob.spec.nx, prob.spec.nu
    args = (tables, xtot, x0, T, prob.spec.N, nx, nu)
    opts = dict(params, reset_duals=bool(reset_duals),
                shift_warm=bool(shift_warm))
    if x0.device.type == "cpu":
        return _loop_plain(*args, **opts)
    if x0.device.type == "cuda":
        thread = thread or (nx, nu) not in KERNEL_DIMS
        return (_loop_thread_kernel if thread else _loop_kernel)(*args,
                                                                 **opts)
    raise ValueError(f"closed_loop_fused runs on cuda or cpu, not "
                     f"{x0.device}")


def closed_loop_fused_reference(prob: TinyProblem, Xref_total, x0s,
                                n_steps: int, Uref=None, *,
                                reset_duals: bool = False,
                                shift_warm: bool = False):
    """The kernels' plain PyTorch version, on the problem's device: each
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


def _table_floats(N: int, T: int, nx: int = 12, nu: int = 4) -> int:
    """Floats a block copies into shared memory at ``PLACE_SHARED``: the
    packed table and the reference trajectory (T + N - 1 rows)."""
    return _table_slice("umax", nx, nu, N).stop + (T + N - 1) * nx


def loop_geometry(N: int, T: int, nx: int = 12, nu: int = 4):
    """The launch of csrc/closed_loop_fused.cu: ``(P, place, smem)``, as
    :func:`~.admm_fused.group_geometry` gives it for a kernel that keeps
    saved columns and copies the table and the reference."""
    return group_geometry(N, True, _table_floats(N, T, nx, nu), nx, nu)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The C entry point of csrc/closed_loop_fused.cu, built and loaded on
    first use, its block, group width and shared memory held against the
    wrapper's."""
    lib = _build.load(KERNEL)
    if (lib.tinympc_closed_loop_fused_max_threads() != GROUP_MAX_THREADS
            or lib.tinympc_closed_loop_fused_width() != GROUP):
        raise RuntimeError("csrc/closed_loop_fused.cu and the wrapper "
                           "disagree on the block size or the group")
    lib.tinympc_closed_loop_fused_smem.restype = ctypes.c_longlong
    check_group_geometry(
        lambda N, P, place, T: lib.tinympc_closed_loop_fused_smem(
            N, T, P, place), _table_floats, kinds=(1, 50, 1000))
    fn = lib.tinympc_closed_loop_fused_box
    # nx nu plants place N B T max_iter ct | rho tol_pri tol_dua | reset
    # shift | tables xref x0, 4 outputs, saved columns, the stream
    fn.argtypes = ([ctypes.c_int] * 9 + [ctypes.c_float] * 3
                   + [ctypes.c_int] * 2 + [_PTR] * 9)
    fn.restype = ctypes.c_int
    return fn


def _loop_kernel(tables, xtot, x0, T, N, nx, nu, *, max_iter, ct, rho,
                 tol_pri, tol_dua, reset_duals, shift_warm):
    """Launch csrc/closed_loop_fused.cu on the current stream of x0's
    device. Only the outputs are allocated: the plants' trajectories stay
    in shared memory (but the saved columns past N = 1117,
    :func:`~.admm_fused.group_saved`)."""
    global launch_count
    dev, B = x0.device, x0.shape[0]
    f32 = torch.float32
    _check_arg(x0, (B, nx), f32, dev)
    _check_arg(xtot, (T + N - 1, nx), f32, dev)
    _check_arg(tables, (_table_slice("umax", nx, nu, N).stop,), f32, dev)
    P, place, _ = loop_geometry(N, T, nx, nu)
    kw = dict(dtype=f32, device=dev)
    xs = torch.empty((T, B, nx), **kw)
    us = torch.empty((T, B, nu), **kw)
    iters = torch.empty((T, B), dtype=torch.int32, device=dev)
    solved = torch.empty((T, B), dtype=torch.bool, device=dev)
    saved = group_saved(x0, N, P, place, nx, nu)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(nx, nu, P, place, N, B, T, max_iter, ct, rho, tol_pri,
                 tol_dua, int(reset_duals), int(shift_warm),
                 tables.data_ptr(), xtot.data_ptr(), x0.data_ptr(),
                 xs.data_ptr(), us.data_ptr(), iters.data_ptr(),
                 solved.data_ptr(),
                 None if saved is None else saved.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"closed_loop_fused kernel launch failed: CUDA "
                           f"error {err}")
    launch_count += 1
    launch_counts[KERNEL] += 1
    return xs, us, iters, solved


@functools.lru_cache(maxsize=None)
def _thread_kernel_fn():
    """The C entry point of csrc/closed_loop_thread.cu, built and loaded on
    first use, its block and its pairs held against the wrapper's."""
    lib = _build.load(THREAD_KERNEL)
    if lib.tinympc_closed_loop_thread_block() != THREAD_BLOCK:
        raise RuntimeError("csrc/closed_loop_thread.cu and "
                           "closed_loop_kernel.THREAD_BLOCK disagree on the "
                           "block size")
    missing = [d for d in THREAD_LOOP_DIMS + KERNEL_DIMS
               if not lib.tinympc_closed_loop_thread_has(*d)]
    if missing:
        raise RuntimeError(f"csrc/closed_loop_thread.cu does not instantiate "
                           f"{missing}")
    fn = lib.tinympc_closed_loop_thread_box
    # nx nu N B T max_iter ct | rho tol_pri tol_dua | reset shift |
    # tables xref x0, 7 scratch arrays, 4 outputs, the stream
    fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.c_float] * 3
                   + [ctypes.c_int] * 2 + [_PTR] * 15)
    fn.restype = ctypes.c_int
    return fn


def _loop_thread_kernel(tables, xtot, x0, T, N, nx, nu, *, max_iter, ct, rho,
                        tol_pri, tol_dua, reset_duals, shift_warm):
    """Launch csrc/closed_loop_thread.cu on the current stream of x0's
    device. The outputs and the lane-last trajectories each plant keeps in
    device memory are allocated here; the kernel initialises the scratch it
    reads."""
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
    fn = _thread_kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(nx, nu, N, B, T, max_iter, ct, rho, tol_pri, tol_dua,
                 int(reset_duals), int(shift_warm), tables.data_ptr(),
                 xtot.data_ptr(), x0.data_ptr(),
                 *(a.data_ptr() for a in scratch), xs.data_ptr(),
                 us.data_ptr(), iters.data_ptr(), solved.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"closed_loop_thread kernel launch failed: CUDA "
                           f"error {err}")
    launch_count += 1
    launch_counts[THREAD_KERNEL] += 1
    return xs, us, iters, solved
