"""Fused batched ADMM solve on the GPU (counterpart of
``tinympc_tpu.kernels.admm_pallas``).

:func:`solve_fused` runs the whole ADMM loop of a batch of box-constrained,
cold-started, fixed-rho problems in one launch of the hand-written CUDA
kernel ``csrc/admm_fused.cu`` (it replaces the TPU kernel
``admm_pallas._make_kernel`` for that variant). On CPU tensors it runs the
kernel's plain PyTorch version, :func:`solve_fused_reference`, instead; on
CUDA tensors it launches the kernel or raises.

The public layout is the JAX package's: x0s is (B, nx), Xref (N, nx), Uref
(N-1, nu); the result is ``(Solution, residuals)`` with ``Solution.x`` (N, B,
nx), ``Solution.u`` (N-1, B, nu), ``iter`` (B,) int32, ``solved`` (B,) bool,
and residuals (4, B) in the row order pri_x, pri_u, dua_x, dua_u. Everything
runs in float32, as on the TPU.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from ..types import Solution, TinyProblem, check_supported_settings, \
    check_supported_spec
from . import _build

KERNEL = "admm_fused"
BLOCK = 128                          # threads (= problems) per block
KERNEL_DIMS = ((12, 4),)            # (nx, nu) pairs csrc/ instantiates
F32_MAX = float(np.finfo(np.float32).max)

# Launches of the CUDA kernel in this process; chip_smoke.py resets and
# reads it to show that the main path went through the kernel.
launch_count = 0


def _check(prob: TinyProblem) -> None:
    """Raise ``ValueError`` for a problem this slice does not cover."""
    check_supported_settings(prob.settings)
    check_supported_spec(prob.spec)
    spec = prob.spec
    if (spec.nx, spec.nu) not in KERNEL_DIMS:
        raise ValueError(f"(nx, nu) = ({spec.nx}, {spec.nu}) is not one of "
                         f"the kernel's instantiations {KERNEL_DIMS}")
    if spec.N < 2:
        raise ValueError("the fused solve needs a horizon N >= 2")
    if prob.cache.rho.ndim != 0:
        raise ValueError("the fused solve takes one shared rho")


def fused_supported(prob: TinyProblem) -> bool:
    """True if :func:`solve_fused` handles this problem: box constraints,
    fixed rho, ``matmul_precision="highest"``, no coarse schedule, and an
    (nx, nu) pair the kernel is instantiated for."""
    try:
        _check(prob)
    except ValueError:
        return False
    return True


# ------------------------------------------------------------ input tables

def _table_layout(nx: int, nu: int, N: int) -> Tuple[Tuple[str, tuple], ...]:
    """Names and shapes of the packed float32 table, in the order of
    ``Layout`` in csrc/admm_fused.cu."""
    return (("Mback", (nu + nx, nx)), ("Mfwd", (nu + nx, nx)),
            ("Quu", (nu, nu)), ("KinfT", (nx, nu)), ("Bm", (nx, nu)),
            ("APf", (nx,)), ("BPf", (nu,)), ("f", (nx,)), ("Qd", (nx,)),
            ("Rd", (nu,)), ("PinfT", (nx, nx)), ("Xref", (N, nx)),
            ("Uref", (N - 1, nu)), ("xmin", (N, nx)), ("xmax", (N, nx)),
            ("umin", (N - 1, nu)), ("umax", (N - 1, nu)))


def _pack_tables(prob: TinyProblem, Xref, Uref) -> torch.Tensor:
    """The kernel's shared inputs as one contiguous float32 vector on the
    problem's device. Bounds of a disabled family are +-FLT_MAX, and +-inf
    bounds are clamped to +-FLT_MAX: inf would poison the clamp arithmetic
    (admm_pallas.py:1534-1539)."""
    spec, c, cons = prob.spec, prob.cache, prob.cons
    N, nx, nu = spec.N, spec.nx, spec.nu
    kw = dict(dtype=torch.float32, device=prob.device)

    def f32(a, shape):
        t = torch.as_tensor(a, **kw)
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
        return t

    def bound(a, en, shape, sign):
        t = f32(a, shape) if en else torch.full(shape, sign * F32_MAX, **kw)
        return torch.clamp(t, -F32_MAX, F32_MAX)

    A, Bm = f32(prob.A, (nx, nx)), f32(prob.B, (nx, nu))
    Kinf = f32(c.Kinf, (nu, nx))
    parts = dict(
        Mback=torch.cat([Bm.T, f32(c.AmBKt, (nx, nx))]),
        Mfwd=torch.cat([Kinf, A]),
        Quu=f32(c.Quu_inv, (nu, nu)), KinfT=Kinf.T, Bm=Bm,
        APf=f32(c.APf, (nx,)), BPf=f32(c.BPf, (nu,)), f=f32(prob.f, (nx,)),
        Qd=f32(prob.Qdiag, (nx,)), Rd=f32(prob.Rdiag, (nu,)),
        PinfT=f32(c.Pinf, (nx, nx)).T,
        Xref=torch.zeros((N, nx), **kw) if Xref is None
        else f32(Xref, (N, nx)),
        Uref=torch.zeros((N - 1, nu), **kw) if Uref is None
        else f32(Uref, (N - 1, nu)),
        xmin=bound(cons.x_min, spec.en_state_bound, (N, nx), -1.0),
        xmax=bound(cons.x_max, spec.en_state_bound, (N, nx), 1.0),
        umin=bound(cons.u_min, spec.en_input_bound, (N - 1, nu), -1.0),
        umax=bound(cons.u_max, spec.en_input_bound, (N - 1, nu), 1.0),
    )
    return torch.cat([parts[name].reshape(-1)
                      for name, _ in _table_layout(nx, nu, N)])


def _unpack_tables(tables: torch.Tensor, nx: int, nu: int, N: int
                   ) -> Dict[str, torch.Tensor]:
    out, o = {}, 0
    for name, shape in _table_layout(nx, nu, N):
        n = int(np.prod(shape))
        out[name] = tables[o:o + n].reshape(shape)
        o += n
    return out


def _prepare(prob: TinyProblem, Xref, Uref, x0s):
    _check(prob)
    if x0s is None:
        raise ValueError("solve_fused needs x0s, shape (B, nx)")
    if isinstance(x0s, torch.Tensor) and x0s.device != prob.device:
        raise ValueError(f"x0s is on {x0s.device}, the problem on "
                         f"{prob.device}")
    x0 = torch.as_tensor(x0s, dtype=torch.float32,
                         device=prob.device).contiguous()
    if x0.ndim != 2 or x0.shape[1] != prob.spec.nx or x0.shape[0] < 1:
        raise ValueError(f"x0s must be (B, {prob.spec.nx}) with B >= 1, "
                         f"got {tuple(x0.shape)}")
    st = prob.settings
    params = dict(max_iter=int(st.max_iter), ct=int(st.check_termination),
                  rho=float(np.float32(float(prob.cache.rho))),
                  tol_pri=float(np.float32(st.abs_pri_tol)),
                  tol_dua=float(np.float32(st.abs_dua_tol)))
    return _pack_tables(prob, Xref, Uref), x0, params


# ------------------------------------------------------------ entry points

def solve_fused(prob: TinyProblem, Xref=None, Uref=None, x0s=None):
    """Batched cold-start box-constrained solve at fixed rho, in one launch
    of the fused kernel. Returns ``(Solution, residuals (4, B))``.

    Raises ``ValueError`` for a problem outside :func:`fused_supported`.
    On CPU tensors it runs :func:`solve_fused_reference`."""
    tables, x0, params = _prepare(prob, Xref, Uref, x0s)
    spec = prob.spec
    if x0.device.type == "cpu":
        return _solve_plain(tables, x0, spec.N, spec.nx, spec.nu, **params)
    if x0.device.type == "cuda":
        return _solve_kernel(tables, x0, spec.N, spec.nx, spec.nu, **params)
    raise ValueError(f"solve_fused runs on cuda or cpu, not {x0.device}")


def solve_fused_reference(prob: TinyProblem, Xref=None, Uref=None, x0s=None):
    """The kernel's plain PyTorch version, on the problem's device: the
    same inputs, layout, ping-pong, termination stride, freeze and exit
    rules as ``csrc/admm_fused.cu``, so that a mismatch points into the
    kernel. Returns what :func:`solve_fused` returns."""
    tables, x0, params = _prepare(prob, Xref, Uref, x0s)
    spec = prob.spec
    return _solve_plain(tables, x0, spec.N, spec.nx, spec.nu, **params)


def _solve_plain(tables, x0, N, nx, nu, *, max_iter, ct, rho, tol_pri,
                 tol_dua):
    """The fused solve in the kernel's lane-last layout: every per-lane
    array is (rows, features, B). Converged lanes freeze their iterates,
    and the loop ends on the first check iteration on which every lane is
    done. The kernel ends each block of lanes that way; since finished
    lanes are frozen, no lane's result depends on where the batch is cut
    into blocks, so the whole batch is one block here."""
    t = _unpack_tables(tables, nx, nu, N)
    B = x0.shape[0]
    kw = dict(dtype=torch.float32, device=x0.device)
    col = lambda v: v[:, None]                      # (F,) -> (F, 1)

    vnew = torch.zeros((2, N, nx, B), **kw)         # ping-pong halves
    znew = torch.zeros((2, N - 1, nu, B), **kw)
    g = torch.zeros((N, nx, B), **kw)
    y = torch.zeros((N - 1, nu, B), **kw)
    dvgN = torch.zeros((nx, B), **kw)               # vnew[N-1] - g[N-1]
    done = torch.zeros(B, dtype=torch.bool, device=x0.device)
    iters = torch.zeros(B, dtype=torch.int32, device=x0.device)
    res = torch.zeros((4, B), **kw)

    negxq = -(t["Xref"] * t["Qd"])
    negur = -(t["Uref"] * t["Rd"])
    pnref = -(t["PinfT"] @ t["Xref"][N - 1])
    xmin, xmax = t["xmin"][:, :, None], t["xmax"][:, :, None]
    umin, umax = t["umin"][:, :, None], t["umax"][:, :, None]
    x0T = x0.T

    for it in range(max_iter):
        active = ~done
        cur, pv = it % 2, 1 - it % 2
        # 1+2. linear cost fused into the backward sweep
        p = col(pnref) - rho * dvgN
        d = [None] * (N - 1)
        for i in range(N - 2, -1, -1):
            r = col(negur[i]) - rho * (znew[pv, i] - y[i])
            q = col(negxq[i]) - rho * (vnew[pv, i] - g[i])
            out = t["Mback"] @ p
            d[i] = t["Quu"] @ (out[:nu] + r + col(t["BPf"]))
            p = q + out[nu:] - t["KinfT"] @ r + col(t["APf"])
        # 3. forward rollout
        x = x0T
        xs, us = [x], []
        for i in range(N - 1):
            out = t["Mfwd"] @ x
            u = -out[:nu] - d[i]
            x = out[nu:] + t["Bm"] @ u + col(t["f"])
            xs.append(x)
            us.append(u)
        xs, us = torch.stack(xs), torch.stack(us)
        # 4+5. box projection and dual update, from the pre-update duals
        vn = torch.minimum(xmax, torch.maximum(xmin, xs + g))
        zn = torch.minimum(umax, torch.maximum(umin, us + y))
        gn = g + xs - vn
        yn = y + us - zn
        checking = (it + 1) % ct == 0
        if checking:
            rows = torch.stack([
                torch.amax(torch.abs(xs - vn), dim=(0, 1)),
                torch.amax(torch.abs(us - zn), dim=(0, 1)),
                torch.amax(torch.abs(vnew[pv] - vn), dim=(0, 1)) * rho,
                torch.amax(torch.abs(znew[pv] - zn), dim=(0, 1)) * rho])
        # 6. commit only for lanes still active (converged lanes freeze)
        vnew[cur] = torch.where(active, vn, vnew[cur])
        znew[cur] = torch.where(active, zn, znew[cur])
        g = torch.where(active, gn, g)
        y = torch.where(active, yn, y)
        dvgN = torch.where(active, vn[N - 1] - gn[N - 1], dvgN)
        iters = torch.where(active, it + 1, iters).to(torch.int32)
        if checking:
            res = torch.where(active, rows, res)
            ok = ((rows[0] < tol_pri) & (rows[1] < tol_pri)
                  & (rows[2] < tol_dua) & (rows[3] < tol_dua))
            done = done | (ok & active)
            if bool(done.all()):
                break

    # Each lane reports the half its last iteration wrote (half 1, zero,
    # when max_iter is 0).
    first = ((iters - 1) % 2) == 0
    x_out = torch.where(first, vnew[0], vnew[1]).permute(0, 2, 1)
    u_out = torch.where(first, znew[0], znew[1]).permute(0, 2, 1)
    sol = Solution(iter=iters, solved=done.clone(),
                   x=x_out.contiguous(), u=u_out.contiguous())
    return sol, res


# ------------------------------------------------------------ CUDA kernel

_PTR = ctypes.c_void_p


def _kernel_fn():
    lib = _build.load(KERNEL)
    if lib.tinympc_admm_fused_block() != BLOCK:
        raise RuntimeError("csrc/admm_fused.cu and admm_fused.BLOCK disagree "
                           "on the block size")
    fn = lib.tinympc_admm_fused_box_cold
    # nx nu N B max_iter ct | rho tol_pri tol_dua | 12 buffers, the stream
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_float] * 3 + [_PTR] * 13
    fn.restype = ctypes.c_int
    return fn


def _check_arg(t: torch.Tensor, shape, dtype, device) -> torch.Tensor:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"kernel argument must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")
    return t


def _solve_kernel(tables, x0, N, nx, nu, *, max_iter, ct, rho, tol_pri,
                  tol_dua):
    """Launch csrc/admm_fused.cu on the current stream of x0's device.
    Outputs and scratch are allocated here; the kernel zeroes the scratch
    it reads before writing it."""
    global launch_count
    dev = x0.device
    B = x0.shape[0]
    f32 = torch.float32
    _check_arg(x0, (B, nx), f32, dev)
    ntab = sum(int(np.prod(s)) for _, s in _table_layout(nx, nu, N))
    _check_arg(tables, (ntab,), f32, dev)
    kw = dict(dtype=f32, device=dev)
    vnew = torch.empty((2, N, nx, B), **kw)
    znew = torch.empty((2, N - 1, nu, B), **kw)
    g = torch.empty((N, nx, B), **kw)
    y = torch.empty((N - 1, nu, B), **kw)
    d = torch.empty((N - 1, nu, B), **kw)
    out_x = torch.empty((N, B, nx), **kw)
    out_u = torch.empty((N - 1, B, nu), **kw)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    solved = torch.empty(B, dtype=torch.bool, device=dev)
    res = torch.empty((4, B), **kw)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(nx, nu, N, B, max_iter, ct, rho, tol_pri, tol_dua,
                 tables.data_ptr(), x0.data_ptr(), vnew.data_ptr(),
                 znew.data_ptr(), g.data_ptr(), y.data_ptr(), d.data_ptr(),
                 out_x.data_ptr(), out_u.data_ptr(), iters.data_ptr(),
                 solved.data_ptr(), res.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"admm_fused kernel launch failed: CUDA error "
                           f"{err}")
    launch_count += 1
    return Solution(iter=iters, solved=solved, x=out_x, u=out_u), res
