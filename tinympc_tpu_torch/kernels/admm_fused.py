"""Fused batched ADMM solve on the GPU (counterpart of
``tinympc_tpu.kernels.admm_pallas``).

:func:`solve_fused` runs the whole ADMM loop of a batch of box-constrained,
cold-started, fixed-rho problems in one launch of the hand-written CUDA
kernel ``csrc/admm_fused.cu``; :func:`solve_fused_warm` does the same from a
warm-start :class:`FusedCarry` and hands the next one back (the
external-plant receding-horizon pattern). The kernel replaces the TPU
kernel ``admm_pallas._make_kernel`` for those variants. On CPU tensors the
wrappers run the kernel's plain PyTorch versions,
:func:`solve_fused_reference` and :func:`solve_fused_warm_reference`,
instead; on CUDA tensors they launch the kernel or raise.

The public layout is the JAX package's: x0s is (B, nx), Xref (N, nx), Uref
(N-1, nu); the result is ``(Solution, residuals)`` with ``Solution.x`` (N, B,
nx), ``Solution.u`` (N-1, B, nu), ``iter`` (B,) int32, ``solved`` (B,) bool,
and residuals (4, B) in the row order pri_x, pri_u, dua_x, dua_u. The carry
keeps the JAX carry's lane-last layout. Everything runs in float32, as on
the TPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..types import Solution, TinyProblem, check_supported_settings, \
    check_supported_spec
from . import _build

KERNEL = "admm_fused"
BLOCK = 128                          # threads (= problems) per block
KERNEL_DIMS = ((12, 4),)            # (nx, nu) pairs csrc/ instantiates
F32_MAX = float(np.finfo(np.float32).max)

# Launches of the CUDA kernel in this process, cold and warm; chip_smoke.py
# resets and reads them to show that the main path went through the kernel.
launch_count = 0
warm_launch_count = 0


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


# ------------------------------------------------------------ warm carry

@dataclass(frozen=True)
class FusedCarry:
    """Warm-start carry of :func:`solve_fused_warm` (the box fields of
    ``tinympc_tpu.kernels.FusedCarry``), float32 in the kernel's lane-last
    layout: the reference's persistent workspace between solves -- final
    slacks ``vnew``/``znew``, duals ``g``/``y``, and the previous slacks
    ``v``/``z``, one iterate behind on a lane that converged (the reference
    skips the v <- vnew copy on the converging iteration,
    admm.cpp:444-446)."""

    vnew: torch.Tensor    # (N, nx, B)
    znew: torch.Tensor    # (N-1, nu, B)
    g: torch.Tensor       # (N, nx, B)
    y: torch.Tensor       # (N-1, nu, B)
    v: torch.Tensor       # (N, nx, B)
    z: torch.Tensor       # (N-1, nu, B)

    def replace(self, **kw) -> "FusedCarry":
        return dataclasses.replace(self, **kw)


CARRY_FIELDS = tuple(f.name for f in dataclasses.fields(FusedCarry))


def init_carry(prob: TinyProblem, B: int) -> FusedCarry:
    """Zero carry (cold start) for :func:`solve_fused_warm`, on the
    problem's device."""
    return _zero_carry(prob.spec.N, prob.spec.nx, prob.spec.nu, B,
                       prob.device)


def _zero_carry(N, nx, nu, B, device) -> FusedCarry:
    return FusedCarry(**{
        name: torch.zeros(shape, dtype=torch.float32, device=device)
        for name, shape in _carry_shapes(N, nx, nu, B).items()})


def shift_carry(carry: FusedCarry) -> FusedCarry:
    """Advance a warm carry one timestep for receding-horizon reuse (the
    classic MPC shift warm start): every field drops its first row and
    repeats the last, so the previous solve's tail seeds the overlapping
    window of the next horizon."""
    return carry.replace(**{
        name: torch.cat([a[1:], a[-1:]], dim=0)
        for name, a in ((n, getattr(carry, n)) for n in CARRY_FIELDS)})


def _carry_shapes(N, nx, nu, B) -> Dict[str, Tuple[int, int, int]]:
    return {name: (N, nx, B) if name in ("vnew", "g", "v") else
            (N - 1, nu, B) for name in CARRY_FIELDS}


def _carry_tensors(prob: TinyProblem, carry, B: int) -> FusedCarry:
    """``carry`` as float32 contiguous tensors on the problem's device,
    shape-checked against the problem and the batch."""
    if carry is None:
        raise ValueError("solve_fused_warm needs a carry; start from "
                         "init_carry(prob, B)")
    out = {}
    for name, shape in _carry_shapes(prob.spec.N, prob.spec.nx, prob.spec.nu,
                                     B).items():
        a = getattr(carry, name)
        if isinstance(a, torch.Tensor) and a.device != prob.device:
            raise ValueError(f"carry.{name} is on {a.device}, the problem on "
                             f"{prob.device}")
        t = torch.as_tensor(a, dtype=torch.float32,
                            device=prob.device).contiguous()
        if tuple(t.shape) != shape:
            raise ValueError(f"carry.{name} must be {shape}, got "
                             f"{tuple(t.shape)}; build the carry with "
                             "init_carry(prob, B)")
        out[name] = t
    return FusedCarry(**out)


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


def _table_slice(name: str, nx: int, nu: int, N: int) -> slice:
    """Where table ``name`` sits in the packed vector."""
    o = 0
    for key, shape in _table_layout(nx, nu, N):
        n = int(np.prod(shape))
        if key == name:
            return slice(o, o + n)
        o += n
    raise KeyError(name)


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
        return _solve_plain(tables, x0, spec.N, spec.nx, spec.nu,
                            **params)[:2]
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
    return _solve_plain(tables, x0, spec.N, spec.nx, spec.nu, **params)[:2]


def solve_fused_warm(prob: TinyProblem, Xref=None, Uref=None, x0s=None,
                     carry: Optional[FusedCarry] = None, *,
                     final: bool = False):
    """Warm-started batched solve: the receding-horizon pattern with an
    external plant (set x0, solve, apply u[0] to the real system, repeat),
    in one launch of the fused kernel.

    ``carry`` is the workspace of the previous solve (start from
    :func:`init_carry`). Returns ``(Solution, residuals (4, B), carry')``,
    with per-lane freeze at convergence, as a warm-started
    :func:`tinympc_tpu_torch.solve` sequence gives. ``final=True`` (every
    lane hands over its final iterate, the mode of lane compaction) is not
    ported yet and raises ``ValueError``, as does a missing carry. On CPU
    tensors it runs :func:`solve_fused_warm_reference`."""
    tables, x0, carry, params = _prepare_warm(prob, Xref, Uref, x0s, carry,
                                              final)
    spec = prob.spec
    if x0.device.type == "cpu":
        return _solve_plain(tables, x0, spec.N, spec.nx, spec.nu,
                            carry=carry, **params)[:3]
    if x0.device.type == "cuda":
        return _solve_kernel_warm(tables, x0, carry, spec.N, spec.nx,
                                  spec.nu, **params)
    raise ValueError(f"solve_fused_warm runs on cuda or cpu, not "
                     f"{x0.device}")


def solve_fused_warm_reference(prob: TinyProblem, Xref=None, Uref=None,
                               x0s=None, carry: Optional[FusedCarry] = None,
                               *, final: bool = False):
    """The warm kernel's plain PyTorch version, on the problem's device,
    with the kernel's load, freeze and carry-out rules. Returns what
    :func:`solve_fused_warm` returns."""
    tables, x0, carry, params = _prepare_warm(prob, Xref, Uref, x0s, carry,
                                              final)
    spec = prob.spec
    return _solve_plain(tables, x0, spec.N, spec.nx, spec.nu, carry=carry,
                        **params)[:3]


def _prepare_warm(prob, Xref, Uref, x0s, carry, final):
    if final:
        raise ValueError("solve_fused_warm(final=True), the lane-compaction "
                         "mode, is not ported yet")
    tables, x0, params = _prepare(prob, Xref, Uref, x0s)
    return tables, x0, _carry_tensors(prob, carry, x0.shape[0]), params


def _solve_plain(tables, x0, N, nx, nu, *, max_iter, ct, rho, tol_pri,
                 tol_dua, carry: Optional[FusedCarry] = None):
    """The fused solve in the kernel's lane-last layout: every per-lane
    array is (rows, features, B). Converged lanes freeze their iterates,
    and the loop ends on the first check iteration on which every lane is
    done. The kernel ends each block of lanes that way; since finished
    lanes are frozen, no lane's result depends on where the batch is cut
    into blocks, so the whole batch is one block here.

    Cold when ``carry`` is None; else warm, with the kernel's load and
    carry-out rules (admm_pallas.py:639-649, :1159-1164, :1273-1283).
    Returns ``(Solution, residuals, carry' or None, u0)``, where u0 (nu, B)
    is the raw forward-pass u[0] of each lane's last iteration (zero when
    max_iter is 0)."""
    t = _unpack_tables(tables, nx, nu, N)
    B = x0.shape[0]
    kw = dict(dtype=torch.float32, device=x0.device)
    col = lambda v: v[:, None]                      # (F,) -> (F, 1)

    vnew = torch.zeros((2, N, nx, B), **kw)         # ping-pong halves
    znew = torch.zeros((2, N - 1, nu, B), **kw)
    if carry is None:
        g = torch.zeros((N, nx, B), **kw)
        y = torch.zeros((N - 1, nu, B), **kw)
        dvgN = torch.zeros((nx, B), **kw)           # vnew[N-1] - g[N-1]
    else:
        # The carried slack goes into half 1, which iteration 0 reads as
        # "previous"; the carried v/z only feed iteration 0's dual residual.
        vnew[1], znew[1] = carry.vnew, carry.znew
        g, y = carry.g.clone(), carry.y.clone()
        dvgN = carry.vnew[N - 1] - carry.g[N - 1]
    done = torch.zeros(B, dtype=torch.bool, device=x0.device)
    iters = torch.zeros(B, dtype=torch.int32, device=x0.device)
    res = torch.zeros((4, B), **kw)
    u0 = torch.zeros((nu, B), **kw)

    negxq = -(t["Xref"] * t["Qd"])
    negur = -(t["Uref"] * t["Rd"])
    # -Pinf^T Xref[N-1], summed as admm.update_linear_cost sums it.
    pnref = -(t["Xref"][N - 1] @ t["PinfT"].T.contiguous())
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
            stale = carry is not None and it == 0
            vd = carry.v if stale else vnew[pv]
            zd = carry.z if stale else znew[pv]
            rows = torch.stack([
                torch.amax(torch.abs(xs - vn), dim=(0, 1)),
                torch.amax(torch.abs(us - zn), dim=(0, 1)),
                torch.amax(torch.abs(vd - vn), dim=(0, 1)) * rho,
                torch.amax(torch.abs(zd - zn), dim=(0, 1)) * rho])
        # 6. commit only for lanes still active (converged lanes freeze)
        vnew[cur] = torch.where(active, vn, vnew[cur])
        znew[cur] = torch.where(active, zn, znew[cur])
        g = torch.where(active, gn, g)
        y = torch.where(active, yn, y)
        dvgN = torch.where(active, vn[N - 1] - gn[N - 1], dvgN)
        u0 = torch.where(active, us[0], u0)
        iters = torch.where(active, it + 1, iters).to(torch.int32)
        if checking:
            res = torch.where(active, rows, res)
            ok = ((rows[0] < tol_pri) & (rows[1] < tol_pri)
                  & (rows[2] < tol_dua) & (rows[3] < tol_dua))
            done = done | (ok & active)
            if bool(done.all()):
                break

    # Each lane reports the half its last iteration wrote (half 1 -- zero,
    # or the carried slack -- when max_iter is 0).
    first = ((iters - 1) % 2) == 0
    vlast = torch.where(first, vnew[0], vnew[1])
    zlast = torch.where(first, znew[0], znew[1])
    sol = Solution(iter=iters, solved=done.clone(),
                   x=vlast.permute(0, 2, 1).contiguous(),
                   u=zlast.permute(0, 2, 1).contiguous())
    carry_out = None
    if carry is not None:
        # v/z out: the "previous" the converging iteration compared against
        # (the carried v/z if that was iteration 0, else the other half);
        # the last half for a lane that ran out of iterations.
        stale = done & (iters == 1)
        vprev = torch.where(stale, carry.v, torch.where(first, vnew[1],
                                                        vnew[0]))
        zprev = torch.where(stale, carry.z, torch.where(first, znew[1],
                                                        znew[0]))
        carry_out = FusedCarry(vnew=vlast, znew=zlast, g=g, y=y,
                               v=torch.where(done, vprev, vlast),
                               z=torch.where(done, zprev, zlast))
    return sol, res, carry_out, u0


# ------------------------------------------------------------ CUDA kernel

_PTR = ctypes.c_void_p


def _kernel_fns():
    """The cold and warm C entry points of csrc/admm_fused.cu, built and
    loaded on first use."""
    lib = _build.load(KERNEL)
    if lib.tinympc_admm_fused_block() != BLOCK:
        raise RuntimeError("csrc/admm_fused.cu and admm_fused.BLOCK disagree "
                           "on the block size")
    cold, warm = lib.tinympc_admm_fused_box_cold, lib.tinympc_admm_fused_box_warm
    # nx nu N B max_iter ct | rho tol_pri tol_dua | 12 buffers, the stream
    cold.argtypes = [ctypes.c_int] * 6 + [ctypes.c_float] * 3 + [_PTR] * 13
    # ... | 12 buffers, 10 carry buffers, the stream
    warm.argtypes = [ctypes.c_int] * 6 + [ctypes.c_float] * 3 + [_PTR] * 23
    cold.restype = warm.restype = ctypes.c_int
    return cold, warm


def _check_arg(t: torch.Tensor, shape, dtype, device) -> torch.Tensor:
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"kernel argument must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")
    return t


def _launch_buffers(tables, x0, N, nx, nu):
    """Check the shared inputs and allocate the outputs and scratch of one
    launch; the kernel initialises the scratch it reads."""
    dev = x0.device
    B = x0.shape[0]
    f32 = torch.float32
    _check_arg(x0, (B, nx), f32, dev)
    ntab = sum(int(np.prod(s)) for _, s in _table_layout(nx, nu, N))
    _check_arg(tables, (ntab,), f32, dev)
    kw = dict(dtype=f32, device=dev)
    return dict(
        vnew=torch.empty((2, N, nx, B), **kw),
        znew=torch.empty((2, N - 1, nu, B), **kw),
        g=torch.empty((N, nx, B), **kw), y=torch.empty((N - 1, nu, B), **kw),
        d=torch.empty((N - 1, nu, B), **kw),
        out_x=torch.empty((N, B, nx), **kw),
        out_u=torch.empty((N - 1, B, nu), **kw),
        iters=torch.empty(B, dtype=torch.int32, device=dev),
        solved=torch.empty(B, dtype=torch.bool, device=dev),
        res=torch.empty((4, B), **kw))


_BUFFER_ORDER = ("vnew", "znew", "g", "y", "d", "out_x", "out_u", "iters",
                 "solved", "res")


def _solve_kernel(tables, x0, N, nx, nu, *, max_iter, ct, rho, tol_pri,
                  tol_dua):
    """Launch the cold csrc/admm_fused.cu on the current stream of x0's
    device."""
    global launch_count
    buf = _launch_buffers(tables, x0, N, nx, nu)
    cold, _ = _kernel_fns()
    dev = x0.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = cold(nx, nu, N, x0.shape[0], max_iter, ct, rho, tol_pri,
                   tol_dua, tables.data_ptr(), x0.data_ptr(),
                   *(buf[k].data_ptr() for k in _BUFFER_ORDER), stream)
    if err != 0:
        raise RuntimeError(f"admm_fused kernel launch failed: CUDA error "
                           f"{err}")
    launch_count += 1
    return (Solution(iter=buf["iters"], solved=buf["solved"],
                     x=buf["out_x"], u=buf["out_u"]), buf["res"])


def _solve_kernel_warm(tables, x0, carry: FusedCarry, N, nx, nu, *,
                       max_iter, ct, rho, tol_pri, tol_dua):
    """Launch the warm csrc/admm_fused.cu on the current stream of x0's
    device. The new carry's g/y are the kernel's dual buffers."""
    global warm_launch_count
    buf = _launch_buffers(tables, x0, N, nx, nu)
    dev, B = x0.device, x0.shape[0]
    for name, shape in _carry_shapes(N, nx, nu, B).items():
        _check_arg(getattr(carry, name), shape, torch.float32, dev)
    out = dict(vnew=torch.empty_like(carry.vnew),
               znew=torch.empty_like(carry.znew),
               v=torch.empty_like(carry.v), z=torch.empty_like(carry.z))
    _, warm = _kernel_fns()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = warm(nx, nu, N, B, max_iter, ct, rho, tol_pri, tol_dua,
                   tables.data_ptr(), x0.data_ptr(),
                   *(buf[k].data_ptr() for k in _BUFFER_ORDER),
                   *(getattr(carry, k).data_ptr() for k in CARRY_FIELDS),
                   *(out[k].data_ptr() for k in ("vnew", "znew", "v", "z")),
                   stream)
    if err != 0:
        raise RuntimeError(f"admm_fused warm kernel launch failed: CUDA "
                           f"error {err}")
    warm_launch_count += 1
    sol = Solution(iter=buf["iters"], solved=buf["solved"], x=buf["out_x"],
                   u=buf["out_u"])
    return sol, buf["res"], FusedCarry(vnew=out["vnew"], znew=out["znew"],
                                       g=buf["g"], y=buf["y"], v=out["v"],
                                       z=out["z"])
