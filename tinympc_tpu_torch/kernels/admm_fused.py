"""Fused batched ADMM solve on the GPU (counterpart of
``tinympc_tpu.kernels.admm_pallas``).

:func:`solve_fused` runs the whole ADMM loop of a batch of cold-started,
fixed-rho problems in one launch of the hand-written CUDA kernel
``csrc/admm_fused.cu``; :func:`solve_fused_warm` does the same from a
warm-start :class:`FusedCarry` and hands the next one back (the
external-plant receding-horizon pattern). The kernel replaces the TPU
kernel ``admm_pallas._make_kernel`` for those variants. Box bounds run on
its box-only instantiation; problems with second-order cones, hyperplanes
or time-varying hyperplanes run on its families instantiation; box
problems with adaptive rho (``Settings.adaptive_rho``) run on its adaptive
instantiation, which carries one rho per lane and adapts it in the kernel.
The instantiated (nx, nu) pairs are :data:`KERNEL_DIMS` (box only),
:data:`FAMILY_KERNEL_DIMS` and :data:`ADAPTIVE_KERNEL_DIMS`. On CPU tensors
the wrappers run the kernel's plain PyTorch versions,
:func:`solve_fused_reference` and :func:`solve_fused_warm_reference`,
instead; on CUDA tensors they launch the kernel or raise.

The public layout is the JAX package's: x0s is (B, nx), Xref (N, nx), Uref
(N-1, nu); the result is ``(Solution, residuals)`` with ``Solution.x`` (N, B,
nx), ``Solution.u`` (N-1, B, nu), ``iter`` (B,) int32, ``solved`` (B,) bool,
and residuals (4, B) in the row order pri_x, pri_u, dua_x, dua_u; with
adaptive rho a 5th row holds each lane's final rho (:func:`adapted_cache`
builds the per-problem cache from it). The carry keeps the JAX carry's
lane-last layout. Everything runs in float32, as on the TPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..admm import apply_cones, apply_hyperplanes, tv_rows
from ..projections import sum_last
from ..rho_adapt import RHO_EPS, taylor_update
from ..types import (ADAPTIVE_RHO_PERIOD, Cache, Solution, TinyProblem,
                     check_supported_settings, check_supported_spec)
from . import _build

KERNEL = "admm_fused"
BLOCK = 128                          # threads (= problems) per block
KERNEL_DIMS = ((12, 4),)             # (nx, nu) of the box-only kernel
FAMILY_KERNEL_DIMS = ((12, 4), (6, 3))   # (nx, nu) of the families kernel
ADAPTIVE_KERNEL_DIMS = ((12, 4),)    # (nx, nu) of the adaptive-rho kernel
F32_MAX = float(np.finfo(np.float32).max)

# Launches of the CUDA kernel in this process: box-only cold and warm, with
# the other families cold and warm, and with adaptive rho cold and warm.
# chip_smoke.py resets and reads them to show that each path went through
# its kernel.
launch_count = 0
warm_launch_count = 0
families_launch_count = 0
families_warm_launch_count = 0
adaptive_launch_count = 0
adaptive_warm_launch_count = 0


class Adaptive(NamedTuple):
    """Adaptive-rho parameters of a fused solve, as the kernel takes them
    (``Settings.adaptive_rho_*``; bounds and tolerance as float32)."""

    apply_c: bool
    clip: bool
    rho_min: float
    rho_max: float
    rho_tol: float


def _adaptive(settings) -> Optional[Adaptive]:
    """The adaptive-rho parameters of ``settings``, None at fixed rho."""
    if not settings.adaptive_rho:
        return None
    f32 = lambda v: float(np.float32(v))
    return Adaptive(bool(settings.adaptive_rho_apply_c),
                    bool(settings.adaptive_rho_clip),
                    f32(settings.adaptive_rho_min),
                    f32(settings.adaptive_rho_max),
                    f32(settings.adaptive_rho_tolerance))


class Families(NamedTuple):
    """Sizes of the constraint families beyond the box that are on: state
    and input cones, state and input hyperplanes, state and input
    time-varying hyperplanes. All zero for a box-only problem."""

    ncx: int = 0
    ncu: int = 0
    nlx: int = 0
    nlu: int = 0
    ntx: int = 0
    ntu: int = 0


NO_FAMILIES = Families()


def _families(spec) -> Families:
    return Families(len(spec.enabled_state_cones),
                    len(spec.enabled_input_cones), spec.n_state_lin,
                    spec.n_input_lin, spec.n_tv_state_lin,
                    spec.n_tv_input_lin)


def _family_data(prob: TinyProblem):
    """(name, tensor, shape) of each table a family that is on needs."""
    spec, c, fam = prob.spec, prob.cons, _families(prob.spec)
    N, nx, nu = spec.N, spec.nx, spec.nu
    need = []
    if fam.ncx:
        need.append(("cx", c.cx, (fam.ncx,)))
    if fam.ncu:
        need.append(("cu", c.cu, (fam.ncu,)))
    if fam.nlx:
        need += [("Alin_x", c.Alin_x, (fam.nlx, nx)),
                 ("blin_x", c.blin_x, (fam.nlx,))]
    if fam.nlu:
        need += [("Alin_u", c.Alin_u, (fam.nlu, nu)),
                 ("blin_u", c.blin_u, (fam.nlu,))]
    if fam.ntx:
        need += [("tv_Alin_x", c.tv_Alin_x, (N, fam.ntx, nx)),
                 ("tv_blin_x", c.tv_blin_x, (N, fam.ntx))]
    if fam.ntu:
        need += [("tv_Alin_u", c.tv_Alin_u, (N - 1, fam.ntu, nu)),
                 ("tv_blin_u", c.tv_blin_u, (N - 1, fam.ntu))]
    return need


def _check(prob: TinyProblem) -> None:
    """Raise ``ValueError`` for a problem the fused kernel does not
    cover."""
    check_supported_settings(prob.settings)
    check_supported_spec(prob.spec, prob.settings)
    spec = prob.spec
    if prob.settings.adaptive_rho:
        if prob.cache.dKinf_drho is None:
            raise ValueError("adaptive rho needs the rho sensitivities; "
                             "attach them with api.with_sensitivities(prob)")
        if spec.any_extra_family or (spec.nx, spec.nu) not in \
                ADAPTIVE_KERNEL_DIMS:
            raise ValueError(
                "the fused adaptive-rho kernel takes box constraints at "
                f"(nx, nu) in {ADAPTIVE_KERNEL_DIMS}; adaptive rho with the "
                "other constraint families or other sizes is not ported yet "
                "(ROADMAP.md, Queue 2 item 4); use tinympc_tpu_torch.solve")
    dims = FAMILY_KERNEL_DIMS if spec.any_extra_family else KERNEL_DIMS
    if (spec.nx, spec.nu) not in dims:
        raise ValueError(f"(nx, nu) = ({spec.nx}, {spec.nu}) is not one of "
                         f"the kernel's instantiations {dims}")
    if spec.N < 2:
        raise ValueError("the fused solve needs a horizon N >= 2")
    if prob.cache.rho.ndim != 0:
        raise ValueError("the fused solve takes one shared rho")
    for cones, F in ((spec.enabled_state_cones, spec.nx),
                     (spec.enabled_input_cones, spec.nu)):
        for start, dim in cones:
            if start < 0 or dim < 1 or start + dim > F:
                raise ValueError(f"cone (start={start}, dim={dim}) does not "
                                 f"fit in {F} features")
    for name, a, shape in _family_data(prob):
        if a is None or tuple(a.shape) != shape:
            got = None if a is None else tuple(a.shape)
            raise ValueError(f"cons.{name} must be {shape} for the enabled "
                             f"families, got {got}")


def fused_supported(prob: TinyProblem) -> bool:
    """True if :func:`solve_fused` handles this problem: box, SOC,
    hyperplane and time-varying hyperplane constraints at fixed rho, or
    box constraints with adaptive rho and its sensitivities attached;
    ``matmul_precision="highest"``, no coarse schedule, and an (nx, nu)
    pair the kernel is instantiated for."""
    try:
        _check(prob)
    except ValueError:
        return False
    return True


# ------------------------------------------------------------ warm carry

@dataclass(frozen=True)
class FusedCarry:
    """Warm-start carry of :func:`solve_fused_warm` (the fields of
    ``tinympc_tpu.kernels.FusedCarry`` but the consensus ones), float32 in
    the kernel's lane-last layout: the reference's
    persistent workspace between solves -- final slacks ``vnew``/``znew``,
    duals ``g``/``y``, and the previous slacks ``v``/``z``, one iterate
    behind on a lane that converged (the reference skips the v <- vnew copy
    on the converging iteration, admm.cpp:444-446). A problem with other
    families also carries their duals and the primal ``x``/``u``, whose
    rows seed the family slacks of the next solve (admm.cpp:352-376); the
    fields of families that are off are None. An adaptive-rho problem
    carries each lane's rho, which persists across solves as the
    reference's cache->rho does."""

    vnew: torch.Tensor    # (N, nx, B)
    znew: torch.Tensor    # (N-1, nu, B)
    g: torch.Tensor       # (N, nx, B)
    y: torch.Tensor       # (N-1, nu, B)
    v: torch.Tensor       # (N, nx, B)
    z: torch.Tensor       # (N-1, nu, B)
    gc: Optional[torch.Tensor] = None    # (N, nx, B)   state-SOC dual
    yc: Optional[torch.Tensor] = None    # (N-1, nu, B) input-SOC dual
    gl: Optional[torch.Tensor] = None
    yl: Optional[torch.Tensor] = None
    gtv: Optional[torch.Tensor] = None
    ytv: Optional[torch.Tensor] = None
    x: Optional[torch.Tensor] = None     # (N, nx, B)
    u: Optional[torch.Tensor] = None     # (N-1, nu, B)
    rho: Optional[torch.Tensor] = None   # (1, B)

    def replace(self, **kw) -> "FusedCarry":
        return dataclasses.replace(self, **kw)


CARRY_FIELDS = tuple(f.name for f in dataclasses.fields(FusedCarry))
BOX_CARRY_FIELDS = CARRY_FIELDS[:6]
_STATE_FIELDS = ("vnew", "g", "v", "gc", "gl", "gtv", "x")


def init_carry(prob: TinyProblem, B: int) -> FusedCarry:
    """Zero carry (cold start) for :func:`solve_fused_warm`, on the
    problem's device, with the fields of the problem's families; with
    adaptive rho, every lane's rho starts at the problem's."""
    spec = prob.spec
    carry = _zero_carry(spec.N, spec.nx, spec.nu, B, prob.device,
                        _families(spec))
    if prob.settings.adaptive_rho:
        carry = carry.replace(rho=torch.full(
            (1, B), float(prob.cache.rho), dtype=torch.float32,
            device=prob.device))
    return carry


def _zero_carry(N, nx, nu, B, device, fam=NO_FAMILIES) -> FusedCarry:
    return FusedCarry(**{
        name: torch.zeros(shape, dtype=torch.float32, device=device)
        for name, shape in _carry_shapes(N, nx, nu, B, fam).items()})


def shift_carry(carry: FusedCarry) -> FusedCarry:
    """Advance a warm carry one timestep for receding-horizon reuse (the
    classic MPC shift warm start): every time-indexed field drops its first
    row and repeats the last, so the previous solve's tail seeds the
    overlapping window of the next horizon. The per-lane rho passes
    through."""
    return carry.replace(**{
        name: torch.cat([a[1:], a[-1:]], dim=0)
        for name, a in ((n, getattr(carry, n)) for n in CARRY_FIELDS
                        if n != "rho")
        if a is not None})


def _carry_shapes(N, nx, nu, B, fam=NO_FAMILIES, adaptive=False
                  ) -> Dict[str, Tuple[int, ...]]:
    """Shape of each carry field the problem needs (admm_pallas.py:227-247):
    the box fields, each family's dual, x/u when any family is on, and the
    per-lane rho under adaptive rho."""
    on = {name: True for name in BOX_CARRY_FIELDS}
    on.update(gc=fam.ncx > 0, yc=fam.ncu > 0, gl=fam.nlx > 0, yl=fam.nlu > 0,
              gtv=fam.ntx > 0, ytv=fam.ntu > 0, x=any(fam), u=any(fam),
              rho=adaptive)
    shape = lambda name: ((1, B) if name == "rho" else (N, nx, B)
                          if name in _STATE_FIELDS else (N - 1, nu, B))
    return {name: shape(name) for name in CARRY_FIELDS if on[name]}


def _carry_tensors(prob: TinyProblem, carry, B: int) -> FusedCarry:
    """``carry`` as float32 contiguous tensors on the problem's device,
    checked against the problem's families, its shapes and the batch."""
    if carry is None:
        raise ValueError("solve_fused_warm needs a carry; start from "
                         "init_carry(prob, B)")
    spec = prob.spec
    shapes = _carry_shapes(spec.N, spec.nx, spec.nu, B, _families(spec),
                           prob.settings.adaptive_rho)
    bad = [k for k in CARRY_FIELDS
           if (k in shapes) != (getattr(carry, k) is not None)]
    if bad:
        raise ValueError(f"carry fields {bad} do not match this problem's "
                         "enabled constraint families or its rho setting; "
                         "build the carry with init_carry(prob, B) for the "
                         "same problem")
    out = {}
    for name, shape in shapes.items():
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

def _table_layout(nx: int, nu: int, N: int, fam: Families = NO_FAMILIES,
                  adapt: Optional[Adaptive] = None
                  ) -> Tuple[Tuple[str, tuple], ...]:
    """Names and shapes of the packed float32 table, in the order of
    ``Layout`` (csrc/admm_sweep.cuh), then ``FamilyLayout``
    (csrc/admm_families.cuh), then ``AdaptiveLayout``
    (csrc/admm_adaptive.cuh). The family and adaptive tables come after the
    box tables and are empty for a box-only fixed-rho problem, so its table
    is the box table alone. Cones are rows (start, dim, mu); each
    hyperplane table is A, b and ||a||^2 of each row (``asq``). Adaptive
    rho adds A^T, Pinf and the sensitivities dKinf, dKinf^T, dPinf,
    dPinf^T, and dC1, dC2 under ``apply_c`` (admm_pallas.py:1550-1560)."""
    ax, au = (nx, nu) if adapt is not None else (0, 0)
    cx, cu = (nx, nu) if adapt is not None and adapt.apply_c else (0, 0)
    return (("Mback", (nu + nx, nx)), ("Mfwd", (nu + nx, nx)),
            ("Quu", (nu, nu)), ("KinfT", (nx, nu)), ("Bm", (nx, nu)),
            ("APf", (nx,)), ("BPf", (nu,)), ("f", (nx,)), ("Qd", (nx,)),
            ("Rd", (nu,)), ("PinfT", (nx, nx)), ("Xref", (N, nx)),
            ("Uref", (N - 1, nu)), ("xmin", (N, nx)), ("xmax", (N, nx)),
            ("umin", (N - 1, nu)), ("umax", (N - 1, nu)),
            ("xcones", (fam.ncx, 3)), ("ucones", (fam.ncu, 3)),
            ("Alin_x", (fam.nlx, nx)), ("blin_x", (fam.nlx,)),
            ("asq_x", (fam.nlx,)),
            ("Alin_u", (fam.nlu, nu)), ("blin_u", (fam.nlu,)),
            ("asq_u", (fam.nlu,)),
            ("tv_Alin_x", (N, fam.ntx, nx)), ("tv_blin_x", (N, fam.ntx)),
            ("tv_asq_x", (N, fam.ntx)),
            ("tv_Alin_u", (N - 1, fam.ntu, nu)),
            ("tv_blin_u", (N - 1, fam.ntu)), ("tv_asq_u", (N - 1, fam.ntu)),
            ("AT", (ax, nx)), ("Pinf", (ax, nx)), ("dK", (au, nx)),
            ("dKT", (ax, nu)), ("dP", (ax, nx)), ("dPT", (ax, nx)),
            ("dC1", (cu, nu)), ("dC2", (cx, nx)))


def _pack_tables(prob: TinyProblem, Xref, Uref) -> torch.Tensor:
    """The kernel's shared inputs as one contiguous float32 vector on the
    problem's device. Bounds of a disabled family are +-FLT_MAX, and +-inf
    bounds are clamped to +-FLT_MAX: inf would poison the clamp arithmetic
    (admm_pallas.py:1534-1539). Each hyperplane's ||a||^2 is summed here,
    once, in feature order from zero, as the projection would sum it."""
    spec, c, cons = prob.spec, prob.cache, prob.cons
    N, nx, nu = spec.N, spec.nx, spec.nu
    fam, adapt = _families(spec), _adaptive(prob.settings)
    kw = dict(dtype=torch.float32, device=prob.device)

    def f32(a, shape):
        t = torch.as_tensor(a, **kw)
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
        return t

    def bound(a, en, shape, sign):
        t = f32(a, shape) if en else torch.full(shape, sign * F32_MAX, **kw)
        return torch.clamp(t, -F32_MAX, F32_MAX)

    def cones(geometry, mus):
        if not geometry:
            return torch.zeros((0, 3), **kw)
        rows = torch.tensor(geometry, **kw)
        return torch.cat([rows, f32(mus, (len(geometry),))[:, None]], dim=1)

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
        xcones=cones(spec.enabled_state_cones, cons.cx),
        ucones=cones(spec.enabled_input_cones, cons.cu),
    )
    for name, a, shape in _family_data(prob):
        if name not in ("cx", "cu"):
            parts[name] = f32(a, shape)
        if name.startswith(("Alin", "tv_Alin")):
            parts[name.replace("Alin", "asq")] = sum_last(parts[name]
                                                           * parts[name])
    if adapt is not None:
        dK = f32(c.dKinf_drho, (nu, nx))
        dP = f32(c.dPinf_drho, (nx, nx))
        parts.update(AT=A.T, Pinf=f32(c.Pinf, (nx, nx)), dK=dK, dKT=dK.T,
                     dP=dP, dPT=dP.T)
        if adapt.apply_c:
            parts.update(dC1=f32(c.dC1_drho, (nu, nu)),
                         dC2=f32(c.dC2_drho, (nx, nx)))
    layout = _table_layout(nx, nu, N, fam, adapt)
    return torch.cat([parts[name].reshape(-1) if name in parts
                      else torch.zeros(0, **kw) for name, _ in layout])


def _table_slice(name: str, nx: int, nu: int, N: int) -> slice:
    """Where box table ``name`` sits in the packed vector."""
    o = 0
    for key, shape in _table_layout(nx, nu, N):
        n = int(np.prod(shape))
        if key == name:
            return slice(o, o + n)
        o += n
    raise KeyError(name)


def _unpack_tables(tables: torch.Tensor, nx: int, nu: int, N: int,
                   fam: Families = NO_FAMILIES,
                   adapt: Optional[Adaptive] = None
                   ) -> Dict[str, torch.Tensor]:
    out, o = {}, 0
    for name, shape in _table_layout(nx, nu, N, fam, adapt):
        n = int(np.prod(shape))
        out[name] = tables[o:o + n].reshape(shape)
        o += n
    return out


def _prepare(prob: TinyProblem, Xref, Uref, x0s):
    """Check the problem and x0s; return the packed tables, x0 and the
    solver parameters, the problem's family sizes ``fam`` among them."""
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
                  tol_dua=float(np.float32(st.abs_dua_tol)),
                  fam=_families(prob.spec), adapt=_adaptive(st))
    return _pack_tables(prob, Xref, Uref), x0, params


# ------------------------------------------------------------ entry points

def solve_fused(prob: TinyProblem, Xref=None, Uref=None, x0s=None):
    """Batched cold-start solve, in one launch of the fused kernel. Returns
    ``(Solution, residuals (4, B))``; with adaptive rho the residuals are
    (5, B), the last row each lane's final rho.

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
    :func:`init_carry`); its fields must match the problem's families.
    Returns ``(Solution, residuals (4, B), carry')``, with per-lane freeze
    at convergence, as a warm-started :func:`tinympc_tpu_torch.solve`
    sequence gives; with adaptive rho each lane's rho rides the carry, and
    the residuals gain the final rho as a 5th row. ``final=True`` (every
    lane hands over its final iterate, the mode of lane compaction) is not
    ported yet and raises ``ValueError``, as does a missing or mismatched
    carry. On CPU tensors it runs :func:`solve_fused_warm_reference`."""
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


class _Family:
    """One constraint family beyond the box in the plain version: its
    projection of a (rows, F, B) candidate and its slack, dual and carry
    name."""

    def __init__(self, project, slack, dual, name):
        self.project, self.slack, self.dual, self.name = (project, slack,
                                                          dual, name)


def _lanes(fn, *args):
    """``fn`` (which works on the last axis) applied to the feature axis of
    a lane-last (rows, F, B) candidate."""
    return lambda c: fn(c.transpose(1, 2), *args).transpose(1, 2)


def _plain_families(t, fam: Families, x_seed, u_seed, carry):
    """The state-side and input-side families of the plain version, in the
    kernel's order (SOC, hyperplane, time-varying hyperplane), with their
    seeded slacks and their duals (zero, or from the carry)."""
    def dual(name, like):
        return torch.zeros_like(like) if carry is None \
            else getattr(carry, name).clone()

    def cones(table):
        geometry = [(int(s), int(d)) for s, d in table[:, :2].tolist()]
        return _lanes(apply_cones, geometry, table[:, 2])

    def planes(A, b, asq):
        return _lanes(apply_hyperplanes, list(zip(A, b, asq)))

    def tv_planes(A, b, asq, count):
        rows = tv_rows(A, b, count, 1)
        return _lanes(apply_hyperplanes, [(a, bk, asq[:, k, None])
                                          for k, (a, bk) in enumerate(rows)])

    xs, us = [], []
    for on, proj, name in ((fam.ncx, lambda: cones(t["xcones"]), "gc"),
                           (fam.nlx, lambda: planes(
                               t["Alin_x"], t["blin_x"], t["asq_x"]), "gl"),
                           (fam.ntx, lambda: tv_planes(
                               t["tv_Alin_x"], t["tv_blin_x"], t["tv_asq_x"],
                               fam.ntx), "gtv")):
        if on:
            xs.append(_Family(proj(), x_seed.clone(), dual(name, x_seed),
                              name))
    for on, proj, name in ((fam.ncu, lambda: cones(t["ucones"]), "yc"),
                           (fam.nlu, lambda: planes(
                               t["Alin_u"], t["blin_u"], t["asq_u"]), "yl"),
                           (fam.ntu, lambda: tv_planes(
                               t["tv_Alin_u"], t["tv_blin_u"], t["tv_asq_u"],
                               fam.ntu), "ytv")):
        if on:
            us.append(_Family(proj(), u_seed.clone(), dual(name, u_seed),
                              name))
    return xs, us


def _solve_plain(tables, x0, N, nx, nu, *, max_iter, ct, rho, tol_pri,
                 tol_dua, carry: Optional[FusedCarry] = None,
                 fam: Families = NO_FAMILIES,
                 adapt: Optional[Adaptive] = None):
    """The fused solve in the kernel's lane-last layout: every per-lane
    array is (rows, features, B). Converged lanes freeze their iterates,
    and the loop ends on the first check iteration on which every lane is
    done. The kernel ends each block of lanes that way; since finished
    lanes are frozen, no lane's result depends on where the batch is cut
    into blocks, so the whole batch is one block here.

    Cold when ``carry`` is None; else warm, with the kernel's load and
    carry-out rules (admm_pallas.py:639-649, :1159-1164, :1273-1283). The
    families of ``fam`` start from the kernel's seeds (admm_pallas.py:
    670-692), add their terms to the linear cost after the box's, and
    project from the duals before their update; termination reads the box
    residuals only. With ``adapt`` each lane carries its own rho (from the
    carry when warm, else ``rho``, the problem's), and every matrix the
    Taylor update moves acts as the base product plus ``drho`` times its
    sensitivity product, with drho = rho_lane - rho (admm_pallas.py:
    861-920); see :func:`_adapt_plain` for the adaptation. Returns
    ``(Solution, residuals, carry' or None, u0)``, where u0 (nu, B) is the
    raw forward-pass u[0] of each lane's last iteration (zero when
    max_iter is 0) and residuals gain the final rho as a 5th row under
    ``adapt``."""
    t = _unpack_tables(tables, nx, nu, N, fam, adapt)
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
    x0T = x0.T

    # Family seeds: the state side from x0 in row 0 and zeros or the
    # carried x after it, the input side from zeros or the carried u. The
    # carried x/u start there too and then follow each active iteration.
    x_rest = torch.zeros((N - 1, nx, B), **kw) if carry is None \
        or carry.x is None else carry.x[1:]
    xcar = torch.cat([x0T[None], x_rest])
    ucar = torch.zeros((N - 1, nu, B), **kw) if carry is None \
        or carry.u is None else carry.u.clone()
    xfams, ufams = _plain_families(t, fam, xcar, ucar, carry)

    negxq = -(t["Xref"] * t["Qd"])
    negur = -(t["Uref"] * t["Rd"])
    # -Pinf^T Xref[N-1], summed as admm.update_linear_cost sums it.
    pnref = -(t["Xref"][N - 1] @ t["PinfT"].T.contiguous())
    xmin, xmax = t["xmin"][:, :, None], t["xmax"][:, :, None]
    umin, umax = t["umin"][:, :, None], t["umax"][:, :, None]
    if adapt is not None:
        # Each lane's rho (the carry's, or the problem's), the guard's
        # virtual rho restarting from it every solve (admm_pallas.py:
        # 665-669), and the sensitivity of the terminal reference term,
        # -dPinf^T Xref[N-1] (:832-837).
        lane_rho = torch.full((B,), rho, **kw) if carry is None \
            else carry.rho[0].clone()
        lane_rho_v = lane_rho.clone()
        pnref_dP = -(t["Xref"][N - 1] @ t["dPT"].T.contiguous())

    for it in range(max_iter):
        active = ~done
        cur, pv = it % 2, 1 - it % 2
        if adapt is None:
            rho_b, dr = rho, None
            p = col(pnref)
        else:
            rho_b, dr = lane_rho, lane_rho - rho
            p = col(pnref) + dr * col(pnref_dP)
        # 1+2. linear cost fused into the backward sweep
        p = p - rho_b * dvgN
        for f in xfams:
            p = p - rho_b * (f.slack[N - 1] - f.dual[N - 1])
        d = [None] * (N - 1)
        for i in range(N - 2, -1, -1):
            r = col(negur[i]) - rho_b * (znew[pv, i] - y[i])
            for f in ufams:
                r = r - rho_b * (f.slack[i] - f.dual[i])
            q = col(negxq[i]) - rho_b * (vnew[pv, i] - g[i])
            for f in xfams:
                q = q - rho_b * (f.slack[i] - f.dual[i])
            out = t["Mback"] @ p
            bp, ap = out[:nu], out[nu:]
            w = bp + r + col(t["BPf"])
            d[i] = t["Quu"] @ w
            kr = t["KinfT"] @ r
            if adapt is not None:
                kr = kr + dr * (t["dKT"] @ r)
                if adapt.apply_c:
                    ap = ap + dr * (t["dC2"] @ p)
                    d[i] = d[i] + dr * (t["dC1"] @ w)
            p = q + ap - kr + col(t["APf"])
        # 3. forward rollout; s = A x + B u, whose difference from the next
        # state is the OSQP dynamics row of adaptive rho
        x = x0T
        xs, us, axd = [x], [], []
        for i in range(N - 1):
            out = t["Mfwd"] @ x
            kx = out[:nu]
            if adapt is not None:
                kx = kx + dr * (t["dK"] @ x)
            u = -kx - d[i]
            s = out[nu:] + t["Bm"] @ u
            x = s + col(t["f"])
            xs.append(x)
            us.append(u)
            if adapt is not None:
                axd.append(s - x)
        xs, us = torch.stack(xs), torch.stack(us)
        # 4+5. projections and dual updates, from the pre-update duals
        vn = torch.minimum(xmax, torch.maximum(xmin, xs + g))
        zn = torch.minimum(umax, torch.maximum(umin, us + y))
        gn = g + xs - vn
        yn = y + us - zn
        for fams, prim in ((xfams, xs), (ufams, us)):
            for f in fams:
                sn = f.project(prim + f.dual)
                dn = f.dual + prim - sn
                f.slack = torch.where(active, sn, f.slack)
                f.dual = torch.where(active, dn, f.dual)
        # 5.5. adaptive rho every ADAPTIVE_RHO_PERIOD iterations, on the
        # active lanes (admm_pallas.py:1079-1142)
        if adapt is not None and it > 0 and it % ADAPTIVE_RHO_PERIOD == 0:
            lane_rho, lane_rho_v = _adapt_plain(
                t, adapt, xs, us, torch.stack(axd), vn, zn, gn, yn, dr,
                lane_rho, lane_rho_v, active)
            rho_b = lane_rho
        checking = (it + 1) % ct == 0
        if checking:
            stale = carry is not None and it == 0
            vd = carry.v if stale else vnew[pv]
            zd = carry.z if stale else znew[pv]
            # Dual rows scale with the rho after adaptation.
            rows = torch.stack([
                torch.amax(torch.abs(xs - vn), dim=(0, 1)),
                torch.amax(torch.abs(us - zn), dim=(0, 1)),
                torch.amax(torch.abs(vd - vn), dim=(0, 1)) * rho_b,
                torch.amax(torch.abs(zd - zn), dim=(0, 1)) * rho_b])
        # 6. commit only for lanes still active (converged lanes freeze)
        vnew[cur] = torch.where(active, vn, vnew[cur])
        znew[cur] = torch.where(active, zn, znew[cur])
        g = torch.where(active, gn, g)
        y = torch.where(active, yn, y)
        dvgN = torch.where(active, vn[N - 1] - gn[N - 1], dvgN)
        xcar = torch.where(active, xs, xcar)
        ucar = torch.where(active, us, ucar)
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
    if adapt is not None:
        # Converged lanes froze their rho: this is each problem's final
        # rho, as in the final cache of admm.solve.
        res = torch.cat([res, lane_rho[None]])
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
        extra = {f.name: f.dual for f in xfams + ufams}
        if any(fam):
            extra.update(x=xcar, u=ucar)
        if adapt is not None:
            extra.update(rho=lane_rho[None].clone())
        carry_out = FusedCarry(vnew=vlast, znew=zlast, g=g, y=y,
                               v=torch.where(done, vprev, vlast),
                               z=torch.where(done, zprev, zlast), **extra)
    return sol, res, carry_out, u0


def _adapt_plain(t, adapt: Adaptive, xs, us, axd, vn, zn, gn, yn, dr,
                 rho, rho_v, active):
    """One rho adaptation of the plain version (admm_pallas.py:1086-1142):
    the OSQP residuals of rho_adapt.osqp_residuals in the lane-last layout,
    with the terminal Pinf telescoped by ``dr * dPinf`` and the dynamics
    rows ``axd`` = (A x_i + B u_i) - x_{i+1} taken from the rollout's own
    products (exactly 0 when f = 0); then the prediction and, with
    ``rho_tol > 1``, the guard. Returns the new (rho, virtual rho) rows,
    moved on the active lanes only."""
    N, nu = xs.shape[0], us.shape[1]
    mab = lambda a: torch.amax(torch.abs(a), dim=(0, 1))
    qd, rd = t["Qd"][:, None], t["Rd"][:, None]
    pri_res = torch.maximum(mab(us - zn), mab(axd - vn[1:]))
    pri_norm = torch.maximum(torch.maximum(mab(us), mab(axd)),
                             torch.maximum(mab(zn), mab(vn[1:])))
    pxN = t["Pinf"] @ xs[N - 1] + dr * (t["dP"] @ xs[N - 1])
    px_state = torch.cat([qd * xs[:-1], pxN[None]])
    q_state = qd * xs
    ru_us = rd * us                       # the input rows of P x and of q
    zero = torch.zeros_like(xs[:1])
    aty_state = torch.cat([t["AT"] @ gn[1:], zero]) - torch.cat([zero,
                                                                 gn[1:]])
    aty_input = yn + t["Mback"][:nu] @ gn[1:]          # + B^T g[i+1]
    dual_res = torch.maximum(mab(px_state + q_state + aty_state),
                             mab(2.0 * ru_us + aty_input))
    dual_norm = torch.maximum(
        torch.maximum(torch.maximum(mab(px_state), mab(ru_us)),
                      torch.maximum(mab(aty_state), mab(aty_input))),
        torch.maximum(mab(q_state), mab(ru_us)))
    ratio = (pri_res / (pri_norm + RHO_EPS)) / (
        dual_res / (dual_norm + RHO_EPS) + RHO_EPS)
    factor = torch.sqrt(ratio)
    clip = (lambda v: torch.clamp(v, adapt.rho_min, adapt.rho_max)) \
        if adapt.clip else (lambda v: v)
    if adapt.rho_tol > 1.0:
        new_v = clip(rho_v * factor)
        commit = (new_v >= adapt.rho_tol * rho) | (new_v * adapt.rho_tol
                                                    <= rho)
        return (torch.where(active & commit, new_v, rho),
                torch.where(active, new_v, rho_v))
    return torch.where(active, clip(rho * factor), rho), rho_v


def adapted_cache(prob: TinyProblem, rho_final) -> Cache:
    """The per-problem cache of an adaptive fused solve from its final rho
    row (the 5th residual row, (B,) or (1, B)): the telescoped Taylor
    update ``M_b = M + (rho_b - rho) * dM/drho`` of admm_pallas.py:
    1821-1845, the fused counterpart of the final cache that
    :func:`tinympc_tpu_torch.solve` returns. Leaves carry a leading batch
    axis."""
    rho_b = torch.as_tensor(rho_final, dtype=prob.dtype,
                            device=prob.device).reshape(-1)
    return taylor_update(prob.cache, rho_b, prob.settings)


# ------------------------------------------------------------ CUDA kernel

_PTR = ctypes.c_void_p
_PTRS = ctypes.POINTER(ctypes.c_void_p)


class _AdaptArgs(ctypes.Structure):
    """``AdaptArgs`` of csrc/admm_adaptive.cuh: the adaptive-rho settings,
    the carried rho in (null on a cold solve), the final rho out, and the
    kernel's scratch for the rows of an adaptation iteration."""

    _fields_ = [("apply_c", ctypes.c_int), ("clip", ctypes.c_int),
                ("rho_min", ctypes.c_float), ("rho_max", ctypes.c_float),
                ("rho_tol", ctypes.c_float), ("rho_in", _PTR),
                ("rho_out", _PTR), ("xs", _PTR), ("us", _PTR),
                ("axd", _PTR)]


def _kernel_fn():
    """The C entry point of csrc/admm_fused.cu, built and loaded on first
    use."""
    lib = _build.load(KERNEL)
    if lib.tinympc_admm_fused_block() != BLOCK:
        raise RuntimeError("csrc/admm_fused.cu and admm_fused.BLOCK disagree "
                           "on the block size")
    fn = lib.tinympc_admm_fused
    # warm nx nu N B max_iter ct | counts | rho tol_pri tol_dua |
    # 12 buffers | carry array, family array | adaptive-rho arguments |
    # the stream
    fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
                   + [ctypes.c_float] * 3 + [_PTR] * 12 + [_PTRS] * 2
                   + [ctypes.POINTER(_AdaptArgs), _PTR])
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


def _launch_buffers(tables, x0, N, nx, nu, fam=NO_FAMILIES, adapt=None):
    """Check the shared inputs and allocate the outputs and scratch of one
    launch; the kernel initialises the scratch it reads. Adaptive rho adds
    a 5th residual row (the final rho) and the scratch of the rows of an
    adaptation iteration: x, u and the dynamics rows."""
    dev = x0.device
    B = x0.shape[0]
    f32 = torch.float32
    _check_arg(x0, (B, nx), f32, dev)
    ntab = sum(int(np.prod(s)) for _, s in _table_layout(nx, nu, N, fam,
                                                          adapt))
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
        res=torch.empty((4 if adapt is None else 5, B), **kw))


_BUFFER_ORDER = ("vnew", "znew", "g", "y", "d", "out_x", "out_u", "iters",
                 "solved", "res")
# The carry field of each family's dual, in the order of Families and of
# the kernel's family array.
_FAMILY_DUALS = ("gc", "yc", "gl", "yl", "gtv", "ytv")


def _ptr_array(tensors):
    """A host array of device pointers, null for None."""
    return (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))


def _launch(tables, x0, N, nx, nu, fam, adapt, carry, max_iter, ct, rho,
            tol_pri, tol_dua):
    """Launch csrc/admm_fused.cu on the current stream of x0's device: cold
    when ``carry`` is None, else warm; the box-only kernel when ``fam`` is
    all zero and ``adapt`` None, the families kernel for other families,
    the adaptive-rho kernel under ``adapt``. Returns the outputs and
    scratch, and the new carry of a warm solve (its duals are the kernel's
    dual buffers)."""
    dev, B = x0.device, x0.shape[0]
    kw = dict(dtype=torch.float32, device=dev)
    buf = _launch_buffers(tables, x0, N, nx, nu, fam, adapt)
    shapes = _carry_shapes(N, nx, nu, B, fam, adapt is not None)
    work, duals = [], {}
    for dual, n in zip(_FAMILY_DUALS, fam):
        if n:            # the family's working slack, then its dual
            duals[dual] = torch.empty(shapes[dual], **kw)
            work += [torch.empty(shapes[dual], **kw), duals[dual]]
        else:
            work += [None, None]
    if carry is None:
        carry_ptrs, fam_ptrs = [None] * 10, work + [None] * 10
    else:
        for name, shape in shapes.items():
            _check_arg(getattr(carry, name), shape, torch.float32, dev)
        out = {k: torch.empty_like(getattr(carry, k))
               for k in ("vnew", "znew", "v", "z") + (("x", "u") if any(fam)
                                                      else ())}
        carry_ptrs = [getattr(carry, k) for k in BOX_CARRY_FIELDS] + [
            out[k] for k in ("vnew", "znew", "v", "z")]
        fam_ptrs = work + [getattr(carry, k) for k in _FAMILY_DUALS
                           + ("x", "u")] + [out.get("x"), out.get("u")]
    adapt_args = None
    if adapt is not None:
        scratch = [torch.empty(shape, **kw) for shape in (
            (N, nx, B), (N - 1, nu, B), (N - 1, nx, B))]
        adapt_args = ctypes.byref(_AdaptArgs(
            int(adapt.apply_c), int(adapt.clip), adapt.rho_min,
            adapt.rho_max, adapt.rho_tol,
            None if carry is None else carry.rho.data_ptr(),
            buf["res"][4].data_ptr(), *(a.data_ptr() for a in scratch)))
    fn = _kernel_fn()
    counts = (ctypes.c_int * 6)(*fam)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(int(carry is not None), nx, nu, N, B, max_iter, ct, counts,
                 rho, tol_pri, tol_dua, tables.data_ptr(), x0.data_ptr(),
                 *(buf[k].data_ptr() for k in _BUFFER_ORDER),
                 _ptr_array(carry_ptrs), _ptr_array(fam_ptrs), adapt_args,
                 stream)
    if err != 0:
        raise RuntimeError(f"admm_fused kernel launch failed: CUDA error "
                           f"{err}")
    sol = Solution(iter=buf["iters"], solved=buf["solved"], x=buf["out_x"],
                   u=buf["out_u"])
    if carry is None:
        return sol, buf["res"], None
    if adapt is not None:
        out["rho"] = buf["res"][4:5].clone()
    return sol, buf["res"], FusedCarry(g=buf["g"], y=buf["y"], **out,
                                       **duals)


def _solve_kernel(tables, x0, N, nx, nu, *, max_iter, ct, rho, tol_pri,
                  tol_dua, fam=NO_FAMILIES, adapt=None):
    """The cold solve on the kernel: box-only, families or adaptive-rho
    instantiation."""
    global launch_count, families_launch_count, adaptive_launch_count
    sol, res, _ = _launch(tables, x0, N, nx, nu, fam, adapt, None,
                          max_iter, ct, rho, tol_pri, tol_dua)
    if adapt is not None:
        adaptive_launch_count += 1
    elif any(fam):
        families_launch_count += 1
    else:
        launch_count += 1
    return sol, res


def _solve_kernel_warm(tables, x0, carry: FusedCarry, N, nx, nu, *,
                       max_iter, ct, rho, tol_pri, tol_dua,
                       fam=NO_FAMILIES, adapt=None):
    """The warm solve on the kernel: box-only, families or adaptive-rho
    instantiation."""
    global warm_launch_count, families_warm_launch_count, \
        adaptive_warm_launch_count
    out = _launch(tables, x0, N, nx, nu, fam, adapt, carry, max_iter, ct,
                  rho, tol_pri, tol_dua)
    if adapt is not None:
        adaptive_warm_launch_count += 1
    elif any(fam):
        families_warm_launch_count += 1
    else:
        warm_launch_count += 1
    return out
