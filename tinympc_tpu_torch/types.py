"""Core data model of the PyTorch port (counterpart of ``tinympc_tpu.types``).

Problems carry a frozen :class:`ProblemSpec` (shapes and which constraint
families exist) and frozen :class:`Settings`; every numeric array is a
``torch.Tensor`` held by a plain dataclass. Functions return new dataclasses
instead of mutating, so a problem can be shared between solves.

Array layout convention (the same as the JAX package, so tests compare like
with like)::

    x      : (N,   *b, nx)      state trajectory
    u      : (N-1, *b, nu)      input trajectory
    scalars: (*b,)              per-problem status / residuals

``*b`` is an arbitrary (possibly empty) batch shape. Cache matrices are
unbatched: one system per problem.

``Settings.matmul_precision`` on an NVIDIA H100: ``"highest"`` means float32
fused multiply-add on the CUDA cores with TF32 off. ``"high"`` and
``"default"`` (the TPU's multi-pass and single-pass bf16 schemes) and
``coarse_iters > 0`` (a bf16 iteration schedule) have no meaning in this
port yet; the solvers reject them with ``ValueError`` (see
:func:`check_supported_settings`).

Adaptive rho keeps the cache's base matrices and their rho sensitivities
(``Cache.d*_drho``); a solve returns the per-problem cache of its final
rho, whose leaves carry the batch axes in front.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# Status codes (reference types.hpp has no enum; values from admm.cpp:336,431)
TINY_UNSOLVED = 11
TINY_SOLVED = 1

# Iterations between two rho adaptations (admm.cpp:405).
ADAPTIVE_RHO_PERIOD = 5


@dataclass(frozen=True)
class ProblemSpec:
    """Static problem structure: dimensions and the enabled constraint
    families (every field of ``tinympc_tpu.types.ProblemSpec``)."""

    nx: int
    nu: int
    N: int
    en_state_bound: bool = True
    en_input_bound: bool = True
    en_state_soc: bool = False
    en_input_soc: bool = False
    en_state_linear: bool = False
    en_input_linear: bool = False
    en_tv_state_linear: bool = False
    en_tv_input_linear: bool = False
    en_consensus: bool = False
    state_cones: Tuple[Tuple[int, int], ...] = ()
    input_cones: Tuple[Tuple[int, int], ...] = ()
    num_state_linear: int = 0
    num_input_linear: int = 0
    num_tv_state_linear: int = 0
    num_tv_input_linear: int = 0

    # The families that are on, resolved from the enable flags (the JAX
    # spec's views, used by the fused kernel and its checks).
    @property
    def enabled_state_cones(self) -> Tuple[Tuple[int, int], ...]:
        return self.state_cones if (self.en_state_soc and self.state_cones) \
            else ()

    @property
    def enabled_input_cones(self) -> Tuple[Tuple[int, int], ...]:
        return self.input_cones if (self.en_input_soc and self.input_cones) \
            else ()

    @property
    def n_state_lin(self) -> int:
        return self.num_state_linear if self.en_state_linear else 0

    @property
    def n_input_lin(self) -> int:
        return self.num_input_linear if self.en_input_linear else 0

    @property
    def n_tv_state_lin(self) -> int:
        return self.num_tv_state_linear if self.en_tv_state_linear else 0

    @property
    def n_tv_input_lin(self) -> int:
        return self.num_tv_input_linear if self.en_tv_input_linear else 0

    @property
    def any_extra_family(self) -> bool:
        """Any constraint family beyond the box bounds is enabled."""
        return bool(self.enabled_state_cones or self.enabled_input_cones
                    or self.n_state_lin or self.n_input_lin
                    or self.n_tv_state_lin or self.n_tv_input_lin)


@dataclass(frozen=True)
class Settings:
    """Solver settings: every field of ``tinympc_tpu.types.Settings`` with
    the same defaults, so settings round-trip between the packages."""

    abs_pri_tol: float = 1e-3
    abs_dua_tol: float = 1e-3
    max_iter: int = 1000
    check_termination: int = 1
    adaptive_rho: bool = False
    adaptive_rho_min: float = 1.0
    adaptive_rho_max: float = 100.0
    adaptive_rho_clip: bool = True
    adaptive_rho_tolerance: float = 1.0
    horizon_parallel: bool = False
    consensus_axis_name: Optional[str] = None
    consensus_rho: Optional[float] = None
    adaptive_rho_apply_c: bool = False
    matmul_precision: str = "highest"
    coarse_iters: int = 0


def check_supported_settings(settings: Settings) -> None:
    """Raise ``ValueError`` for settings the port does not implement."""
    if settings.matmul_precision != "highest":
        raise ValueError(
            f"matmul_precision={settings.matmul_precision!r} is not supported "
            "on the GPU port: only 'highest' (float32 FMA, TF32 off) is")
    if settings.coarse_iters:
        raise ValueError(
            "coarse_iters (a bf16 iteration schedule) is not supported on "
            "the GPU port; set coarse_iters=0")
    if settings.horizon_parallel:
        if settings.adaptive_rho:
            raise ValueError(
                "horizon_parallel requires an unbatched cache and is not "
                "compatible with adaptive_rho (which makes the cache "
                "per-problem); pick one")
        raise ValueError("horizon-parallel sweeps are not ported yet")
    if settings.check_termination < 1:
        raise ValueError("check_termination must be >= 1")


def check_supported_spec(spec: ProblemSpec,
                         settings: Optional[Settings] = None) -> None:
    """Raise ``ValueError`` for constraint families the port does not
    implement: box, SOC, hyperplane and time-varying hyperplane families
    are ported; consensus is not, and never goes with adaptive rho (the
    Taylor update does not track the consensus step-0 gains)."""
    if spec.en_consensus:
        if settings is not None and settings.adaptive_rho:
            raise ValueError("consensus is not compatible with adaptive_rho "
                             "(the Taylor cache update does not track the "
                             "consensus step-0 gains); pick one")
        raise ValueError("the consensus family is not ported yet")


@dataclass(frozen=True)
class Cache:
    """Infinite-horizon Riccati cache (reference types.hpp:43-59).
    ``C1``/``C2`` are the reference's aliases of ``Quu_inv``/``AmBKt``,
    which the adaptive-rho Taylor update writes. The sensitivities
    d{Kinf, Pinf, C1, C2}/drho are None unless adaptive rho is set up. The
    final cache of an adaptive solve is per problem: ``rho`` (*b,) and the
    matrices (*b, rows, cols)."""

    rho: torch.Tensor        # () or (*b,)
    Kinf: torch.Tensor       # (nu, nx) or (*b, nu, nx)
    Pinf: torch.Tensor       # (nx, nx)
    Quu_inv: torch.Tensor    # (nu, nu)
    AmBKt: torch.Tensor      # (nx, nx)
    APf: torch.Tensor        # (nx,)
    BPf: torch.Tensor        # (nu,)
    C1: Optional[torch.Tensor] = None
    C2: Optional[torch.Tensor] = None
    dKinf_drho: Optional[torch.Tensor] = None   # (nu, nx)
    dPinf_drho: Optional[torch.Tensor] = None   # (nx, nx)
    dC1_drho: Optional[torch.Tensor] = None     # (nu, nu)
    dC2_drho: Optional[torch.Tensor] = None     # (nx, nx)


@dataclass(frozen=True)
class ConstraintData:
    """Numeric constraint data: box bounds per timestep like the reference
    (types.hpp:117-120), cone coefficients, and hyperplanes a.x <= b.
    ``tv_Alin_x`` uses the natural (N, S, nx) layout rather than the
    reference's stacked ((S*N) x nx) rows (types.hpp:170-173)."""

    x_min: Optional[torch.Tensor] = None   # (N, nx)
    x_max: Optional[torch.Tensor] = None
    u_min: Optional[torch.Tensor] = None   # (N-1, nu)
    u_max: Optional[torch.Tensor] = None
    cx: Optional[torch.Tensor] = None      # (num_state_cones,) cone mu
    cu: Optional[torch.Tensor] = None
    Alin_x: Optional[torch.Tensor] = None  # (Sx, nx)
    blin_x: Optional[torch.Tensor] = None  # (Sx,)
    Alin_u: Optional[torch.Tensor] = None  # (Su, nu)
    blin_u: Optional[torch.Tensor] = None
    tv_Alin_x: Optional[torch.Tensor] = None  # (N, Sx, nx)
    tv_blin_x: Optional[torch.Tensor] = None  # (N, Sx)
    tv_Alin_u: Optional[torch.Tensor] = None  # (N-1, Su, nu)
    tv_blin_u: Optional[torch.Tensor] = None  # (N-1, Su)


@dataclass(frozen=True)
class TinyProblem:
    """A configured problem: dynamics, rho-augmented cost, cache, bounds."""

    A: torch.Tensor       # (nx, nx)
    B: torch.Tensor       # (nx, nu)
    f: torch.Tensor       # (nx,)
    Qdiag: torch.Tensor   # (nx,)  Q + rho (tiny_api.cpp:117)
    Rdiag: torch.Tensor   # (nu,)  R + rho
    cache: Cache
    cons: ConstraintData
    spec: ProblemSpec
    settings: Settings

    @property
    def dtype(self) -> torch.dtype:
        return self.A.dtype

    @property
    def device(self) -> torch.device:
        return self.A.device

    def replace(self, **kw) -> "TinyProblem":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SolverState:
    """Per-problem iterates and status (the reference ``TinyWorkspace``
    iterate fields, types.hpp:94-114, and the per-family slack/dual pairs).
    A family's fields are ``None`` when the family is off."""

    x: torch.Tensor        # (N,   *b, nx)
    u: torch.Tensor        # (N-1, *b, nu)
    q: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    d: torch.Tensor
    v: torch.Tensor
    vnew: torch.Tensor
    z: torch.Tensor
    znew: torch.Tensor
    g: torch.Tensor
    y: torch.Tensor
    iter: torch.Tensor     # (*b,) int32
    solved: torch.Tensor   # (*b,) bool
    status: torch.Tensor   # (*b,) int32
    pri_res_state: torch.Tensor
    pri_res_input: torch.Tensor
    dua_res_state: torch.Tensor
    dua_res_input: torch.Tensor
    # SOC family (new slack and dual)
    vcnew: Optional[torch.Tensor] = None
    gc: Optional[torch.Tensor] = None
    zcnew: Optional[torch.Tensor] = None
    yc: Optional[torch.Tensor] = None
    # Hyperplane family
    vlnew: Optional[torch.Tensor] = None
    gl: Optional[torch.Tensor] = None
    zlnew: Optional[torch.Tensor] = None
    yl: Optional[torch.Tensor] = None
    # Time-varying hyperplane family
    vlnew_tv: Optional[torch.Tensor] = None
    gl_tv: Optional[torch.Tensor] = None
    zlnew_tv: Optional[torch.Tensor] = None
    yl_tv: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "SolverState":
        return dataclasses.replace(self, **kw)

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.iter.shape)


@dataclass(frozen=True)
class Solution:
    """Solver output: the projected slacks vnew/znew (admm.cpp:436-437)."""

    iter: torch.Tensor    # (*b,) int32
    solved: torch.Tensor  # (*b,) bool
    x: torch.Tensor       # (N,   *b, nx)
    u: torch.Tensor       # (N-1, *b, nu)


def init_state(spec: ProblemSpec, batch_shape: Tuple[int, ...] = (),
               dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cpu") -> SolverState:
    """Zero-initialised solver state (reference tiny_setup,
    tiny_api.cpp:68-133)."""
    b = tuple(batch_shape)
    N, nx, nu = spec.N, spec.nx, spec.nu

    def zx():
        return torch.zeros((N, *b, nx), dtype=dtype, device=device)

    def zu():
        return torch.zeros((N - 1, *b, nu), dtype=dtype, device=device)

    def zb(dt=None):
        return torch.zeros(b, dtype=dt or dtype, device=device)

    fam = {}
    if spec.en_state_soc and len(spec.state_cones) > 0:
        fam.update(vcnew=zx(), gc=zx())
    if spec.en_input_soc and len(spec.input_cones) > 0:
        fam.update(zcnew=zu(), yc=zu())
    if spec.en_state_linear:
        fam.update(vlnew=zx(), gl=zx())
    if spec.en_input_linear:
        fam.update(zlnew=zu(), yl=zu())
    if spec.en_tv_state_linear:
        fam.update(vlnew_tv=zx(), gl_tv=zx())
    if spec.en_tv_input_linear:
        fam.update(zlnew_tv=zu(), yl_tv=zu())

    return SolverState(
        x=zx(), u=zu(), q=zx(), r=zu(), p=zx(), d=zu(),
        v=zx(), vnew=zx(), z=zu(), znew=zu(), g=zx(), y=zu(),
        **fam,
        iter=zb(torch.int32),
        solved=zb(torch.bool),
        status=torch.full(b, TINY_UNSOLVED, dtype=torch.int32, device=device),
        pri_res_state=zb(), pri_res_input=zb(),
        dua_res_state=zb(), dua_res_input=zb(),
    )
