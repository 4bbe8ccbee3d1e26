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
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# Status codes (reference types.hpp has no enum; values from admm.cpp:336,431)
TINY_UNSOLVED = 11
TINY_SOLVED = 1


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

    @property
    def any_extra_family(self) -> bool:
        """Any constraint family beyond the box bounds is enabled."""
        return bool(
            (self.en_state_soc and self.state_cones)
            or (self.en_input_soc and self.input_cones)
            or (self.en_state_linear and self.num_state_linear)
            or (self.en_input_linear and self.num_input_linear)
            or (self.en_tv_state_linear and self.num_tv_state_linear)
            or (self.en_tv_input_linear and self.num_tv_input_linear))


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
    if settings.adaptive_rho:
        raise ValueError("adaptive rho is not ported yet")
    if settings.horizon_parallel:
        raise ValueError("horizon-parallel sweeps are not ported yet")
    if settings.check_termination < 1:
        raise ValueError("check_termination must be >= 1")


def check_supported_spec(spec: ProblemSpec) -> None:
    """Raise ``ValueError`` for constraint families the port does not
    implement (only box bounds are ported)."""
    if spec.any_extra_family or spec.en_consensus:
        raise ValueError("only box constraints are ported; SOC, hyperplane "
                         "and consensus families are not")


@dataclass(frozen=True)
class Cache:
    """Infinite-horizon Riccati cache (reference types.hpp:43-59).
    ``C1``/``C2`` are the reference's aliases of ``Quu_inv``/``AmBKt``."""

    rho: torch.Tensor        # ()
    Kinf: torch.Tensor       # (nu, nx)
    Pinf: torch.Tensor       # (nx, nx)
    Quu_inv: torch.Tensor    # (nu, nu)
    AmBKt: torch.Tensor      # (nx, nx)
    APf: torch.Tensor        # (nx,)
    BPf: torch.Tensor        # (nu,)
    C1: Optional[torch.Tensor] = None
    C2: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class ConstraintData:
    """Box bounds, per timestep like the reference (types.hpp:117-120)."""

    x_min: Optional[torch.Tensor] = None   # (N, nx)
    x_max: Optional[torch.Tensor] = None
    u_min: Optional[torch.Tensor] = None   # (N-1, nu)
    u_max: Optional[torch.Tensor] = None


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
    """Per-problem iterates and status of the box-constrained solve (the
    reference ``TinyWorkspace`` iterate fields, types.hpp:94-114)."""

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

    return SolverState(
        x=zx(), u=zu(), q=zx(), r=zu(), p=zx(), d=zu(),
        v=zx(), vnew=zx(), z=zu(), znew=zu(), g=zx(), y=zu(),
        iter=zb(torch.int32),
        solved=zb(torch.bool),
        status=torch.full(b, TINY_UNSOLVED, dtype=torch.int32, device=device),
        pri_res_state=zb(), pri_res_input=zb(),
        dua_res_state=zb(), dua_res_input=zb(),
    )
