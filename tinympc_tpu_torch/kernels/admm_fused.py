"""Fused batched ADMM solve on the GPU (counterpart of
``tinympc_tpu.kernels.admm_pallas``).

:func:`solve_fused` runs the whole ADMM loop of a batch of cold-started
problems in one launch of a hand-written CUDA kernel (``csrc/admm_group.cu``
or ``csrc/admm_fused.cu``); :func:`solve_fused_warm` does the same from a
warm-start :class:`FusedCarry` and hands the next one back (the
external-plant receding-horizon pattern). The kernels replace the TPU
kernel ``admm_pallas._make_kernel`` for those variants. They run on
``csrc/admm_group.cu``: a problem a group of threads (:func:`group_width`:
16 at (12, 4), 8 at (6, 3)), its trajectories in shared memory for the
whole solve -- box problems at (12, 4) at fixed rho, the main path (the
one-launch fleet too, a system a 128-lane tile); under adaptive rho
(``Settings.adaptive_rho``; the fleet too), each problem's rho carried and
adapted in the kernel; under scenario-tree consensus
(:func:`~tinympc_tpu_torch.api.with_consensus`), a scenario group of ``G``
adjacent problems (G a power of two up to :data:`BLOCK`) exchanging its
offers through one block's shared memory, or, past the problems of a
block, through the shared memory of a thread-block cluster; and problems
with second-order cones, hyperplanes or time-varying hyperplanes, in any
mix, and every problem at (6, 3) (a box-only one with zero family
counts), at fixed and adaptive rho, each family's slacks and duals in
shared memory too (:func:`group_route`). The one-thread-a-problem kernel
``csrc/admm_fused.cu`` runs the rest: consensus with a family or at
(6, 3), group 0, a box consensus group whose cluster the card cannot
form, the multi-system launch with a family or at (6, 3), a families
horizon too long for one problem's columns in a block's shared memory
(:func:`group_route` returns None), and every solve at cartpole's (4, 1)
and the degenerate pairs (2, 2), (2, 1), (3, 3) and (1, 1), which have
no thread-group kind. ``solve_fused_warm(final=True)``, the warm solve of
lane compaction, runs the warm instantiations as they are. The
instantiated (nx, nu) pairs are :data:`KERNEL_DIMS` (box only),
:data:`FAMILY_KERNEL_DIMS` (the families and consensus) and
:data:`ADAPTIVE_KERNEL_DIMS` (adaptive rho, every family) on the group
kernel, and :data:`THREAD_KERNEL_DIMS` (every kind) on the one-thread
kernel alone. On CPU tensors the wrappers run the kernel's plain PyTorch
versions, :func:`solve_fused_reference` and
:func:`solve_fused_warm_reference`, instead; on CUDA tensors they launch
the kernel or raise.

The public layout is the JAX package's: x0s is (B, nx), Xref (N, nx), Uref
(N-1, nu); the result is ``(Solution, residuals)`` with ``Solution.x`` (N, B,
nx), ``Solution.u`` (N-1, B, nu), ``iter`` (B,) int32, ``solved`` (B,) bool,
and residuals (4, B) in the row order pri_x, pri_u, dua_x, dua_u; with
adaptive rho a 5th row holds each lane's final rho (:func:`adapted_cache`
builds the per-problem cache from it). A consensus problem takes x0s as
(n_groups, G, nx) and returns ``Solution.x`` (N, n_groups, G, nx),
``Solution.u`` (N-1, n_groups, G, nu), ``iter`` / ``solved``
(n_groups, G) and residuals (4, n_groups, G), as the JAX package does. The
carry keeps the JAX carry's lane-last layout. Everything runs in float32,
as on the TPU.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..admm import apply_cones, apply_hyperplanes, consensus_rho, tv_rows
from ..projections import sum_last
from ..rho_adapt import RHO_EPS, taylor_update
from ..types import (ADAPTIVE_RHO_PERIOD, Cache, Solution, TinyProblem,
                     check_supported_settings, check_supported_spec)
from . import _build

KERNEL = "admm_fused"
# Threads (= problems) per block of csrc/admm_fused.cu, and the lanes of a
# multi-system launch's tile: each system's lanes are padded to whole
# tiles, one block_sys entry a tile.
BLOCK = 128
# The box-only fixed-rho solve runs csrc/admm_group.cu: a problem a group
# of GROUP threads, at most GROUP_PROBLEMS problems a block (fewer where
# the shared memory a block may have holds fewer; group_geometry). The
# closed loop (csrc/closed_loop_fused.cu) shares both.
GROUP_KERNEL = "admm_group"
# Threads a problem of csrc/admm_group.cu at each (nx, nu) it instantiates
# (kGroupOf; a loaded library's tinympc_admm_group_width_at is held to it):
# at (6, 3) 8 threads for 9 rows, thread 0 owning rows 0 and 8.
GROUP_WIDTHS = {(12, 4): 16, (6, 3): 8}
GROUP = GROUP_WIDTHS[(12, 4)]
GROUP_MAX_THREADS = 128              # csrc/admm_group.cu kMaxThreads
GROUP_PROBLEMS = GROUP_MAX_THREADS // GROUP
# Blocks of a consensus launch's thread-block cluster at most
# (csrc/admm_group.cu kMaxCluster): a scenario group of G > P problems is
# one cluster of G / P blocks; a larger one runs csrc/admm_fused.cu.
GROUP_MAX_CLUSTER = 16
# What a group launch solves (csrc/admm_group.cu Kind): box at fixed rho,
# consensus, adaptive rho without and with apply_c; the families (any mix,
# zero counts at (6, 3)) at fixed rho, adaptive rho and with apply_c.
GROUP_KINDS = {"box": 0, "consensus": 1, "adaptive": 2, "adaptive_c": 3,
               "families": 4, "families_adaptive": 5,
               "families_adaptive_c": 6}
FAMILY_KINDS = ("families", "families_adaptive", "families_adaptive_c")
# Where a group launch keeps what its block's shared memory cannot hold
# (csrc/admm_group.cuh Place), in the order group_geometry tries them: the
# table (the closed loop's: and its reference) and the arena in shared
# memory; the table in device memory; the saved slack columns as well, in
# a (blocks, N, P * (nx + nu)) device-memory buffer (a warm solve or the
# closed loop past N = 1117 at (12, 4)).
PLACE_SHARED, PLACE_TABLE_GLOBAL, PLACE_SAVED_GLOBAL = 0, 1, 2
KERNEL_DIMS = ((12, 4),)             # (nx, nu) of the box-only kernel
FAMILY_KERNEL_DIMS = ((12, 4), (6, 3))   # (nx, nu) of the families kernel
ADAPTIVE_KERNEL_DIMS = ((12, 4), (6, 3))   # (nx, nu) of adaptive rho
# (nx, nu) that only the one-thread kernels instantiate (csrc/admm_fused.cu
# and the one-thread entries of csrc/admm_stream.cu): cartpole and the
# degenerate pairs of the JAX package's tests, every kind the families
# kernel serves (a box-only problem with zero counts), no thread-group
# kind, no lane team and no closed loop.
THREAD_KERNEL_DIMS = ((4, 1), (2, 2), (2, 1), (3, 3), (1, 1))
F32_MAX = float(np.finfo(np.float32).max)
# Shared memory a block may have on Hopper (cudaFuncSetAttribute refuses
# more); the kernel keeps its whole packed table there.
SMEM_LIMIT = 232448

# Launches of the CUDA kernel in this process, by instantiation (see
# :func:`_instantiation`): box-only cold and warm, families cold and warm,
# adaptive rho (box only) cold and warm, families with adaptive rho cold and
# warm, and consensus cold and warm. chip_smoke.py resets and reads them to
# show that each path went through its kernel.
launch_count = 0
warm_launch_count = 0
families_launch_count = 0
families_warm_launch_count = 0
adaptive_launch_count = 0
adaptive_warm_launch_count = 0
adaptive_families_launch_count = 0
adaptive_families_warm_launch_count = 0
consensus_launch_count = 0
consensus_warm_launch_count = 0
# Multi-system launches (solve_fused_multi and the fleet solver), any
# instantiation but consensus, cold and warm.
multi_launch_count = 0
multi_warm_launch_count = 0
# Launches by C entry: the box-only solve's at (12, 4) is
# tinympc_admm_group (fixed rho, single and multi-system),
# tinympc_admm_group_adaptive (adaptive rho, single and multi-system) or
# tinympc_admm_group_consensus; the families' and (6, 3)'s at fixed and
# adaptive rho tinympc_admm_group_families (group_route); every other
# launch's tinympc_admm_fused or tinympc_admm_fused_multi.
GROUP_ENTRIES = {"box": "tinympc_admm_group",
                 "adaptive": "tinympc_admm_group_adaptive",
                 "adaptive_c": "tinympc_admm_group_adaptive",
                 "consensus": "tinympc_admm_group_consensus",
                 "families": "tinympc_admm_group_families",
                 "families_adaptive": "tinympc_admm_group_families",
                 "families_adaptive_c": "tinympc_admm_group_families"}
entry_counts = dict.fromkeys(("tinympc_admm_group", "tinympc_admm_fused",
                              "tinympc_admm_fused_multi",
                              "tinympc_admm_group_adaptive",
                              "tinympc_admm_group_consensus",
                              "tinympc_admm_group_families"), 0)


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


class Consensus(NamedTuple):
    """Consensus parameters of a fused solve: the group size G (adjacent
    lanes) and the weight rho_c, as float32."""

    group: int
    rho_c: float


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
# The carry field of each family's dual, in the order of Families and of
# the kernels' family arrays.
_FAMILY_DUALS = ("gc", "yc", "gl", "yl", "gtv", "ytv")


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
    """Raise ``ValueError`` for a problem the fused kernel does not cover,
    a horizon whose tables do not fit in a block's shared memory among
    them."""
    _check_problem(prob)
    spec = prob.spec
    smem = smem_bytes(spec.nx, spec.nu, spec.N, _families(spec),
                      _adaptive(prob.settings), spec.en_consensus)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"at N={spec.N} the fused kernel's tables take {smem} B of shared "
            f"memory, more than the {SMEM_LIMIT} B a block may have; "
            "solve_fused_streamed solves long horizons")


def smem_bytes(nx: int, nu: int, N: int, fam: Families = NO_FAMILIES,
               adapt: Optional[Adaptive] = None,
               consensus: bool = False) -> int:
    """Shared memory of one block of csrc/admm_fused.cu: the packed table
    (:func:`_table_layout`) and the terminal reference term, with its
    sensitivity under adaptive rho; under consensus also each lane's
    slack, dual and exchanged u[0] + dual, (nu, BLOCK) each
    (admm_fused.cu:launch)."""
    floats = sum(math.prod(shape) for _, shape in _table_layout(
        nx, nu, N, fam, adapt, consensus))
    lanes = 3 * nu * BLOCK if consensus else 0
    return 4 * (floats + nx * (1 if adapt is None else 2) + lanes)


def group_arena_floats(N: int, P: int, saved: bool, nx: int = 12,
                       nu: int = 4, kind: str = "box",
                       fam: "Families" = None) -> int:
    """Floats of the shared-memory arena of P problems of the group kernels
    (``GroupArena`` of csrc/admm_group.cuh): the exchange slots (x, r / u
    and w, each padded to whole float4s; under adaptive rho with a g slot
    each), the slack, dual and -- with ``saved`` (a warm solve or the
    closed loop, but at :data:`PLACE_SAVED_GLOBAL`) -- saved columns of
    every row, the input rows' feedforward, under consensus the offers
    (nu, P) and the cluster's exit vote (4 floats), and for the families
    kinds, from a 16-byte boundary, a (slack, dual) column pair a row of
    each family of ``fam`` that is on: (N, P * nx) pairs a state family,
    (N - 1, P * nu) an input family. This is the count of the CPU path and
    the emulations; a launch takes the loaded library's
    (:func:`group_geometry`'s ``count``), which :func:`check_group_geometry`
    holds against this one."""
    slot = _align4(nx) + 2 * _align4(nu)
    if "adaptive" in kind:
        slot += _align4(nx)
    lanes = nu * P + 4 if kind == "consensus" else 0
    base = P * slot + (3 if saved else 2) * N * P * (nx + nu) \
        + (N - 1) * P * nu + lanes
    fx, fu = _sides(fam)
    if kind not in FAMILY_KINDS or not (fx or fu):
        return base
    return _align4(base) + 2 * P * (N * nx * fx + (N - 1) * nu * fu)


def _sides(fam: Optional["Families"]) -> Tuple[int, int]:
    """The families of ``fam`` that are on: (state side, input side)."""
    if fam is None:
        return 0, 0
    return ((fam.ncx > 0) + (fam.nlx > 0) + (fam.ntx > 0),
            (fam.ncu > 0) + (fam.nlu > 0) + (fam.ntu > 0))


def group_width(nx: int, nu: int) -> int:
    """Threads a problem of csrc/admm_group.cu at (nx, nu)
    (:data:`GROUP_WIDTHS`, which :func:`_group_lib` holds the library
    to)."""
    return GROUP_WIDTHS[(nx, nu)]


def _align4(n: int) -> int:
    return -(-n // 4) * 4


def group_smem(N: int, P: int, place: int, save: bool, table: int,
               nx: int = 12, nu: int = 4, kind: str = "box",
               fam: "Families" = None) -> int:
    """Bytes of shared memory of a group launch of P problems at ``place``:
    the ``table`` floats (the packed table; the closed loop's and its
    reference), 16-byte aligned, at :data:`PLACE_SHARED`, and the arena,
    with the saved columns where ``save`` and they are not in device
    memory (csrc/admm_group.cu and csrc/closed_loop_fused.cu smem_bytes)."""
    return 4 * ((_align4(table) if place == PLACE_SHARED else 0)
                + group_arena_floats(
                    N, P, save and place != PLACE_SAVED_GLOBAL, nx, nu,
                    kind, fam))


@functools.lru_cache(maxsize=None)
def _group_table(N: int, nx: int, nu: int, kind: str,
                 fam: "Families" = None) -> int:
    """Floats of the packed table a group launch of ``kind`` reads: the box
    tables, then the family tables of ``fam`` (the families kinds), then
    the adaptive tables or the step-0 consensus gains."""
    adapt = None if "adaptive" not in kind else Adaptive(
        kind.endswith("_c"), False, 0.0, 0.0, 1.0)
    if kind not in FAMILY_KINDS or fam is None:
        fam = NO_FAMILIES
    return _table_floats(nx, nu, N, fam, adapt, kind == "consensus")


def group_geometry(N: int, save: bool, table: Optional[int] = None,
                   nx: int = 12, nu: int = 4, kind: str = "box",
                   count=None, fam: "Families" = None):
    """The launch of a group kernel for horizon N: ``(P, place, smem)`` --
    problems a block (a power of two at most :data:`GROUP_PROBLEMS`, so
    that a block lies inside one 128-lane tile of a fleet and a scenario
    group of G problems lies in one block or spans G / P whole blocks),
    where it keeps its table and saved columns (``PLACE_*``), and the bytes
    of shared memory. ``save``: a warm solve or the closed loop, which keep
    a saved slack column a row; ``table``: the floats a block copies at
    :data:`PLACE_SHARED`, by default the packed table of csrc/admm_group.cu
    for ``kind`` (:data:`GROUP_KINDS`; the families kinds with the family
    tables and columns of ``fam``); ``count(N, P, place)``: the bytes of a
    launch as the loaded library counts them (``tinympc_*_smem``), else
    :func:`group_smem`'s sum. P starts at the problems a block of 128
    threads holds (:func:`group_width`). The first place that fits, each
    with P halved as far as 1: the table in shared memory beside the
    arena; the arena alone; and, with ``save``, the arena without the
    saved columns (to N = 1613 for the box at (12, 4), past every horizon
    :func:`fused_supported` takes). Raises ``ValueError`` where none fits
    (the families past :func:`group_route`'s cutoff)."""
    if table is None:
        table = _group_table(N, nx, nu, kind, fam)
    if count is None:
        count = lambda N, P, place: group_smem(N, P, place, save, table, nx,
                                               nu, kind, fam)
    places = (PLACE_SHARED, PLACE_TABLE_GLOBAL) \
        + ((PLACE_SAVED_GLOBAL,) if save else ())
    for place in places:
        P = GROUP_MAX_THREADS // group_width(nx, nu)
        while P >= 1:
            smem = count(N, P, place)
            if smem <= SMEM_LIMIT:
                return P, place, smem
            P //= 2
    raise ValueError(
        f"at N={N} one problem's trajectories take "
        f"{count(N, 1, places[-1])} B of shared "
        f"memory, more than the {SMEM_LIMIT} B a block may have")


def group_kind(nx: int, nu: int, fam: "Families", adapt, cons
               ) -> Optional[str]:
    """The kind of csrc/admm_group.cu launch (:data:`GROUP_KINDS`) a solve
    of these parameters takes, or None where it runs csrc/admm_fused.cu:
    box problems at (12, 4) at fixed rho, under adaptive rho (with or
    without apply_c), or under consensus with a group (group 0, the
    families kernel without the exchange, stays there); problems with a
    family, and every problem at (6, 3), at fixed or adaptive rho (the
    families kinds). Consensus with a family or at (6, 3) stays there, as
    does every solve at :data:`THREAD_KERNEL_DIMS`."""
    if (nx, nu) not in FAMILY_KERNEL_DIMS:
        return None
    families = any(fam) or (nx, nu) not in KERNEL_DIMS
    if cons is not None:
        return "consensus" if cons.group >= 1 and not families else None
    rho = ("adaptive_c" if adapt.apply_c else "adaptive") \
        if adapt is not None else None
    if families:
        return "families" if rho is None else "families_" + rho
    return rho or "box"


def group_cluster(G: int, P: int) -> int:
    """Blocks of the thread-block cluster a scenario group of G problems
    spans at P problems a block: 1 when it lies in one block, else
    G / P."""
    return 1 if G <= P else G // P


def group_route(N: int, nx: int, nu: int, fam: "Families", adapt, cons,
                warm: bool, count=None, fits=None, multi: bool = False):
    """``(kind, P, place, cluster)`` of the group launch a solve takes, or
    None where it runs csrc/admm_fused.cu: a problem outside
    :func:`group_kind`, a consensus group whose thread-block cluster
    cannot be formed at the P that fits the horizon -- more than
    :data:`GROUP_MAX_CLUSTER` blocks (a group of 128 from N=124 warm and
    N=171 cold, where P falls below 8), or, where ``fits(N, P, place,
    cluster)`` is given (the loaded library's occupancy query), a cluster
    the card cannot hold --, a multi-system launch (``multi``) of a
    families kind, or a families horizon whose arena does not fit one
    problem a block (:func:`group_geometry`; at (12, 4) past N=968 with
    one family on, past N=440 with all six, cold or warm, the warm solve's
    saved columns then in device memory; at (6, 3) past N=774 with all
    six). ``count`` as
    :func:`group_geometry` takes it."""
    kind = group_kind(nx, nu, fam, adapt, cons)
    if kind is None or (multi and kind in FAMILY_KINDS):
        return None
    try:
        P, place, _ = group_geometry(N, warm, None, nx, nu, kind, count, fam)
    except ValueError:
        if kind not in FAMILY_KINDS:
            raise
        return None
    cluster = group_cluster(cons.group, P) if kind == "consensus" else 1
    if cluster > GROUP_MAX_CLUSTER or (
            cluster > 1 and fits is not None
            and not fits(N, P, place, cluster)):
        return None
    return kind, P, place, cluster


def group_grid(B: int, P: int) -> int:
    """Blocks of a group launch: one a P problems, the last ragged."""
    return -(-B // P)


def group_saved(x0: torch.Tensor, N: int, P: int, place: int, nx: int,
                nu: int) -> Optional[torch.Tensor]:
    """The device-memory buffer of a launch's saved columns at
    :data:`PLACE_SAVED_GLOBAL` (a block's (N, P * (nx + nu)) slice each),
    else None: the only scratch a group launch allocates, past the
    horizons where one problem's columns fit a block's shared memory."""
    if place != PLACE_SAVED_GLOBAL:
        return None
    return torch.empty(group_grid(x0.shape[0], P) * N * P * (nx + nu),
                       dtype=torch.float32, device=x0.device)


def _check_problem(prob: TinyProblem) -> None:
    """The checks of :func:`_check` but the shared-memory one: settings,
    families, instantiated (nx, nu), horizon, rho and family tables."""
    check_supported_settings(prob.settings)
    check_supported_spec(prob.spec, prob.settings)
    spec = prob.spec
    if prob.settings.adaptive_rho and prob.cache.dKinf_drho is None:
        raise ValueError("adaptive rho needs the rho sensitivities; attach "
                         "them with api.with_sensitivities(prob)")
    if spec.en_consensus and (prob.cache.Kinf0 is None
                              or prob.cache.Quu0_inv is None):
        raise ValueError("en_consensus requires the step-0 consensus gains; "
                         "configure the problem via with_consensus(...)")
    # Every family mix runs at each of these (nx, nu): a box-only problem
    # off (12, 4) runs a families instantiation with zero counts.
    dims = (ADAPTIVE_KERNEL_DIMS if prob.settings.adaptive_rho
            else FAMILY_KERNEL_DIMS) + THREAD_KERNEL_DIMS
    if (spec.nx, spec.nu) not in dims:
        raise ValueError(
            f"(nx, nu) = ({spec.nx}, {spec.nu}) is not one of the kernel's "
            f"instantiations {dims}; other sizes are not ported yet "
            "(ROADMAP.md, Queue 2 item 1c); use tinympc_tpu_torch.solve")
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
    hyperplane and time-varying hyperplane constraints in any mix, at fixed
    rho with or without consensus within the batch (its step-0 gains baked
    by ``with_consensus``), or with adaptive rho and its sensitivities
    attached;
    ``matmul_precision="highest"``, no coarse schedule, an (nx, nu) pair
    the kernel is instantiated for, and tables that fit in a block's shared
    memory (:data:`SMEM_LIMIT`; past N ~ 1190 at (12, 4), where
    ``solve_fused_streamed`` takes over)."""
    try:
        _check(prob)
    except ValueError:
        return False
    return True


# ------------------------------------------------------------ warm carry

@dataclass(frozen=True)
class FusedCarry:
    """Warm-start carry of :func:`solve_fused_warm` (the fields of
    ``tinympc_tpu.kernels.FusedCarry``), float32 in
    the kernel's lane-last layout: the reference's
    persistent workspace between solves -- final slacks ``vnew``/``znew``,
    duals ``g``/``y``, and the previous slacks ``v``/``z``, one iterate
    behind on a lane that converged (the reference skips the v <- vnew copy
    on the converging iteration, admm.cpp:444-446). A problem with other
    families also carries their duals and the primal ``x``/``u``, whose
    rows seed the family slacks of the next solve (admm.cpp:352-376); the
    fields of families that are off are None. A consensus problem carries
    each lane's consensus slack ``zc0`` and dual ``yc0`` and the primal
    x/u: the next solve re-seeds the slack from the carried u[0]
    (admm.seed_extra_slacks), and the dual persists. An adaptive-rho
    problem carries each lane's rho, which persists across solves as the
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
    zc0: Optional[torch.Tensor] = None   # (nu, B) consensus slack
    yc0: Optional[torch.Tensor] = None   # (nu, B) consensus dual
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
    problem's device, with the fields of the problem's families and
    consensus; with adaptive rho, every lane's rho starts at the
    problem's."""
    spec = prob.spec
    carry = _zero_carry(spec.N, spec.nx, spec.nu, B, prob.device,
                        _families(spec), spec.en_consensus)
    if prob.settings.adaptive_rho:
        carry = carry.replace(rho=torch.full(
            (1, B), float(prob.cache.rho), dtype=torch.float32,
            device=prob.device))
    return carry


def _zero_carry(N, nx, nu, B, device, fam=NO_FAMILIES,
                consensus=False) -> FusedCarry:
    return FusedCarry(**{
        name: torch.zeros(shape, dtype=torch.float32, device=device)
        for name, shape in _carry_shapes(N, nx, nu, B, fam,
                                         consensus=consensus).items()})


def shift_carry(carry: FusedCarry) -> FusedCarry:
    """Advance a warm carry one timestep for receding-horizon reuse (the
    classic MPC shift warm start): every time-indexed field drops its first
    row and repeats the last, so the previous solve's tail seeds the
    overlapping window of the next horizon. The u[0] consensus pair and the
    per-lane rho are step-invariant and pass through."""
    return carry.replace(**{
        name: torch.cat([a[1:], a[-1:]], dim=0)
        for name, a in ((n, getattr(carry, n)) for n in CARRY_FIELDS
                        if n not in _LANE_FIELDS)
        if a is not None})


# Carry fields with one row a lane, which the shift passes through.
_LANE_FIELDS = ("zc0", "yc0", "rho")


def _carry_shapes(N, nx, nu, B, fam=NO_FAMILIES, adaptive=False,
                  consensus=False) -> Dict[str, Tuple[int, ...]]:
    """Shape of each carry field the problem needs (admm_pallas.py:227-247):
    the box fields, each family's dual, the consensus pair, x/u when any
    family or consensus is on, and the per-lane rho under adaptive rho."""
    on = {name: True for name in BOX_CARRY_FIELDS}
    xu = any(fam) or consensus
    on.update(gc=fam.ncx > 0, yc=fam.ncu > 0, gl=fam.nlx > 0, yl=fam.nlu > 0,
              gtv=fam.ntx > 0, ytv=fam.ntu > 0, zc0=consensus, yc0=consensus,
              x=xu, u=xu, rho=adaptive)
    shape = lambda name: ((1, B) if name == "rho" else (nu, B)
                          if name in ("zc0", "yc0") else (N, nx, B)
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
                           prob.settings.adaptive_rho, spec.en_consensus)
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
                  adapt: Optional[Adaptive] = None, consensus: bool = False
                  ) -> Tuple[Tuple[str, tuple], ...]:
    """Names and shapes of the packed float32 table, in the order of
    ``Layout`` (csrc/admm_sweep.cuh), then ``FamilyLayout``
    (csrc/admm_families.cuh), then ``AdaptiveLayout``
    (csrc/admm_adaptive.cuh), then the consensus gains
    (csrc/admm_consensus.cuh). The family, adaptive and consensus tables
    come after the box tables and are empty for a box-only fixed-rho
    problem, so its table is the box table alone. Cones are rows (start,
    dim, mu); each hyperplane table is A, b and ||a||^2 of each row
    (``asq``). Adaptive rho adds A^T, Pinf and the sensitivities dKinf,
    dKinf^T, dPinf, dPinf^T, and dC1, dC2 under ``apply_c``
    (admm_pallas.py:1550-1560); consensus the step-0 gains Kinf0 and
    Quu0_inv (``Quu0``; :804-806). Adaptive rho never goes with consensus,
    so the consensus gains follow the family tables."""
    ax, au = (nx, nu) if adapt is not None else (0, 0)
    cx, cu = (nx, nu) if adapt is not None and adapt.apply_c else (0, 0)
    k0 = nu if consensus else 0
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
            ("dC1", (cu, nu)), ("dC2", (cx, nx)),
            ("Kinf0", (k0, nx)), ("Quu0", (k0, nu)))


def _pack_tables(prob: TinyProblem, Xref, Uref,
                 dtype=torch.float32) -> torch.Tensor:
    """The kernel's shared inputs as one contiguous float32 vector on the
    problem's device (``dtype`` float64 gives the plain version's float64
    tables, against which tests hold it to the float64 solver). Bounds of
    a disabled family are +-FLT_MAX, and +-inf bounds are clamped to
    +-FLT_MAX: inf would poison the clamp arithmetic (admm_pallas.py:
    1534-1539). Each hyperplane's ||a||^2 is summed here, once, in feature
    order from zero, as the projection would sum it."""
    spec, c, cons = prob.spec, prob.cache, prob.cons
    N, nx, nu = spec.N, spec.nx, spec.nu
    fam, adapt = _families(spec), _adaptive(prob.settings)
    consensus = spec.en_consensus
    kw = dict(dtype=dtype, device=prob.device)

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
    if consensus:
        parts.update(Kinf0=f32(c.Kinf0, (nu, nx)),
                     Quu0=f32(c.Quu0_inv, (nu, nu)))
    layout = _table_layout(nx, nu, N, fam, adapt, consensus)
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
                   adapt: Optional[Adaptive] = None, consensus: bool = False
                   ) -> Dict[str, torch.Tensor]:
    out, o = {}, 0
    for name, shape in _table_layout(nx, nu, N, fam, adapt, consensus):
        n = int(np.prod(shape))
        out[name] = tables[o:o + n].reshape(shape)
        o += n
    return out


def _prepare(prob: TinyProblem, Xref, Uref, x0s):
    """Check the problem and x0s; return the packed tables, x0 and the
    solver parameters, the problem's family sizes ``fam`` among them."""
    _check(prob)
    return _prepare_inputs(prob, Xref, Uref, x0s)


def _prepare_inputs(prob: TinyProblem, Xref, Uref, x0s):
    """:func:`_prepare` for a problem that is already checked. A consensus
    problem's x0s (n_groups, G, nx) comes back as (B, nx), its group size
    in ``params["cons"]``."""
    x0, params = _x0_params(prob, x0s)
    return _pack_tables(prob, Xref, Uref), x0, params


def _x0_params(prob: TinyProblem, x0s):
    """x0s checked and as a contiguous float32 (B, nx) tensor on the
    problem's device, and the solver parameters of the problem."""
    nx = prob.spec.nx
    if x0s is None:
        raise ValueError("solve_fused needs x0s, shape (B, nx)")
    if isinstance(x0s, torch.Tensor) and x0s.device != prob.device:
        raise ValueError(f"x0s is on {x0s.device}, the problem on "
                         f"{prob.device}")
    x0 = torch.as_tensor(x0s, dtype=torch.float32,
                         device=prob.device).contiguous()
    cons = None
    if prob.spec.en_consensus:
        if x0.ndim != 3 or x0.shape[2] != nx or x0.numel() == 0:
            raise ValueError(
                f"a consensus solve takes x0s as (n_groups, G, {nx}), the "
                "scenario group on the last batch axis as in "
                f"tinympc_tpu_torch.solve; got {tuple(x0.shape)}")
        G = x0.shape[1]
        if G & (G - 1) or G > BLOCK:
            raise ValueError(
                f"scenario group size {G} must be a power of two and at "
                f"most {BLOCK}, the kernel's block: a group's lanes "
                "exchange through one block's shared memory (larger groups "
                "are not ported yet, ROADMAP.md)")
        cons = Consensus(G, float(np.float32(float(consensus_rho(prob)))))
        x0 = x0.reshape(-1, nx)
    elif x0.ndim != 2 or x0.shape[1] != nx or x0.shape[0] < 1:
        raise ValueError(f"x0s must be (B, {nx}) with B >= 1, "
                         f"got {tuple(x0.shape)}")
    st = prob.settings
    params = dict(max_iter=int(st.max_iter), ct=int(st.check_termination),
                  rho=float(np.float32(float(prob.cache.rho))),
                  tol_pri=float(np.float32(st.abs_pri_tol)),
                  tol_dua=float(np.float32(st.abs_dua_tol)),
                  fam=_families(prob.spec), adapt=_adaptive(st), cons=cons)
    return x0, params


def _grouped(out, cons: Optional[Consensus]):
    """``(Solution, residuals, ...)`` with the (n_groups, G) batch of a
    consensus solve restored, as the JAX package returns it; the carry
    stays lane-last."""
    if cons is None:
        return out
    sol, res = out[0], out[1]
    G = cons.group
    lanes = lambda a: a.reshape(*a.shape[:-1], -1, G)
    sol = Solution(iter=lanes(sol.iter), solved=lanes(sol.solved),
                   x=sol.x.reshape(sol.x.shape[0], -1, G, sol.x.shape[-1]),
                   u=sol.u.reshape(sol.u.shape[0], -1, G, sol.u.shape[-1]))
    return (sol, lanes(res)) + tuple(out[2:])


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
        out = _solve_plain(tables, x0, spec.N, spec.nx, spec.nu,
                           **params)[:2]
    elif x0.device.type == "cuda":
        out = _solve_kernel(tables, x0, spec.N, spec.nx, spec.nu, **params)
    else:
        raise ValueError(f"solve_fused runs on cuda or cpu, not "
                         f"{x0.device}")
    return _grouped(out, params["cons"])


def solve_fused_reference(prob: TinyProblem, Xref=None, Uref=None, x0s=None):
    """The kernel's plain PyTorch version, on the problem's device: the
    same inputs, layout, ping-pong, termination stride, freeze and exit
    rules as ``csrc/admm_fused.cu``, so that a mismatch points into the
    kernel. Returns what :func:`solve_fused` returns."""
    tables, x0, params = _prepare(prob, Xref, Uref, x0s)
    spec = prob.spec
    return _grouped(_solve_plain(tables, x0, spec.N, spec.nx, spec.nu,
                                 **params)[:2], params["cons"])


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
    the residuals gain the final rho as a 5th row. A missing or mismatched
    carry raises ``ValueError``. On CPU tensors it runs
    :func:`solve_fused_warm_reference`.

    ``final=True`` is the mode of lane compaction
    (:func:`~.compact.make_compact_solver`; admm_pallas.py:415-420,
    :1298-1315): a lane that has not converged hands over its final
    iterate, field by field the JAX kernel's carry, and the solution
    outputs freeze at first convergence as before. The TPU kernel drops its
    per-lane snapshots there, since its lanes keep computing after they
    converge; this kernel keeps no snapshots (a converged thread stops and
    keeps its iterates), so ``final=True`` runs the same instantiation, and
    a converged lane hands over its state at first convergence, the carry
    of ``final=False``. (The JAX kernel hands over a post-convergence
    iterate there; its contract reads a converged lane's carry only inside
    a live consensus group.)"""
    tables, x0, carry, params = _prepare_warm(prob, Xref, Uref, x0s, carry,
                                              final)
    spec = prob.spec
    if x0.device.type == "cpu":
        out = _solve_plain(tables, x0, spec.N, spec.nx, spec.nu,
                           carry=carry, **params)[:3]
    elif x0.device.type == "cuda":
        out = _solve_kernel_warm(tables, x0, carry, spec.N, spec.nx,
                                 spec.nu, **params)
    else:
        raise ValueError(f"solve_fused_warm runs on cuda or cpu, not "
                         f"{x0.device}")
    return _grouped(out, params["cons"])


def solve_fused_warm_reference(prob: TinyProblem, Xref=None, Uref=None,
                               x0s=None, carry: Optional[FusedCarry] = None,
                               *, final: bool = False):
    """The warm kernel's plain PyTorch version, on the problem's device,
    with the kernel's load, freeze and carry-out rules (``final`` as
    :func:`solve_fused_warm` takes it). Returns what
    :func:`solve_fused_warm` returns."""
    tables, x0, carry, params = _prepare_warm(prob, Xref, Uref, x0s, carry,
                                              final)
    spec = prob.spec
    return _grouped(_solve_plain(tables, x0, spec.N, spec.nx, spec.nu,
                                 carry=carry, **params)[:3], params["cons"])


def _prepare_warm(prob, Xref, Uref, x0s, carry, final):
    """:func:`_prepare` and the carry of a warm solve. ``final`` changes
    nothing here: the carry of every lane that has not converged is its
    final iterate either way (see :func:`solve_fused_warm`)."""
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


def _family_projectors(t, fam: Families):
    """The projection of each family of ``fam`` from the unpacked tables
    ``t``, in the order of :data:`_FAMILY_DUALS` (SOC, hyperplane,
    time-varying hyperplane; the state side before the input side of
    each), None for a family that is off. Each maps a lane-last
    (rows, F, B) candidate to its projection."""
    def cones(table):
        geometry = [(int(s), int(d)) for s, d in table[:, :2].tolist()]
        return _lanes(apply_cones, geometry, table[:, 2])

    def planes(A, b, asq):
        return _lanes(apply_hyperplanes, list(zip(A, b, asq)))

    def tv_planes(A, b, asq, count):
        rows = tv_rows(A, b, count, 1)
        return _lanes(apply_hyperplanes, [(a, bk, asq[:, k, None])
                                          for k, (a, bk) in enumerate(rows)])

    make = (lambda: cones(t["xcones"]), lambda: cones(t["ucones"]),
            lambda: planes(t["Alin_x"], t["blin_x"], t["asq_x"]),
            lambda: planes(t["Alin_u"], t["blin_u"], t["asq_u"]),
            lambda: tv_planes(t["tv_Alin_x"], t["tv_blin_x"], t["tv_asq_x"],
                              fam.ntx),
            lambda: tv_planes(t["tv_Alin_u"], t["tv_blin_u"], t["tv_asq_u"],
                              fam.ntu))
    return [m() if n else None for m, n in zip(make, fam)]


def _plain_families(t, fam: Families, x_seed, u_seed, carry):
    """The state-side and input-side families of the plain version, in the
    kernel's order (SOC, hyperplane, time-varying hyperplane), with their
    seeded slacks and their duals (zero, or from the carry)."""
    xs, us = [], []
    for k, (proj, name) in enumerate(zip(_family_projectors(t, fam),
                                         _FAMILY_DUALS)):
        if proj is None:
            continue
        seed = x_seed if k % 2 == 0 else u_seed
        dual = torch.zeros_like(seed) if carry is None \
            else getattr(carry, name).clone()
        (xs if k % 2 == 0 else us).append(
            _Family(proj, seed.clone(), dual, name))
    return xs, us


def _solve_plain(tables, x0, N, nx, nu, *, max_iter, ct, rho, tol_pri,
                 tol_dua, carry: Optional[FusedCarry] = None,
                 fam: Families = NO_FAMILIES,
                 adapt: Optional[Adaptive] = None,
                 cons: Optional[Consensus] = None):
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
    861-920); see :func:`_adapt_plain` for the adaptation.

    With ``cons`` the lanes form scenario groups of ``cons.group``
    adjacent lanes: r[0] gains -rho_c (zc0 - yc0), step 0 of the sweeps
    takes the gains Quu0_inv / Kinf0, and after the duals every lane
    offers cand0 = u[0] + yc0 to its group. A lane's slack is the group
    mean of the offers, summed in lane order and divided by G
    (:func:`_group_mean`), its dual moves by u[0] - zc0, and it converges
    only once max|u[0] - zc0| is below ``tol_pri`` too. A converged lane
    freezes, and the offer of its converging iteration stands for the rest
    of the solve: the kernel's rule, which computes nothing more for a
    frozen lane. (The JAX package's XLA path offers one iteration past the
    frozen iterate instead, and its TPU kernel keeps iterating converged
    lanes; the three agree to the JAX tests' tolerances.) The slack starts
    at the carried u[0] (zero cold), the dual at the carried yc0.

    Returns ``(Solution, residuals, carry' or None, u0)``, where u0 (nu, B)
    is the raw forward-pass u[0] of each lane's last iteration (zero when
    max_iter is 0) and residuals gain the final rho as a 5th row under
    ``adapt``."""
    t = _unpack_tables(tables, nx, nu, N, fam, adapt, cons is not None)
    B = x0.shape[0]
    kw = dict(dtype=tables.dtype, device=x0.device)
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
    if cons is not None:
        # [Kinf0; A], step 0's product, shaped as every other step's.
        Mfwd0 = torch.cat([t["Kinf0"], t["Mfwd"][nu:]])
        zc0 = ucar[0].clone()
        yc0 = torch.zeros((nu, B), **kw) if carry is None \
            else carry.yc0.clone()
        offer = torch.zeros((nu, B), **kw)

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
            if cons is not None and i == 0:
                r = r - cons.rho_c * (zc0 - yc0)
            q = col(negxq[i]) - rho_b * (vnew[pv, i] - g[i])
            for f in xfams:
                q = q - rho_b * (f.slack[i] - f.dual[i])
            out = t["Mback"] @ p
            bp, ap = out[:nu], out[nu:]
            w = bp + r + col(t["BPf"])
            d[i] = (t["Quu0"] if cons is not None and i == 0
                    else t["Quu"]) @ w
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
            out = (Mfwd0 if cons is not None and i == 0 else t["Mfwd"]) @ x
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
        # 5.7. consensus: the group slack, dual and residual
        if cons is not None:
            offer = torch.where(active, us[0] + yc0, offer)
            zc0n = _group_mean(offer, cons.group)
            yc0n = yc0 + us[0] - zc0n
            cres = torch.amax(torch.abs(us[0] - zc0n), dim=0)
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
        if cons is not None:
            zc0 = torch.where(active, zc0n, zc0)
            yc0 = torch.where(active, yc0n, yc0)
        iters = torch.where(active, it + 1, iters).to(torch.int32)
        if checking:
            res = torch.where(active, rows, res)
            ok = ((rows[0] < tol_pri) & (rows[1] < tol_pri)
                  & (rows[2] < tol_dua) & (rows[3] < tol_dua))
            if cons is not None:
                ok = ok & (cres < tol_pri)
            done = done | (ok & active)
            if bool(done.all()):
                break

    if adapt is not None:
        # Converged lanes froze their rho: this is each problem's final
        # rho, as in the final cache of admm.solve.
        res = torch.cat([res, lane_rho[None]])
    extra = {}
    if carry is not None:
        extra = {f.name: f.dual for f in xfams + ufams}
        if any(fam) or cons is not None:
            extra.update(x=xcar, u=ucar)
        if cons is not None:
            extra.update(zc0=zc0, yc0=yc0)
        if adapt is not None:
            extra.update(rho=lane_rho[None].clone())
    return _outputs(vnew, znew, g, y, iters, done, res, carry, extra) + (u0,)


def _group_mean(offer, G: int):
    """The mean of each group of ``G`` adjacent lanes of ``offer`` (rows,
    B), broadcast back to its lanes: the G offers summed one after another
    in lane order from zero, then divided by G, as the kernel sums them
    (``torch.mean`` fixes no order)."""
    rows, B = offer.shape
    lanes = offer.reshape(rows, B // G, G)
    total = torch.zeros_like(lanes[..., 0])
    for j in range(G):
        total = total + lanes[..., j]
    return (total / G)[..., None].expand(rows, B // G, G).reshape(rows, B)


def _outputs(vnew, znew, g, y, iters, done, res, carry, extra):
    """``(Solution, residuals, carry' or None)`` from the ping-pong halves
    of a solve whose converged lanes froze: each lane reports the half its
    last iteration wrote (half 1 -- zero, or the carried slack -- when it
    ran none). A warm solve hands over that half, the duals ``g``/``y``,
    the fields of ``extra``, and as v/z the "previous" the converging
    iteration compared against (the carried v/z if that was iteration 0,
    else the other half), or the last half for a lane that ran out of
    iterations."""
    first = ((iters - 1) % 2) == 0
    vlast = torch.where(first, vnew[0], vnew[1])
    zlast = torch.where(first, znew[0], znew[1])
    sol = Solution(iter=iters, solved=done.clone(),
                   x=vlast.permute(0, 2, 1).contiguous(),
                   u=zlast.permute(0, 2, 1).contiguous())
    if carry is None:
        return sol, res, None
    stale = done & (iters == 1)
    vprev = torch.where(stale, carry.v, torch.where(first, vnew[1], vnew[0]))
    zprev = torch.where(stale, carry.z, torch.where(first, znew[1], znew[0]))
    return sol, res, FusedCarry(vnew=vlast, znew=zlast, g=g, y=y,
                                v=torch.where(done, vprev, vlast),
                                z=torch.where(done, zprev, zlast), **extra)


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
    the carried rho in (null on a cold solve), the final rho out, the
    kernel's scratch for the rows of an adaptation iteration, and the
    virtual rho of the streamed solve's lanes (null here)."""

    _fields_ = [("apply_c", ctypes.c_int), ("clip", ctypes.c_int),
                ("rho_min", ctypes.c_float), ("rho_max", ctypes.c_float),
                ("rho_tol", ctypes.c_float), ("rho_in", _PTR),
                ("rho_out", _PTR), ("xs", _PTR), ("us", _PTR),
                ("axd", _PTR), ("rho_v", _PTR)]


class _ConsensusArgs(ctypes.Structure):
    """``ConsensusArgs`` of csrc/admm_consensus.cuh: the group size and
    rho_c, the carried u (left null: the entry point takes the families'
    u_in), the carried dual in and the slack and dual out (null on a cold
    solve)."""

    _fields_ = [("group", ctypes.c_int), ("rho_c", ctypes.c_float),
                ("u_in", _PTR), ("yc0_in", _PTR), ("zc0_out", _PTR),
                ("yc0_out", _PTR)]


def _kernel_fn(multi: bool = False):
    """The C entry point of csrc/admm_fused.cu, built and loaded on first
    use: ``tinympc_admm_fused``, or with ``multi`` the multi-system
    ``tinympc_admm_fused_multi`` (two more arguments before the stream)."""
    lib = _build.load(KERNEL)
    if lib.tinympc_admm_fused_block() != BLOCK:
        raise RuntimeError("csrc/admm_fused.cu and admm_fused.BLOCK disagree "
                           "on the block size")
    fn = lib.tinympc_admm_fused_multi if multi else lib.tinympc_admm_fused
    # warm nx nu N B max_iter ct | counts | rho tol_pri tol_dua |
    # 12 buffers | carry array, family array | adaptive-rho arguments |
    # consensus arguments | (multi: block systems, table stride) | the stream
    fn.argtypes = ([ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
                   + [ctypes.c_float] * 3 + [_PTR] * 12 + [_PTRS] * 2
                   + [ctypes.POINTER(_AdaptArgs),
                      ctypes.POINTER(_ConsensusArgs)]
                   + ([_PTR, ctypes.c_int] if multi else []) + [_PTR])
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


def _table_floats(nx, nu, N, fam=NO_FAMILIES, adapt=None,
                  consensus=False) -> int:
    """Floats of one packed table (:func:`_table_layout`)."""
    return sum(math.prod(s) for _, s in _table_layout(nx, nu, N, fam, adapt,
                                                      consensus))


def _launch_buffers(tables, x0, N, nx, nu, fam=NO_FAMILIES, adapt=None,
                    consensus=False, n_sys=1):
    """Check the shared inputs (``n_sys`` packed tables one after another)
    and allocate the outputs and scratch of one launch; the kernel
    initialises the scratch it reads. Adaptive rho adds a 5th residual row
    (the final rho) and the scratch of the rows of an adaptation iteration:
    x, u and the dynamics rows."""
    dev = x0.device
    B = x0.shape[0]
    f32 = torch.float32
    _check_arg(x0, (B, nx), f32, dev)
    ntab = _table_floats(nx, nu, N, fam, adapt, consensus)
    _check_arg(tables, (n_sys * ntab,), f32, dev)
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


def _ptr_array(tensors):
    """A host array of device pointers, null for None."""
    return (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))


def _instantiation(nx, nu, fam, adapt, cons) -> str:
    """What a solve runs, the name of its launch counter: "consensus",
    "adaptive_families" (adaptive rho with a family beyond the box, or off
    (12, 4)), "adaptive" (box only at (12, 4)), "families" (a family beyond
    the box, or off (12, 4)) or "box". Which C entry a launch takes --
    csrc/admm_group.cu's or csrc/admm_fused.cu's -- is :func:`group_route`'s
    rule (``entry_counts``)."""
    families = any(fam) or (nx, nu) not in KERNEL_DIMS
    if cons is not None:
        return "consensus"
    if adapt is not None:
        return "adaptive_families" if families else "adaptive"
    return "families" if families else "box"


def _launch(tables, x0, N, nx, nu, fam, adapt, cons, carry, max_iter, ct,
            rho, tol_pri, tol_dua, block_sys=None):
    """Launch csrc/admm_fused.cu on the current stream of x0's device: cold
    when ``carry`` is None, else warm, on the instantiation
    :func:`_instantiation` names. Returns the outputs and scratch, and the
    new carry of a warm solve (its duals are the kernel's dual buffers). A
    warm box-only solve on a families instantiation (off (12, 4)) hands the
    kernel scratch for the x/u it seeds and hands over, which its carry
    does not keep. ``block_sys`` (int32, a system for each block of
    :data:`BLOCK` lanes) makes it the multi-system launch: ``tables`` then
    holds one packed table per system. A solve :func:`group_route` takes
    (box at (12, 4): fixed rho, adaptive rho, consensus; the families and
    (6, 3) at fixed and adaptive rho, one system) launches
    csrc/admm_group.cu instead."""
    kind = group_kind(nx, nu, fam, adapt, cons)
    multi = block_sys is not None
    if kind is not None and not (multi and kind in FAMILY_KINDS):
        # The library first: its own counts decide the route.
        fn = _group_fn() if kind == "box" else _group_policy_fn(kind)
        route = group_route(N, nx, nu, fam, adapt, cons, carry is not None,
                            *_group_probe(kind, carry is not None, fam, nx,
                                          nu),
                            multi=multi)
        if route is not None:
            return _launch_group(fn, route, tables, x0, N, nx, nu, carry,
                                 max_iter, ct, rho, tol_pri, tol_dua,
                                 block_sys, adapt, cons, fam)
    dev, B = x0.device, x0.shape[0]
    kw = dict(dtype=torch.float32, device=dev)
    consensus = cons is not None
    stride = _table_floats(nx, nu, N, fam, adapt, consensus)
    n_sys = 1
    if block_sys is not None:
        if consensus:
            raise ValueError("the multi-system launch takes no consensus")
        _check_arg(block_sys, (-(-B // BLOCK),), torch.int32, dev)
        n_sys = tables.numel() // stride
    buf = _launch_buffers(tables, x0, N, nx, nu, fam, adapt, consensus,
                          n_sys)
    shapes = _carry_shapes(N, nx, nu, B, fam, adapt is not None, consensus)
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
               for k in ("vnew", "znew", "v", "z") + (
                   ("x", "u") if any(fam) or consensus else ())
               + (("zc0", "yc0") if consensus else ())}
        carry_ptrs = [getattr(carry, k) for k in BOX_CARRY_FIELDS] + [
            out[k] for k in ("vnew", "znew", "v", "z")]
        xu_in = [getattr(carry, "x"), getattr(carry, "u")]
        xu_out = [out.get("x"), out.get("u")]
        if xu_in[0] is None and "families" in _instantiation(
                nx, nu, fam, adapt, cons):
            xu_in = xu_out = [torch.empty(shapes["vnew"], **kw),
                              torch.empty(shapes["znew"], **kw)]
        fam_ptrs = work + [getattr(carry, k) for k in _FAMILY_DUALS] \
            + xu_in + xu_out
    adapt_args = None
    if adapt is not None:
        scratch = [torch.empty(shape, **kw) for shape in (
            (N, nx, B), (N - 1, nu, B), (N - 1, nx, B))]
        adapt_args = ctypes.byref(_AdaptArgs(
            int(adapt.apply_c), int(adapt.clip), adapt.rho_min,
            adapt.rho_max, adapt.rho_tol,
            None if carry is None else carry.rho.data_ptr(),
            buf["res"][4].data_ptr(), *(a.data_ptr() for a in scratch)))
    cons_args = None
    if consensus:
        warm = [None] * 3 if carry is None else [
            carry.yc0.data_ptr(), out["zc0"].data_ptr(),
            out["yc0"].data_ptr()]
        cons_args = ctypes.byref(_ConsensusArgs(cons.group, cons.rho_c,
                                                None, *warm))
    fn = _kernel_fn() if block_sys is None else _kernel_fn(multi=True)
    counts = (ctypes.c_int * 6)(*fam)
    systems = () if block_sys is None else (block_sys.data_ptr(), stride)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(int(carry is not None), nx, nu, N, B, max_iter, ct, counts,
                 rho, tol_pri, tol_dua, tables.data_ptr(), x0.data_ptr(),
                 *(buf[k].data_ptr() for k in _BUFFER_ORDER),
                 _ptr_array(carry_ptrs), _ptr_array(fam_ptrs), adapt_args,
                 cons_args, *systems, stream)
    if err != 0:
        raise RuntimeError(f"admm_fused kernel launch failed: CUDA error "
                           f"{err}")
    entry_counts["tinympc_admm_fused" if block_sys is None
                 else "tinympc_admm_fused_multi"] += 1
    sol = Solution(iter=buf["iters"], solved=buf["solved"], x=buf["out_x"],
                   u=buf["out_u"])
    if carry is None:
        return sol, buf["res"], None
    if adapt is not None:
        out["rho"] = buf["res"][4:5].clone()
    return sol, buf["res"], FusedCarry(g=buf["g"], y=buf["y"], **out,
                                       **duals)


def _supported_horizons(nx: int, nu: int):
    """Every N the box-only fused solve takes at (nx, nu): its tables fit a
    block's shared memory (:func:`_check`)."""
    N = 2
    while smem_bytes(nx, nu, N) <= SMEM_LIMIT:
        yield N
        N += 1


def check_group_geometry(smem_fn, table_fn=None, nx: int = 12,
                         nu: int = 4, kinds=(False, True),
                         group_kind: str = "box", fam=None,
                         horizons=None) -> None:
    """Hold :func:`group_geometry`'s own sum for a launch of ``group_kind``
    (:data:`GROUP_KINDS`; the families kinds with the families ``fam``)
    against a library's count of its shared memory,
    ``smem_fn(N, P, place, kind)``, at every supported horizon (or those
    of ``horizons``) that a launch takes and each of ``kinds`` (``save``
    unless ``table_fn`` maps a kind to the table floats of the closed
    loop's launch, which always saves): raise ``RuntimeError`` where they
    disagree, before a launch fails on it or the CPU path and the
    emulations count another arena."""
    for N in horizons or _supported_horizons(nx, nu):
        for kind in kinds:
            save = True if table_fn else kind
            table = table_fn(N, kind) if table_fn else None
            try:
                P, place, smem = group_geometry(N, save, table, nx, nu,
                                                group_kind, fam=fam)
            except ValueError:
                if group_kind not in FAMILY_KINDS:
                    raise
                continue            # past the cutoff: no group launch
            got = smem_fn(N, P, place, kind)
            if got != smem:
                raise RuntimeError(
                    f"the kernel counts {got} B of shared memory at N={N}, "
                    f"P={P}, place {place}, kind {group_kind}, the wrapper "
                    f"{smem}: their arena layouts disagree")


class _GroupConsensusArgs(ctypes.Structure):
    """``GroupConsensusArgs`` of csrc/admm_group.cuh: the scenario group and
    the blocks of its cluster, rho_c, the carried u, x and dual in and the
    slack, dual and x/u out (null on a cold solve)."""

    _fields_ = [("group", ctypes.c_int), ("cluster", ctypes.c_int),
                ("rho_c", ctypes.c_float), ("u_in", _PTR), ("x_in", _PTR),
                ("yc0_in", _PTR), ("zc0_out", _PTR), ("yc0_out", _PTR),
                ("x_out", _PTR), ("u_out", _PTR)]


# Family mixes whose arenas a loaded library's counts are held against:
# each family alone, all six, and the rocket's cones.
_CHECKED_FAMILIES = (Families(ncx=1), Families(ncu=2), Families(nlx=2),
                     Families(nlu=1), Families(ntx=1), Families(ntu=3),
                     Families(1, 1, 1, 1, 1, 1), Families(ncx=1, ncu=1))


def _counts(fam: Families):
    return (ctypes.c_int * 6)(*fam)


def _steps(f, lo: int, hi: int) -> list:
    """The N in (lo, hi] with f(N) != f(N - 1), for an f of N that never
    returns to a value it left (a launch's geometry as N grows)."""
    if f(lo) == f(hi):
        return []
    if hi == lo + 1:
        return [hi]
    mid = (lo + hi) // 2
    return _steps(f, lo, mid) + _steps(f, mid, hi)


def family_horizons(nx: int, nu: int, kind: str, fam: Families) -> list:
    """The horizons at which :func:`check_group_geometry` holds a library's
    count of a families launch: the first few, and a few on each side of
    every horizon where :func:`group_geometry`'s P or place changes, cold
    or warm, or the group launch ends (the cutoff of :func:`group_route`),
    up to the last N the one-thread kernel takes. Between two of them each
    count is one affine sum of N but for the 16-byte rounding, whose four
    phases the few cover."""
    adapt = None if "adaptive" not in kind else Adaptive(
        kind.endswith("_c"), False, 0.0, 0.0, 1.0)
    fits = lambda N: smem_bytes(nx, nu, N, fam, adapt) <= SMEM_LIMIT
    top = (_steps(fits, 2, 4096) or [4097])[0] - 1
    edges = {2}
    for save in (False, True):
        @functools.lru_cache(maxsize=None)
        def place(N, save=save):
            try:
                return group_geometry(N, save, None, nx, nu, kind, fam=fam)[:2]
            except ValueError:
                return None
        edges.update(_steps(place, 2, top))
    return sorted({N + d for N in edges | {top} for d in range(-3, 4)
                   if 2 <= N + d <= top})


@functools.lru_cache(maxsize=None)
def _group_lib():
    """The library of csrc/admm_group.cu, built and loaded on first use, its
    block, group widths, tile, largest cluster and shared memory (every
    kind's; the families kinds' for each of a few family mixes at every
    (nx, nu), at :func:`family_horizons`) held against this module's."""
    lib = _build.load(GROUP_KERNEL)
    if (lib.tinympc_admm_group_max_threads() != GROUP_MAX_THREADS
            or lib.tinympc_admm_group_tile() != BLOCK
            or lib.tinympc_admm_group_max_cluster() != GROUP_MAX_CLUSTER
            or any(lib.tinympc_admm_group_width_at(*d) != GROUP_WIDTHS[d]
                   for d in FAMILY_KERNEL_DIMS)):
        raise RuntimeError("csrc/admm_group.cu and admm_fused disagree on "
                           "the block size, the group widths, the fleet's "
                           "tile or the largest cluster")
    lib.tinympc_admm_group_smem.restype = ctypes.c_longlong
    lib.tinympc_admm_group_families_smem.restype = ctypes.c_longlong
    for kind, code in GROUP_KINDS.items():
        if kind in FAMILY_KINDS:
            continue
        check_group_geometry(
            lambda N, P, place, warm, code=code: lib.tinympc_admm_group_smem(
                N, P, place, int(warm), code), group_kind=kind)
    for kind in FAMILY_KINDS:
        for nx, nu in FAMILY_KERNEL_DIMS:
            for fam in _CHECKED_FAMILIES + (NO_FAMILIES,):
                check_group_geometry(
                    lambda N, P, place, warm, nx=nx, nu=nu, fam=fam, kind=kind:
                    lib.tinympc_admm_group_families_smem(
                        nx, nu, N, P, place, int(warm), GROUP_KINDS[kind],
                        _counts(fam)), nx=nx, nu=nu, group_kind=kind,
                    fam=fam, horizons=family_horizons(nx, nu, kind, fam))
    return lib


def _group_probe(kind: str, warm: bool, fam: Families = NO_FAMILIES,
                 nx: int = 12, nu: int = 4):
    """``(count, fits)`` for :func:`group_route` from the loaded library of
    csrc/admm_group.cu: ``count(N, P, place)``, the bytes of shared memory
    of a launch of ``kind`` (``tinympc_admm_group_smem``; the families
    kinds' ``tinympc_admm_group_families_smem`` with the counts of
    ``fam`` at (nx, nu)), and ``fits(N, P, place, cluster)``, whether the
    card can hold
    a cluster of that many blocks of a consensus launch
    (``tinympc_admm_group_cluster_occupancy``, cudaOccupancyMaxActiveClusters
    > 0). (None, None) where no library is loaded: the sums of
    :func:`group_smem` and the :data:`GROUP_MAX_CLUSTER` rule alone, the
    CPU path's and the emulations'."""
    lib = _build.loaded(GROUP_KERNEL)
    if lib is None:
        return None, None
    lib = _group_lib()
    if kind in FAMILY_KINDS:
        counts = _counts(fam)
        return (lambda N, P, place: lib.tinympc_admm_group_families_smem(
            nx, nu, N, P, place, int(warm), GROUP_KINDS[kind], counts)), None
    count = lambda N, P, place: lib.tinympc_admm_group_smem(
        N, P, place, int(warm), GROUP_KINDS[kind])
    fits = lambda N, P, place, cluster: _cluster_fits(lib, N, P, place,
                                                      warm, cluster)
    return count, fits


@functools.lru_cache(maxsize=None)
def _cluster_fits(lib, N: int, P: int, place: int, warm: bool,
                  cluster: int) -> bool:
    """Whether the card holds a cluster of ``cluster`` blocks of a consensus
    launch at (N, P, place), asked once a shape."""
    return lib.tinympc_admm_group_cluster_occupancy(N, P, place, int(warm),
                                                    cluster) > 0


# warm nx nu problems place N B max_iter ct | rho tol_pri tol_dua |
# tables x0, 5 outputs | carry array | block systems, table stride | saved
# columns: the arguments every entry of csrc/admm_group.cu takes first.
_GROUP_ARGTYPES = ([ctypes.c_int] * 9 + [ctypes.c_float] * 3 + [_PTR] * 7
                   + [_PTRS, _PTR, ctypes.c_int, _PTR])


@functools.lru_cache(maxsize=None)
def _group_fn():
    """The box solve's C entry point of csrc/admm_group.cu,
    ``tinympc_admm_group``, built and loaded on first use
    (:func:`_group_lib`): :data:`_GROUP_ARGTYPES`, then the stream."""
    fn = _group_lib().tinympc_admm_group
    fn.argtypes = _GROUP_ARGTYPES + [_PTR]
    fn.restype = ctypes.c_int
    return fn


class _GroupFamilyArgs(ctypes.Structure):
    """``GroupFamilyArgs`` of csrc/admm_group.cuh: the six family counts;
    the carried duals of the families that are on and x/u in, the duals
    and x/u out (null on a cold solve, for a family that is off, and x/u
    where no family is on)."""

    _fields_ = ([(n, ctypes.c_int) for n in Families._fields]
                + [(f"{d}_in", _PTR) for d in _FAMILY_DUALS]
                + [("x_in", _PTR), ("u_in", _PTR)]
                + [(f"{d}_out", _PTR) for d in _FAMILY_DUALS]
                + [("x_out", _PTR), ("u_out", _PTR)])


@functools.lru_cache(maxsize=None)
def _group_policy_fn(kind: str):
    """The C entry point of csrc/admm_group.cu for an adaptive-rho
    ("adaptive", "adaptive_c"), consensus or families launch
    (``tinympc_admm_group_adaptive``, ``tinympc_admm_group_consensus``,
    ``tinympc_admm_group_families``): :data:`_GROUP_ARGTYPES`, then its
    arguments (``AdaptArgs``; ``GroupConsensusArgs``;
    ``GroupFamilyArgs`` and ``AdaptArgs``, null at fixed rho), then the
    stream."""
    lib = _group_lib()
    fn = getattr(lib, GROUP_ENTRIES[kind])
    if kind in FAMILY_KINDS:
        args = [ctypes.POINTER(_GroupFamilyArgs),
                ctypes.POINTER(_AdaptArgs)]
    else:
        args = [ctypes.POINTER(_GroupConsensusArgs if kind == "consensus"
                               else _AdaptArgs)]
    fn.argtypes = _GROUP_ARGTYPES + args + [_PTR]
    fn.restype = ctypes.c_int
    return fn


def _group_buffers(x0, N, nx, nu, warm: bool, adaptive: bool = False,
                   consensus: bool = False, fam: Families = NO_FAMILIES):
    """What a launch of csrc/admm_group.cu allocates: the outputs (under
    adaptive rho a 5th residual row, the final rho) and, warm, the carry
    out (under consensus with the pair zc0 / yc0 and x/u; with families
    each family's dual and x/u). No trajectory scratch: its trajectories
    stay in shared memory (but the saved columns past N = 1117,
    :func:`group_saved`)."""
    dev, B = x0.device, x0.shape[0]
    kw = dict(dtype=torch.float32, device=dev)
    buf = dict(out_x=torch.empty((N, B, nx), **kw),
               out_u=torch.empty((N - 1, B, nu), **kw),
               iters=torch.empty(B, dtype=torch.int32, device=dev),
               solved=torch.empty(B, dtype=torch.bool, device=dev),
               res=torch.empty((5 if adaptive else 4, B), **kw))
    if warm:
        shapes = _carry_shapes(N, nx, nu, B, fam, consensus=consensus)
        buf.update({f"carry_{k}": torch.empty(shapes[k], **kw)
                    for k in _GROUP_CARRY_OUT + _group_extra_out(fam,
                                                                 consensus)})
    return buf


# The carry out of csrc/admm_group.cu, in its argument order, and under
# consensus the fields its GroupConsensusArgs writes.
_GROUP_CARRY_OUT = ("vnew", "znew", "v", "z", "g", "y")
_GROUP_CONSENSUS_OUT = ("zc0", "yc0", "x", "u")


def _group_extra_out(fam: Families, consensus: bool) -> Tuple[str, ...]:
    """The carry fields a warm group launch writes past the box's: the
    consensus pair and x/u, or each family's dual and, with any family on,
    x/u."""
    if consensus:
        return _GROUP_CONSENSUS_OUT
    duals = tuple(d for d, n in zip(_FAMILY_DUALS, fam) if n)
    return duals + (("x", "u") if duals else ())


def _launch_group(fn, route, tables, x0, N, nx, nu, carry, max_iter, ct,
                  rho, tol_pri, tol_dua, block_sys=None,
                  adapt: Optional[Adaptive] = None,
                  cons: Optional[Consensus] = None,
                  fam: Families = NO_FAMILIES):
    """Launch csrc/admm_group.cu through its C entry ``fn``
    (:data:`GROUP_ENTRIES`) on the current stream of x0's device, at
    ``route`` (:func:`group_route`: the kind, P, place and cluster): cold
    when ``carry`` is None, else warm; at fixed rho, with ``adapt`` at
    adaptive rho, with ``cons`` under consensus (its group in one block or
    one cluster of blocks), with the families ``fam`` (the families kinds:
    any family, and every problem at (6, 3)); with ``block_sys`` (int32, a
    system for each 128-lane tile) the multi-system launch of a box
    problem. Returns ``(Solution, residuals, carry' or None)``."""
    dev, B = x0.device, x0.shape[0]
    f32 = torch.float32
    _check_arg(x0, (B, nx), f32, dev)
    consensus = cons is not None
    kind, P, place, cluster = route
    families = kind in FAMILY_KINDS
    if not families:
        fam = NO_FAMILIES
    stride = _table_floats(nx, nu, N, fam, adapt, consensus)
    if block_sys is not None:
        if consensus:
            raise ValueError("the multi-system launch takes no consensus")
        _check_arg(block_sys, (-(-B // BLOCK),), torch.int32, dev)
        if tables.numel() % stride:
            raise ValueError("stacked tables must be whole system tables")
    else:
        _check_arg(tables, (stride,), f32, dev)
    warm = carry is not None
    buf = _group_buffers(x0, N, nx, nu, warm, adapt is not None, consensus,
                         fam)
    saved = group_saved(x0, N, P, place, nx, nu)
    ptrs = [None] * 12
    if warm:
        for name, shape in _carry_shapes(N, nx, nu, B, fam,
                                         adapt is not None,
                                         consensus).items():
            _check_arg(getattr(carry, name), shape, f32, dev)
        ptrs = [getattr(carry, k) for k in BOX_CARRY_FIELDS] + [
            buf["carry_" + k] for k in _GROUP_CARRY_OUT]
    adapt_args = cons_args = fam_args = None
    if adapt is not None:
        adapt_args = ctypes.byref(_AdaptArgs(
            int(adapt.apply_c), int(adapt.clip), adapt.rho_min,
            adapt.rho_max, adapt.rho_tol,
            None if carry is None else carry.rho.data_ptr(),
            buf["res"][4].data_ptr(), None, None, None, None))
    if consensus:
        io = [None] * 7 if not warm else [
            carry.u.data_ptr(), carry.x.data_ptr(), carry.yc0.data_ptr()] + [
            buf["carry_" + k].data_ptr() for k in _GROUP_CONSENSUS_OUT]
        cons_args = ctypes.byref(_GroupConsensusArgs(cons.group, cluster,
                                                     cons.rho_c, *io))
    if families:
        ptr = lambda t: None if t is None else t.data_ptr()
        on = any(fam) and warm
        src = lambda k: getattr(carry, k) if warm else None
        dst = lambda k: buf.get("carry_" + k)
        fam_args = ctypes.byref(_GroupFamilyArgs(
            *fam, *(ptr(src(d)) for d in _FAMILY_DUALS),
            ptr(src("x") if on else None), ptr(src("u") if on else None),
            *(ptr(dst(d)) for d in _FAMILY_DUALS),
            ptr(dst("x")), ptr(dst("u"))))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(int(warm), nx, nu, P, place, N, B, max_iter, ct, rho,
                 tol_pri, tol_dua, tables.data_ptr(), x0.data_ptr(),
                 *(buf[k].data_ptr() for k in ("out_x", "out_u", "iters",
                                               "solved", "res")),
                 _ptr_array(ptrs),
                 None if block_sys is None else block_sys.data_ptr(), stride,
                 None if saved is None else saved.data_ptr(),
                 *([fam_args, adapt_args] if families else
                   [a for a in (adapt_args, cons_args) if a is not None]),
                 stream)
    if err != 0:
        raise RuntimeError(f"admm_group kernel launch failed: CUDA error "
                           f"{err}")
    entry_counts[GROUP_ENTRIES[kind]] += 1
    sol = Solution(iter=buf["iters"], solved=buf["solved"], x=buf["out_x"],
                   u=buf["out_u"])
    if not warm:
        return sol, buf["res"], None
    out = {k: buf["carry_" + k] for k in _GROUP_CARRY_OUT
           + _group_extra_out(fam, consensus)}
    if adapt is not None:
        out["rho"] = buf["res"][4:5].clone()
    return sol, buf["res"], FusedCarry(**out)


def _count(kind: str, warm: bool) -> None:
    """One more launch of the instantiation ``kind`` (cold or warm)."""
    name = ("" if kind == "box" else kind + "_") + ("warm_" if warm else "") \
        + "launch_count"
    globals()[name] += 1


def _solve_kernel(tables, x0, N, nx, nu, *, max_iter, ct, rho, tol_pri,
                  tol_dua, fam=NO_FAMILIES, adapt=None, cons=None):
    """The cold solve on the kernel's instantiation for the problem."""
    sol, res, _ = _launch(tables, x0, N, nx, nu, fam, adapt, cons, None,
                          max_iter, ct, rho, tol_pri, tol_dua)
    _count(_instantiation(nx, nu, fam, adapt, cons), False)
    return sol, res


def _solve_kernel_warm(tables, x0, carry: FusedCarry, N, nx, nu, *,
                       max_iter, ct, rho, tol_pri, tol_dua,
                       fam=NO_FAMILIES, adapt=None, cons=None):
    """The warm solve on the kernel's instantiation for the problem."""
    out = _launch(tables, x0, N, nx, nu, fam, adapt, cons, carry, max_iter,
                  ct, rho, tol_pri, tol_dua)
    _count(_instantiation(nx, nu, fam, adapt, cons), True)
    return out


# ------------------------------------------------- many systems, one launch

def check_systems(probs, fleet: bool = False) -> list:
    """The problems of a multi-system solve as a list, checked: the JAX
    package's rules (admm_pallas.py:1362-1378) -- not empty, one spec and
    one settings, one setup rho (the kernel takes one rho a launch), no
    consensus -- and each problem's :func:`fused_supported` checks, all on
    one device. ``fleet`` words the first, second and fourth in the JAX
    package's ``make_fleet_solver``'s terms (fleet.py:79-95). Raises
    ``ValueError``."""
    probs = list(probs)
    if not probs:
        raise ValueError("empty fleet" if fleet else "empty system list")
    spec0, set0 = probs[0].spec, probs[0].settings
    if fleet and spec0.en_consensus:
        raise ValueError(
            "make_fleet_solver takes flat (B, nx) batches; consensus "
            "specs use grouped (n_groups, G, nx) batches -- run each "
            "system's scenario trees through solve_fused directly")
    rho0 = float(probs[0].cache.rho)
    for i, p in enumerate(probs[1:], 1):
        if p.spec != spec0 or p.settings != set0:
            raise ValueError(
                f"fleet system {i} differs from system 0 in spec/settings; "
                "buckets must share the static layout (dims, families, "
                "iteration budget) -- heterogeneity is in the numeric data"
                if fleet else f"system {i} differs in spec/settings")
        if float(p.cache.rho) != rho0:
            raise ValueError(
                f"system {i} has rho {float(p.cache.rho)} != {rho0}; the "
                "kernel takes one rho a launch -- fleets must share the "
                "setup rho")
        if p.device != probs[0].device:
            raise ValueError(f"system {i} is on {p.device}, system 0 on "
                             f"{probs[0].device}")
    if spec0.en_consensus:
        raise ValueError("multi-system launch does not support consensus "
                         "specs yet; use per-bucket solve_fused")
    for p in probs:
        _check(p)
    return probs


class Buckets(NamedTuple):
    """The lanes of a batch by system, for a multi-system solve. ``lanes``
    holds each system's batch lanes in order (empty for a system with
    none). The kernel takes them system-major, each system's lanes padded
    to whole blocks of :data:`BLOCK` with copies of its first lane, so that
    no block mixes systems: padded lane j is batch lane ``gather[j]``,
    block k solves system ``block_sys[k]``, and batch lane ``targets[i]``
    is padded lane ``real[i]``."""

    lanes: Tuple[torch.Tensor, ...]
    gather: torch.Tensor       # (Bp,) int64
    real: torch.Tensor         # (B,) int64
    targets: torch.Tensor      # (B,) int64
    block_sys: torch.Tensor    # (Bp // BLOCK,) int32


def buckets(assignments, n_sys: int, device) -> Buckets:
    """:class:`Buckets` of a host ``(B,)`` array of system indices in
    [0, n_sys), its index tensors on ``device``."""
    assignments = np.asarray(assignments, dtype=np.int64)
    lanes, gather, real, block_sys = [], [], [], []
    start = 0                  # the padded position of the system's lane 0
    for s in range(n_sys):
        idx = np.flatnonzero(assignments == s)
        lanes.append(idx)
        if idx.size == 0:
            continue
        blocks = -(-idx.size // BLOCK)
        real.append(start + np.arange(idx.size))
        gather.append(np.concatenate(
            [idx, np.full(blocks * BLOCK - idx.size, idx[0])]))
        block_sys.append(np.full(blocks, s))
        start += blocks * BLOCK
    as_t = lambda a, dt=torch.int64: torch.as_tensor(
        np.concatenate(a) if a else np.zeros(0), dtype=dt, device=device)
    return Buckets(lanes=tuple(torch.as_tensor(i, device=device)
                               for i in lanes),
                   gather=as_t(gather), real=as_t(real),
                   targets=as_t(lanes), block_sys=as_t(block_sys,
                                                       torch.int32))


def system_tables(probs, Xrefs=None, Urefs=None) -> torch.Tensor:
    """One packed table a system, stacked (n_sys, floats), with the
    references of :func:`with_references`."""
    return with_references(torch.stack([_pack_tables(p, None, None)
                                        for p in probs]), probs[0].spec,
                           Xrefs, Urefs)


def with_references(tables: torch.Tensor, spec, Xrefs=None, Urefs=None
                    ) -> torch.Tensor:
    """Stacked system tables (n_sys, floats) with ``Xrefs`` / ``Urefs``
    written into each system's reference slots: one reference a system (a
    list or tuple, None for zeros), one shared array, or None (the slots
    as they are). ``tables`` itself when both are None, else a copy; the
    rest of each table is not repacked."""
    if Xrefs is None and Urefs is None:
        return tables
    N, nx, nu = spec.N, spec.nx, spec.nu
    n = tables.shape[0]
    out = tables.clone()
    kw = dict(dtype=tables.dtype, device=tables.device)

    def ref(a, shape):
        t = torch.zeros(shape, **kw) if a is None else torch.as_tensor(a,
                                                                       **kw)
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
        return t.reshape(1, -1)

    for name, refs, shape in (("Xref", Xrefs, (N, nx)),
                              ("Uref", Urefs, (N - 1, nu))):
        if refs is None:
            continue
        if isinstance(refs, (list, tuple)):
            if len(refs) != n:
                raise ValueError(f"{len(refs)} references for {n} systems")
            vals = torch.cat([ref(r, shape) for r in refs])
        else:
            vals = ref(refs, shape)
        out[:, _table_slice(name, nx, nu, N)] = vals
    return out


def _lane_tensors(out):
    """The tensors of a ``(Solution, residuals, carry or None)`` output and
    the axis of each that runs over the lanes, in a fixed order."""
    sol, res, carry = out
    items = [(sol.iter, 0), (sol.solved, 0), (sol.x, 1), (sol.u, 1),
             (res, 1)]
    if carry is not None:
        items += [(a, a.ndim - 1) for a in (getattr(carry, k)
                                            for k in CARRY_FIELDS)
                  if a is not None]
    return items


def _rebuild(out, tensors):
    """``out`` with its tensors replaced, in :func:`_lane_tensors`'s
    order."""
    sol, res, carry = out
    it = iter(tensors)
    sol = Solution(iter=next(it), solved=next(it), x=next(it), u=next(it))
    res = next(it)
    if carry is not None:
        carry = FusedCarry(**{k: None if getattr(carry, k) is None
                              else next(it) for k in CARRY_FIELDS})
    return sol, res, carry


def _empty_lanes(t: torch.Tensor, ax: int, B: int) -> torch.Tensor:
    """An empty tensor shaped as ``t`` with B lanes on axis ``ax``."""
    shape = list(t.shape)
    shape[ax] = B
    return torch.empty(shape, dtype=t.dtype, device=t.device)


def merge_lanes(parts, B: int):
    """One batch-order ``(Solution, residuals, carry or None)`` of B lanes
    from outputs of parts of the batch, ``[(lanes, output)]``, each output
    written to its lanes."""
    out = parts[0][1]
    dst = [_empty_lanes(t, ax, B) for t, ax in _lane_tensors(out)]
    for idx, part in parts:
        for d, (t, ax) in zip(dst, _lane_tensors(part)):
            d.index_copy_(ax, idx, t)
    return _rebuild(out, dst)


def _take_lanes(carry: Optional[FusedCarry], idx) -> Optional[FusedCarry]:
    """The lanes ``idx`` of each field of a lane-last carry."""
    if carry is None:
        return None
    return FusedCarry(**{k: None if a is None else a.index_select(
        a.ndim - 1, idx) for k, a in ((k, getattr(carry, k))
                                      for k in CARRY_FIELDS)})


def solve_systems(tables, x0, bk: Buckets, N, nx, nu, carry=None, *,
                  plain=False, **params):
    """The multi-system solve of x0 (B, nx) and, warm, a carry of B lanes,
    each lane with the table of its system (``tables`` (n_sys, floats),
    lanes by :class:`Buckets`); returns ``(Solution, residuals, carry' or
    None)`` in batch order. On a CUDA tensor it is one launch of the
    kernel; on a CPU tensor, or with ``plain``, the plain version runs on
    each system's lanes with that system's table."""
    if x0.device.type == "cpu" or plain:
        return merge_lanes([
            (idx, _solve_plain(tables[s], x0.index_select(0, idx), N, nx, nu,
                               carry=_take_lanes(carry, idx), **params)[:3])
            for s, idx in enumerate(bk.lanes) if idx.numel()], x0.shape[0])
    if x0.device.type != "cuda":
        raise ValueError(f"the multi-system solve runs on cuda or cpu, not "
                         f"{x0.device}")
    return _solve_systems_kernel(tables, x0, bk, N, nx, nu, carry, **params)


def _solve_systems_kernel(tables, x0, bk: Buckets, N, nx, nu, carry=None,
                          **params):
    """:func:`solve_systems` on the kernel: the lanes and carry gathered
    into the padded system-major layout, one multi-system launch, the
    outputs scattered back into batch order."""
    B = x0.shape[0]
    padded = _launch(tables.reshape(-1), x0.index_select(0, bk.gather), N,
                     nx, nu, params["fam"], params["adapt"], params["cons"],
                     _take_lanes(carry, bk.gather), params["max_iter"],
                     params["ct"], params["rho"], params["tol_pri"],
                     params["tol_dua"], block_sys=bk.block_sys)
    _count("multi", carry is not None)
    return _rebuild(padded, [
        _empty_lanes(t, ax, B).index_copy_(ax, bk.targets,
                                           t.index_select(ax, bk.real))
        for t, ax in _lane_tensors(padded)])


def _prepare_multi(probs, x0s, Xrefs, Urefs):
    probs = check_systems(probs)
    x0, params = _x0_params(probs[0], x0s)
    n_sys, B = len(probs), x0.shape[0]
    if B % n_sys:
        raise ValueError(f"batch {B} must split into {n_sys} equal system "
                         "buckets")
    bk = buckets(np.repeat(np.arange(n_sys), B // n_sys), n_sys, x0.device)
    return system_tables(probs, Xrefs, Urefs), x0, bk, probs[0].spec, params


def solve_fused_multi(probs, x0s, Xrefs=None, Urefs=None):
    """Heterogeneous multi-system cold solve in one launch of the fused
    kernel (the JAX package's ``solve_fused_multi``; its ``tile`` and
    ``interpret`` have no counterpart here).

    ``x0s`` is ``(n_sys * per, nx)``, system-major: system s owns rows
    ``[s*per, (s+1)*per)``. Every problem must share spec, settings and the
    setup rho, and none may use consensus; ``Xrefs`` / ``Urefs`` are one
    reference a system (a list or tuple), one shared array, or None.
    Each system's lanes are padded to whole blocks inside the launch, so
    any ``per`` is taken. Returns ``(Solution, residuals)`` as
    :func:`solve_fused` does; each system's lanes are those of
    :func:`solve_fused` on its own rows. On CPU tensors it runs
    :func:`solve_fused_multi_reference`."""
    tables, x0, bk, spec, params = _prepare_multi(probs, x0s, Xrefs, Urefs)
    return solve_systems(tables, x0, bk, spec.N, spec.nx, spec.nu,
                         **params)[:2]


def solve_fused_multi_reference(probs, x0s, Xrefs=None, Urefs=None):
    """The multi-system launch's plain PyTorch version, on the problems'
    device: :func:`solve_fused_reference`'s solve of each system's rows
    with that system's table. Returns what :func:`solve_fused_multi`
    returns."""
    tables, x0, bk, spec, params = _prepare_multi(probs, x0s, Xrefs, Urefs)
    return solve_systems(tables, x0, bk, spec.N, spec.nx, spec.nu,
                         plain=True, **params)[:2]
