"""Heterogeneous fleets in one launch of the fused kernel (counterpart of
``tinympc_tpu.kernels.fleet``).

A fleet is many problems over a few systems: each problem (a lane) names
its system in a host ``(B,)`` assignment array. :func:`make_fleet_solver`
builds a reusable solver that runs the whole fleet in one multi-system
launch (:func:`~.admm_fused.solve_fused_multi`'s launch: box-only
problems at fixed rho on ``csrc/admm_group.cu``, every other on
``csrc/admm_fused.cu``): the lanes are gathered into the system-major
layout, each system's lanes padded to whole tiles of 128 lanes so that a
block (128 problems, or a thread group's 8, which divide the tile) loads
one system's table, and the results scattered back into fleet order. The JAX
package dispatches one launch a system bucket instead, because its
single-launch variant measured slower on the TPU, where selecting a tile's
system defeated Mosaic's hoisting; on the GPU every block loads its own
table into shared memory anyway, so the system index only moves that
load's source, and a 16-system fleet fills the card in one launch instead
of 16 launches of 16 blocks.

The systems' tables are packed once, when the solver is built; a tick
writes only the references it is given into a copy of them. The gather and
scatter indices are built once for each assignment pattern and kept on the
device (:func:`~.admm_fused.buckets`); a tick with a known pattern builds
no index. Each system's lanes are those of
:func:`~.admm_fused.solve_fused` (warm: ``solve_fused_warm``) on the
gathered batch of that system. On CPU tensors the solver runs the plain
version on each system's lanes.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..types import TinyProblem
from .admm_fused import (_carry_tensors, _x0_params, buckets, check_systems,
                         solve_systems, system_tables, with_references)


def make_fleet_solver(probs: Sequence[TinyProblem], *, warm: bool = False):
    """Build a reusable heterogeneous-fleet solver.

    ``probs``: one configured problem a system. They share the static
    layout (spec: dims and families; settings) and the setup rho, the
    kernel's one rho a launch (the JAX package documents the rho rule,
    fleet.py:76-77; here it is checked); they differ in their numbers (A,
    B, f, costs, bounds, cache). Consensus specs are refused. Any family
    and adaptive rho are taken (5 residual rows).

    Returns ``solve(assignments, x0s, Xref=None, Uref=None) -> (Solution,
    residuals)``, ``assignments`` a host ``(B,)`` integer array mapping
    each problem to its system and ``x0s`` ``(B, nx)``; per-system
    references may be passed as sequences (one a system) or as shared
    arrays. With ``warm=True`` it is the receding-horizon variant,
    ``solve(assignments, x0s, carry, Xref=None, Uref=None) -> (Solution,
    residuals, carry')``, with a fleet-order :class:`~.admm_fused.
    FusedCarry` (start from ``init_carry(probs[0], B)``) and per-lane freeze
    exactly as :func:`~.admm_fused.solve_fused_warm`'s, each system's lanes
    those of its own warm sequence."""
    probs = check_systems(probs, fleet=True)
    n_sys = len(probs)
    spec = probs[0].spec
    tables = system_tables(probs)   # packed once; a tick writes its refs
    patterns = {}              # (device, assignment bytes) -> Buckets

    def solve(assignments, x0s, *args, Xref=None, Uref=None):
        assignments = np.asarray(assignments)
        x0, params = _x0_params(probs[0], x0s)
        B = x0.shape[0]
        if assignments.shape != (B,):
            raise ValueError(f"assignments must be ({B},); got "
                             f"{assignments.shape}")
        if not np.issubdtype(assignments.dtype, np.integer):
            raise ValueError("assignments must be integers")
        if assignments.min() < 0 or assignments.max() >= n_sys:
            raise ValueError(f"assignments out of range [0, {n_sys})")
        carry = None
        if warm:
            if not args:
                raise ValueError(
                    "warm fleet solver takes (assignments, x0s, carry, "
                    "...); start from init_carry(probs[0], B)")
            carry, args = _carry_tensors(probs[0], args[0], B), args[1:]
        if args:
            # Positional (Xref[, Uref]) for parity with the cold form.
            Xref = args[0]
            if len(args) > 1:
                Uref = args[1]
        key = (str(x0.device), assignments.astype(np.int64).tobytes())
        if key not in patterns:
            patterns[key] = buckets(assignments, n_sys, x0.device)
        out = solve_systems(with_references(tables, spec, Xref, Uref), x0,
                            patterns[key], spec.N, spec.nx, spec.nu, carry,
                            **params)
        return out if warm else out[:2]

    return solve


def solve_fused_fleet(probs: Sequence[TinyProblem], assignments, x0s,
                      Xref=None, Uref=None):
    """One-shot cold fleet solve over :func:`make_fleet_solver`; for
    repeated ticks keep the factory's closure, which keeps each assignment
    pattern's indices."""
    return make_fleet_solver(probs)(assignments, x0s, Xref, Uref)
