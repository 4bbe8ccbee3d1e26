"""Carry a configured problem across packages as plain numpy.

:func:`problem_to_numpy` reads the fields of a configured problem -- this
port's :class:`~tinympc_tpu_torch.types.TinyProblem`, or any object with the
same attribute names, such as the JAX package's ``TinyProblem`` -- into a
dict of numpy arrays and plain values. :func:`problem_from_numpy` builds this
port's problem from such a dict on a given device and dtype, without
recomputing the Riccati cache, so both packages then solve the very same
problem. The cache may be per problem (the final cache of an adaptive
solve, leaves with a leading batch axis), and it carries the rho
sensitivities, the C1/C2 matrices and the consensus step-0 gains when
present.

:func:`carry_to_numpy` / :func:`carry_from_numpy` do the same for a warm
carry (the port's :class:`~tinympc_tpu_torch.kernels.FusedCarry` or the JAX
package's, whose fields have the same names and lane-last layout), and
:func:`state_to_numpy` / :func:`state_from_numpy` for a warm solver state
(the same (N, *b, nx) layout in both packages), so a warm sequence or a
closed loop can start from the other package's workspace. The fields of
constraint families that are off (None) are left out of the dicts, so a
box-only dict holds the box fields alone.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .kernels.admm_fused import BOX_CARRY_FIELDS, CARRY_FIELDS, FusedCarry
from .types import (Cache, ConstraintData, ProblemSpec, Settings,
                    SolverState, TinyProblem)

PROBLEM_KEYS = ("A", "B", "f", "Qdiag", "Rdiag")
CACHE_KEYS = ("rho", "Kinf", "Pinf", "Quu_inv", "AmBKt", "APf", "BPf")
# Cache fields carried when present: C1/C2 (which the adaptive-rho Taylor
# update moves apart from Quu_inv/AmBKt), the rho sensitivities and the
# consensus step-0 gains.
CACHE_EXTRA_KEYS = ("C1", "C2", "dKinf_drho", "dPinf_drho", "dC1_drho",
                    "dC2_drho", "Kinf0", "Quu0_inv")
BOX_KEYS = ("x_min", "x_max", "u_min", "u_max")
# Constraint tables of the other families, carried when present.
FAMILY_KEYS = ("cx", "cu", "Alin_x", "blin_x", "Alin_u", "blin_u",
               "tv_Alin_x", "tv_blin_x", "tv_Alin_u", "tv_blin_u")
# Solver-state fields: those every state has, then the optional family
# fields, carried when present.
STATE_KEYS = tuple(f.name for f in dataclasses.fields(SolverState)
                   if f.default is dataclasses.MISSING)
FAMILY_STATE_KEYS = tuple(f.name for f in dataclasses.fields(SolverState)
                          if f.default is not dataclasses.MISSING)
_STATE_INT = {"iter": torch.int32, "status": torch.int32,
              "solved": torch.bool}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _present(obj, keys):
    """The fields of ``obj`` among ``keys`` that are not None, as numpy."""
    return {k: _np(getattr(obj, k)) for k in keys
            if getattr(obj, k, None) is not None}


def problem_to_numpy(prob) -> dict:
    """Problem arrays (rho-augmented ``Qdiag``/``Rdiag``), cache, box tables,
    the tables of the other families that are present, and the spec and
    settings fields as dicts."""
    d = {k: _np(getattr(prob, k)) for k in PROBLEM_KEYS}
    d.update({k: _np(getattr(prob.cache, k)) for k in CACHE_KEYS})
    d.update(_present(prob.cache, CACHE_EXTRA_KEYS))
    d.update({k: _np(getattr(prob.cons, k)) for k in BOX_KEYS})
    d.update(_present(prob.cons, FAMILY_KEYS))
    d["spec"] = {f.name: getattr(prob.spec, f.name)
                 for f in dataclasses.fields(ProblemSpec)}
    d["settings"] = {f.name: getattr(prob.settings, f.name)
                     for f in dataclasses.fields(Settings)}
    return d


def problem_from_numpy(d: dict, device, dtype=torch.float32) -> TinyProblem:
    """This port's problem from :func:`problem_to_numpy`'s dict, on
    ``device`` in ``dtype``. Raises ``KeyError`` for a missing entry."""
    device = torch.device(device)

    def t(k):
        return torch.as_tensor(np.array(d[k]), dtype=dtype, device=device)

    cache = Cache(**{k: t(k) for k in CACHE_KEYS + CACHE_EXTRA_KEYS
                     if k in d or k in CACHE_KEYS})
    cache = dataclasses.replace(
        cache, C1=cache.Quu_inv if cache.C1 is None else cache.C1,
        C2=cache.AmBKt if cache.C2 is None else cache.C2)
    spec = dict(d["spec"])
    for k in ("state_cones", "input_cones"):
        spec[k] = tuple(tuple(int(v) for v in c) for c in spec.get(k, ()))
    return TinyProblem(
        **{k: t(k) for k in PROBLEM_KEYS},
        cache=cache,
        cons=ConstraintData(**{k: t(k) for k in BOX_KEYS + FAMILY_KEYS
                               if k in d or k in BOX_KEYS}),
        spec=ProblemSpec(**spec),
        settings=Settings(**d["settings"]),
    )


def carry_to_numpy(carry) -> dict:
    """The fields of a warm carry (lane-last) as numpy arrays: the box
    fields (vnew, znew, g, y, v, z), and the family duals, x/u and the
    per-lane rho where present."""
    d = {k: _np(getattr(carry, k)) for k in BOX_CARRY_FIELDS}
    d.update(_present(carry, CARRY_FIELDS[len(BOX_CARRY_FIELDS):]))
    return d


def carry_from_numpy(d: dict, device) -> FusedCarry:
    """This port's float32 carry from :func:`carry_to_numpy`'s dict, on
    ``device``. Raises ``KeyError`` for a missing box field."""
    return FusedCarry(**{
        k: torch.as_tensor(np.array(d[k]), dtype=torch.float32,
                           device=torch.device(device))
        for k in CARRY_FIELDS if k in d or k in BOX_CARRY_FIELDS})


def state_to_numpy(state) -> dict:
    """The fields of this port's :class:`SolverState`, read from ``state``
    (this port's, or the JAX package's), as numpy: every field a state
    has, and the family fields where present."""
    d = {k: _np(getattr(state, k)) for k in STATE_KEYS}
    d.update(_present(state, FAMILY_STATE_KEYS))
    return d


def state_from_numpy(d: dict, device, dtype=torch.float32) -> SolverState:
    """This port's solver state from :func:`state_to_numpy`'s dict, on
    ``device``: iterates and residuals in ``dtype``, iteration counts and
    status as int32, solved flags as bool."""
    device = torch.device(device)
    return SolverState(**{
        k: torch.as_tensor(np.array(d[k]), dtype=_STATE_INT.get(k, dtype),
                           device=device)
        for k in STATE_KEYS + FAMILY_STATE_KEYS
        if k in d or k in STATE_KEYS})
