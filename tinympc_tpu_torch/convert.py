"""Carry a configured problem across packages as plain numpy.

:func:`problem_to_numpy` reads the fields of a configured problem -- this
port's :class:`~tinympc_tpu_torch.types.TinyProblem`, or any object with the
same attribute names, such as the JAX package's ``TinyProblem`` -- into a
dict of numpy arrays and plain values. :func:`problem_from_numpy` builds this
port's problem from such a dict on a given device and dtype, without
recomputing the Riccati cache, so both packages then solve the very same
problem.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import Cache, ConstraintData, ProblemSpec, Settings, TinyProblem

PROBLEM_KEYS = ("A", "B", "f", "Qdiag", "Rdiag")
CACHE_KEYS = ("rho", "Kinf", "Pinf", "Quu_inv", "AmBKt", "APf", "BPf")
BOX_KEYS = ("x_min", "x_max", "u_min", "u_max")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def problem_to_numpy(prob) -> dict:
    """Problem arrays (rho-augmented ``Qdiag``/``Rdiag``), cache, box tables,
    and the spec and settings fields as dicts."""
    d = {k: _np(getattr(prob, k)) for k in PROBLEM_KEYS}
    d.update({k: _np(getattr(prob.cache, k)) for k in CACHE_KEYS})
    d.update({k: _np(getattr(prob.cons, k)) for k in BOX_KEYS})
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

    cache = Cache(**{k: t(k) for k in CACHE_KEYS})
    cache = dataclasses.replace(cache, C1=cache.Quu_inv, C2=cache.AmBKt)
    spec = dict(d["spec"])
    for k in ("state_cones", "input_cones"):
        spec[k] = tuple(tuple(int(v) for v in c) for c in spec.get(k, ()))
    return TinyProblem(
        **{k: t(k) for k in PROBLEM_KEYS},
        cache=cache,
        cons=ConstraintData(**{k: t(k) for k in BOX_KEYS}),
        spec=ProblemSpec(**spec),
        settings=Settings(**d["settings"]),
    )
