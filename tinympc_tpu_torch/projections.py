"""Constraint projections (counterpart of ``tinympc_tpu.projections``).

Only the box projection is ported so far; the SOC and hyperplane
projections come with the extra constraint families.
"""
from __future__ import annotations

import torch


def project_box(s, smin, smax):
    """Clamp to [smin, smax] (admm.cpp:92,97:
    ``max.cwiseMin(min.cwiseMax(s))``). NaN propagates, as in the JAX
    package's ``jnp.minimum``/``jnp.maximum``."""
    return torch.minimum(smax, torch.maximum(smin, s))
