"""Constraint projections (counterpart of ``tinympc_tpu.projections``).

Branch-free ``torch.where`` forms over whole (horizon, *batch, dim)
tensors. Every sum over the feature axis is taken in feature order, one
add at a time from zero, as the CUDA kernel takes it, so that the fused
kernel and its plain version round alike. The deviations of the JAX
package from the reference hold here too: ``project_soc`` takes any cone
dimension (the reference aborts for dim != 3, admm.cpp:53) and stays in
the working dtype (the reference truncates the cone norm to float32,
admm.cpp:39-42).
"""
from __future__ import annotations

import torch


def project_box(s, smin, smax):
    """Clamp to [smin, smax] (admm.cpp:92,97:
    ``max.cwiseMin(min.cwiseMax(s))``). NaN propagates, as in the JAX
    package's ``jnp.minimum``/``jnp.maximum``."""
    return torch.minimum(smax, torch.maximum(smin, s))


def sum_last(t):
    """Sum over the last axis in index order, starting from zero."""
    acc = t.new_zeros(t.shape[:-1])
    for j in range(t.shape[-1]):
        acc = acc + t[..., j]
    return acc


def project_soc(s, mu):
    """Second-order-cone projection on the last axis (admm.cpp:39-60).

    Three cases with ``u0 = mu * s[-1]``, ``a = ||s[:-1]||``: below
    (``a <= -u0``) -> 0; inside (``a <= u0``) -> s; outside ->
    ``0.5*(1 + u0/a) * [s[:-1]; a/mu]``. ``a`` is replaced by 1 where it is
    0, so the apex gives no NaN."""
    u0 = s[..., -1] * mu
    v = s[..., :-1]
    a = torch.sqrt(sum_last(v * v))
    below = a <= -u0
    inside = a <= u0
    safe_a = torch.where(a > 0, a, torch.ones_like(a))
    scale = 0.5 * (1.0 + u0 / safe_a)
    outside = scale[..., None] * torch.cat([v, (a / mu)[..., None]], dim=-1)
    return torch.where(below[..., None], torch.zeros_like(s),
                       torch.where(inside[..., None], s, outside))


def project_hyperplane_if_violated(z, a, b, asq=None):
    """Project z onto {z : a.z = b} only where a.z > b (admm.cpp:70-73 with
    the violation gate of admm.cpp:154). ``a`` broadcasts against
    ``z[..., :]``; ``b`` and ``asq`` (||a||^2, summed here when None)
    against ``z[..., 0]``."""
    val = sum_last(z * a)
    dist = (val - b) / (sum_last(a * a) if asq is None else asq)
    proj = z - dist[..., None] * a
    return torch.where((val > b)[..., None], proj, z)
