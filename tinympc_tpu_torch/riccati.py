"""Infinite-horizon Riccati cache (counterpart of ``tinympc_tpu.riccati``).

Parity note (kept deliberately, as in the JAX package and the reference):
``setup`` stores ``Qdiag = diag(Q) + rho`` and hands that once-augmented
diagonal to :func:`precompute_cache`, which adds ``rho*I`` again
(reference tiny_api.cpp:117 and :317-318). The cache therefore solves with
``Q + 2*rho*I`` while the linear cost uses ``Q + rho*I``.
"""
from __future__ import annotations

import torch

import torch.autograd.forward_ad as fwAD

from .types import Cache

RICCATI_TOL = 1e-5        # tiny_api.cpp:340
RICCATI_MAX_ITERS = 1000  # tiny_api.cpp:335


def riccati_fixed_point(A, B, Qaug2, Raug2, rho, tol=RICCATI_TOL,
                        max_iters=RICCATI_MAX_ITERS):
    """Iterate ``Kinf = (R + B'PB)^-1 B'PA``, ``Pinf = Q + A'P(A - BK)``
    until ``max|dKinf| < tol``, starting from ``P = rho*I``
    (tiny_api.cpp:330-349). Returns (Kinf, Pinf, iters).

    The convergence test reads one scalar per iteration back to the host;
    this runs once per problem set-up."""
    nx, nu = A.shape[-1], B.shape[-1]
    P = rho * torch.eye(nx, dtype=A.dtype, device=A.device)
    K = torch.zeros((nu, nx), dtype=A.dtype, device=A.device)
    Kprev = torch.full_like(K, float("inf"))   # do-while: first step runs
    iters = 0
    while iters < max_iters and bool(torch.max(torch.abs(K - Kprev)) >= tol):
        BtP = B.T @ P
        Knew = torch.linalg.solve(Raug2 + BtP @ B, BtP @ A)
        P = Qaug2 + A.T @ P @ (A - B @ Knew)
        K, Kprev = Knew, K
        iters += 1
    return K, P, iters


def _cache_terms(A, B, f, Qaug2, Raug2, rho, tol, max_iters):
    Kinf, Pinf, _ = riccati_fixed_point(A, B, Qaug2, Raug2, rho, tol,
                                        max_iters)
    Quu_inv = torch.linalg.inv(Raug2 + B.T @ Pinf @ B)   # tiny_api.cpp:352
    AmBKt = (A - B @ Kinf).T                             # tiny_api.cpp:353
    APf = AmBKt @ (Pinf @ f)                             # tiny_api.cpp:356
    BPf = B.T @ (Pinf @ f)                               # tiny_api.cpp:357
    return Kinf, Pinf, Quu_inv, AmBKt, APf, BPf


def precompute_cache(A, B, f, Qdiag_aug, Rdiag_aug, rho, *,
                     tol=RICCATI_TOL, max_iters=RICCATI_MAX_ITERS) -> Cache:
    """Build the solver cache from once-augmented cost diagonals
    ``Qdiag_aug = diag(Q) + rho`` and ``Rdiag_aug = diag(R) + rho``; a
    second ``rho*I`` is added here (tiny_api.cpp:317-318)."""
    dtype, device = A.dtype, A.device
    rho = torch.as_tensor(rho, dtype=dtype, device=device)
    Qaug2 = torch.diag(Qdiag_aug) + rho * torch.eye(
        A.shape[-1], dtype=dtype, device=device)
    Raug2 = torch.diag(Rdiag_aug) + rho * torch.eye(
        B.shape[-1], dtype=dtype, device=device)
    Kinf, Pinf, Quu_inv, AmBKt, APf, BPf = _cache_terms(
        A, B, f, Qaug2, Raug2, rho, tol, max_iters)
    return Cache(rho=rho, Kinf=Kinf, Pinf=Pinf, Quu_inv=Quu_inv,
                 AmBKt=AmBKt.contiguous(), APf=APf, BPf=BPf,
                 C1=Quu_inv, C2=AmBKt.contiguous())  # tiny_api.cpp:375-376


def compute_sensitivities(A, B, f, Qdiag_user, Rdiag_user, rho, *,
                          tol=1e-10, max_iters=10_000):
    """d{Kinf, Pinf, Quu_inv (C1), AmBKt (C2)}/drho by forward-mode
    differentiation (dual numbers) through the Riccati fixed point, for
    any system (the reference hard-codes the quadrotor's tables,
    tiny_api.cpp:489-531).

    ``Qdiag_user``/``Rdiag_user`` are the raw cost diagonals: the double
    rho augmentation, which itself depends on rho, happens inside, so its
    derivative is captured. The tight tolerance makes the derivative of the
    truncated iteration agree with the fixed point's; in float32 it may
    never be met, and the iteration then runs ``max_iters`` steps, as in
    the JAX package. It runs in the inputs' dtype on their device; on the
    card the stopping test reads one scalar back to the host a step, once
    per problem set-up."""
    dtype, device = A.dtype, A.device
    A, B, f, Qdiag_user, Rdiag_user = (
        torch.as_tensor(a, dtype=dtype, device=device)
        for a in (A, B, f, Qdiag_user, Rdiag_user))
    eye = lambda n: torch.eye(n, dtype=dtype, device=device)
    with fwAD.dual_level():
        r = fwAD.make_dual(torch.as_tensor(rho, dtype=dtype, device=device),
                           torch.ones((), dtype=dtype, device=device))
        Qaug2 = torch.diag(Qdiag_user) + 2.0 * r * eye(A.shape[-1])
        Raug2 = torch.diag(Rdiag_user) + 2.0 * r * eye(B.shape[-1])
        terms = _cache_terms(A, B, f, Qaug2, Raug2, r, tol, max_iters)[:4]
        return tuple(fwAD.unpack_dual(t).tangent for t in terms)
