"""User-facing functional API (counterpart of ``tinympc_tpu.api``).

    prob = setup(A, B, Q, R, rho=5.0, N=10)          # tiny_setup, on cuda
    prob = with_bounds(prob, x_min=-5, x_max=5, u_min=-0.5, u_max=0.5)
    prob = with_cones(prob, state_cones=[(0, 3, 0.25)])   # optional families
    prob = with_settings(prob, max_iter=100, check_termination=25)
    sol, res = kernels.solve_fused(prob, Xref, None, x0s)
    prob = with_settings(prob, adaptive_rho=True)     # attaches d*/drho
    prob = with_consensus(prob, rho_c=100.0)   # scenario groups, x0s (ng, G, nx)

Problems live on one device, given explicitly. With no ``device`` argument
:func:`setup` places the problem on ``cuda`` and raises when there is no
GPU; it never falls back to the CPU. Pass ``device="cpu"`` to run the plain
PyTorch path on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .riccati import compute_sensitivities, precompute_cache
from .types import ConstraintData, ProblemSpec, Settings, SolverState, \
    TinyProblem
from .types import init_state as _init_state_spec


def _resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``, which must
    exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the host")
        return torch.device("cuda")
    return torch.device(device)


def _default_dtype(A) -> torch.dtype:
    """The dtype of ``A`` when it is float32 or float64, else float32."""
    dt = A.dtype if isinstance(A, torch.Tensor) else \
        torch.from_numpy(np.asarray(A)).dtype
    return dt if dt in (torch.float32, torch.float64) else torch.float32


def _as_tensor(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a) if not isinstance(a, torch.Tensor)
                           else a, dtype=dtype, device=device)


def _as_diag(M, dtype, device) -> torch.Tensor:
    """Accept a diagonal vector or a full matrix; full matrices contribute
    only their diagonal, exactly like tiny_setup (tiny_api.cpp:117-118)."""
    M = _as_tensor(M, dtype, device)
    return torch.diagonal(M).clone() if M.ndim == 2 else M


def setup(A, B, Q, R, rho, N, f=None, *, settings: Settings = Settings(),
          dtype=None, device=None) -> TinyProblem:
    """Build a problem and its Riccati cache (reference tiny_setup,
    tiny_api.cpp:21-147) on ``device`` (default ``cuda``)."""
    device = _resolve_device(device)
    if dtype is None:
        dtype = _default_dtype(A)
    A = _as_tensor(A, dtype, device)
    B = _as_tensor(B, dtype, device)
    nx, nu = B.shape
    f = torch.zeros(nx, dtype=dtype, device=device) if f is None \
        else _as_tensor(f, dtype, device).reshape(nx)
    Qdiag = _as_diag(Q, dtype, device)
    Rdiag = _as_diag(R, dtype, device)
    rho = torch.as_tensor(rho, dtype=dtype, device=device)

    # work->Q = (Q + rho*I).diagonal() (tiny_api.cpp:117-118)
    Qdiag_aug = Qdiag + rho
    Rdiag_aug = Rdiag + rho
    cache = precompute_cache(A, B, f, Qdiag_aug, Rdiag_aug, rho)

    spec = ProblemSpec(nx=nx, nu=nu, N=N)
    # Bounds default to +-inf (identity projection) rather than the
    # reference's uninitialised empty matrices.
    inf = float("inf")
    kw = dict(dtype=dtype, device=device)
    cons = ConstraintData(
        x_min=torch.full((N, nx), -inf, **kw),
        x_max=torch.full((N, nx), inf, **kw),
        u_min=torch.full((N - 1, nu), -inf, **kw),
        u_max=torch.full((N - 1, nu), inf, **kw),
    )
    prob = TinyProblem(A=A, B=B, f=f, Qdiag=Qdiag_aug, Rdiag=Rdiag_aug,
                       cache=cache, cons=cons, spec=spec, settings=settings)
    if settings.adaptive_rho and cache.dKinf_drho is None:
        prob = with_sensitivities(prob)
    return prob


def _bcast(v, shape, prob: TinyProblem) -> torch.Tensor:
    v = _as_tensor(v, prob.dtype, prob.device)
    return torch.broadcast_to(v, shape).contiguous()


def with_bounds(prob: TinyProblem, x_min=None, x_max=None, u_min=None,
                u_max=None, enable: bool = True) -> TinyProblem:
    """Box constraints (tiny_set_bound_constraints, tiny_api.cpp:149-174).
    Scalars and (nx,) rows broadcast over the horizon."""
    spec = prob.spec
    xs, us = (spec.N, spec.nx), (spec.N - 1, spec.nu)
    c = prob.cons
    cons = dataclasses.replace(
        c,
        x_min=_bcast(x_min, xs, prob) if x_min is not None else c.x_min,
        x_max=_bcast(x_max, xs, prob) if x_max is not None else c.x_max,
        u_min=_bcast(u_min, us, prob) if u_min is not None else c.u_min,
        u_max=_bcast(u_max, us, prob) if u_max is not None else c.u_max,
    )
    spec = dataclasses.replace(spec, en_state_bound=enable,
                               en_input_bound=enable)
    return prob.replace(cons=cons, spec=spec)


def with_cones(prob: TinyProblem,
               state_cones: Sequence[Tuple[int, int, float]] = (),
               input_cones: Sequence[Tuple[int, int, float]] = (),
               enable: bool = True) -> TinyProblem:
    """Second-order cones as (start, dim, mu) triples
    (tiny_set_cone_constraints, tiny_api.cpp:176-208; layout
    types.hpp:124-131). Any cone dimension is taken. ``enable=False``
    configures the cones but leaves them off, as the reference's rocket
    example does."""
    kw = dict(dtype=prob.dtype, device=prob.device)
    sc = tuple((int(s), int(d)) for s, d, _ in state_cones)
    ic = tuple((int(s), int(d)) for s, d, _ in input_cones)
    cons = dataclasses.replace(
        prob.cons,
        cx=torch.tensor([float(m) for _, _, m in state_cones], **kw)
        if state_cones else None,
        cu=torch.tensor([float(m) for _, _, m in input_cones], **kw)
        if input_cones else None,
    )
    spec = dataclasses.replace(
        prob.spec, state_cones=sc, input_cones=ic,
        en_state_soc=enable and bool(sc), en_input_soc=enable and bool(ic))
    return prob.replace(cons=cons, spec=spec)


def with_linear_constraints(prob: TinyProblem, Alin_x=None, blin_x=None,
                            Alin_u=None, blin_u=None,
                            enable: bool = True) -> TinyProblem:
    """Static hyperplane constraints a.x <= b
    (tiny_set_linear_constraints, tiny_api.cpp:210-252). A family left out
    is switched off."""
    dt, dev = prob.dtype, prob.device
    upd = {}
    nsl = nil = 0
    if Alin_x is not None:
        Alin_x = torch.atleast_2d(_as_tensor(Alin_x, dt, dev))
        nsl = Alin_x.shape[0]
        upd.update(Alin_x=Alin_x,
                   blin_x=_as_tensor(blin_x, dt, dev).reshape(nsl))
    if Alin_u is not None:
        Alin_u = torch.atleast_2d(_as_tensor(Alin_u, dt, dev))
        nil = Alin_u.shape[0]
        upd.update(Alin_u=Alin_u,
                   blin_u=_as_tensor(blin_u, dt, dev).reshape(nil))
    spec = dataclasses.replace(
        prob.spec, num_state_linear=nsl, num_input_linear=nil,
        en_state_linear=enable and nsl > 0,
        en_input_linear=enable and nil > 0)
    return prob.replace(cons=dataclasses.replace(prob.cons, **upd), spec=spec)


def with_tv_linear_constraints(prob: TinyProblem, tv_Alin_x=None,
                               tv_blin_x=None, tv_Alin_u=None, tv_blin_u=None,
                               enable: bool = True) -> TinyProblem:
    """Time-varying hyperplanes (tiny_set_tv_linear_constraints,
    tiny_api.cpp:254-304). Natural layout: ``tv_Alin_x`` is (N, S, nx) and
    ``tv_blin_x`` is (N, S); :func:`tv_from_stacked` converts the
    reference's stacked ((S*N) x nx) / (S x N) arrays."""
    dt, dev = prob.dtype, prob.device
    N = prob.spec.N
    upd = {}
    ns = ni = 0
    if tv_Alin_x is not None:
        tv_Alin_x = _as_tensor(tv_Alin_x, dt, dev)
        ns = tv_Alin_x.shape[1]
        upd.update(tv_Alin_x=tv_Alin_x,
                   tv_blin_x=_as_tensor(tv_blin_x, dt, dev).reshape(N, ns))
    if tv_Alin_u is not None:
        tv_Alin_u = _as_tensor(tv_Alin_u, dt, dev)
        ni = tv_Alin_u.shape[1]
        upd.update(tv_Alin_u=tv_Alin_u,
                   tv_blin_u=_as_tensor(tv_blin_u, dt, dev).reshape(N - 1,
                                                                   ni))
    spec = dataclasses.replace(
        prob.spec, num_tv_state_linear=ns, num_tv_input_linear=ni,
        en_tv_state_linear=enable and ns > 0,
        en_tv_input_linear=enable and ni > 0)
    return prob.replace(cons=dataclasses.replace(prob.cons, **upd), spec=spec)


def tv_from_stacked(A_stacked, b_stacked):
    """Convert the reference's stacked tv layout (types.hpp:170-173): A
    ((S*T) x n) with row (S*t + k) and b (S x T) -> (T, S, n), (T, S), as
    numpy arrays."""
    A_stacked = np.asarray(A_stacked)
    b_stacked = np.asarray(b_stacked)
    S, T = b_stacked.shape
    return A_stacked.reshape(T, S, -1), b_stacked.T.copy()


_CONSENSUS_ADAPTIVE = ("consensus is not compatible with adaptive_rho (the "
                       "Taylor cache update does not track the consensus "
                       "step-0 gains); pick one")


def with_consensus(prob: TinyProblem, enable: bool = True,
                   axis_name: Optional[str] = None,
                   rho_c: Optional[float] = None) -> TinyProblem:
    """Scenario-tree consensus ADMM on the first input: every problem of a
    scenario group (the last batch axis) is driven to a common u[0].

    ``rho_c`` is the consensus penalty weight (default: the problem's rho).
    The prox is exact: the consensus slack touches u[0] only, so its
    rho_c I term changes nothing but the first backward and forward step
    under the stationary cost-to-go Pinf, and this builder bakes that
    step's gain pair ``Cache.Quu0_inv`` / ``Kinf0`` into the cache.
    ``axis_name`` (groups across a named mesh axis) is recorded in the
    settings, and the solvers refuse it until the multi-GPU ``shard.py``
    is ported. Refuses adaptive rho."""
    if enable and prob.settings.adaptive_rho:
        raise ValueError(_CONSENSUS_ADAPTIVE)
    spec = dataclasses.replace(prob.spec, en_consensus=enable)
    settings = dataclasses.replace(
        prob.settings, consensus_axis_name=axis_name,
        consensus_rho=None if rho_c is None else float(rho_c))
    prob = prob.replace(spec=spec, settings=settings)
    if enable:
        prob = prob.replace(cache=_bake_consensus_gains(prob, rho_c))
    return prob


def _bake_consensus_gains(prob: TinyProblem, rho_c):
    """The cache with the consensus step-0 gain pair, in the problem's dtype
    on its device: Quu0_inv = (R1 + rho_c I + B'Pinf B)^-1 and
    Kinf0 = Quu0_inv B'Pinf A, with R1 the Rdiag the Riccati iteration saw
    (setup's once-augmented Rdiag plus the second rho I,
    tiny_api.cpp:317-318)."""
    c, nu = prob.cache, prob.spec.nu
    kw = dict(dtype=prob.dtype, device=prob.device)
    rc = c.rho if rho_c is None else torch.as_tensor(rho_c, **kw)
    eye = torch.eye(nu, **kw)
    Raug2 = torch.diag(prob.Rdiag) + c.rho * eye
    BtP = prob.B.T @ c.Pinf
    Quu0_inv = torch.linalg.inv(Raug2 + rc * eye + BtP @ prob.B)
    return dataclasses.replace(c, Kinf0=Quu0_inv @ (BtP @ prob.A),
                               Quu0_inv=Quu0_inv)


def with_settings(prob: TinyProblem, **kw) -> TinyProblem:
    """Override settings fields (tiny_update_settings, tiny_api.cpp:388-411).
    Settings the solvers do not implement are accepted here and rejected by
    the solver that is asked to run them. Turning adaptive rho on attaches
    the rho sensitivities when the cache has none
    (:func:`with_sensitivities`); it is refused on a consensus problem.
    A new ``consensus_rho`` on a consensus problem re-bakes its step-0
    gains, which would otherwise no longer match the linear term."""
    settings = dataclasses.replace(prob.settings, **kw)
    if settings.adaptive_rho and prob.spec.en_consensus:
        raise ValueError(_CONSENSUS_ADAPTIVE)
    if settings.adaptive_rho_tolerance < 1.0:
        raise ValueError(
            "adaptive_rho_tolerance must be >= 1 (1.0 = the reference's "
            "unconditional adaptation)")
    if settings.coarse_iters < 0:
        raise ValueError("coarse_iters must be >= 0")
    prob = prob.replace(settings=settings)
    if "consensus_rho" in kw and prob.spec.en_consensus:
        prob = prob.replace(cache=_bake_consensus_gains(
            prob, settings.consensus_rho))
    if settings.adaptive_rho and prob.cache.dKinf_drho is None:
        prob = with_sensitivities(prob)
    return prob


def with_sensitivities(prob: TinyProblem, tables=None) -> TinyProblem:
    """Attach d{Kinf, Pinf, C1, C2}/drho for adaptive rho
    (tiny_initialize_sensitivity_matrices, tiny_api.cpp:479-540).

    By default they are computed for this system by
    :func:`~tinympc_tpu_torch.riccati.compute_sensitivities`, in the
    problem's dtype on its device (on the card, one host round trip a
    fixed-point step). ``tables=(dKinf, dPinf, dC1, dC2)``
    gives them explicitly, e.g.
    :func:`~tinympc_tpu_torch.systems.crazyflie_sensitivity_tables` for
    parity with the reference's adaptive-rho runs."""
    c = prob.cache
    if tables is None:
        tables = compute_sensitivities(
            prob.A, prob.B, prob.f, prob.Qdiag - c.rho, prob.Rdiag - c.rho,
            c.rho)        # the raw diagonals: undo setup's augmentation
    dK, dP, dC1, dC2 = (_as_tensor(t, prob.dtype, prob.device)
                        for t in tables)
    return prob.replace(cache=dataclasses.replace(
        c, dKinf_drho=dK, dPinf_drho=dP, dC1_drho=dC1, dC2_drho=dC2))


def init_state(prob: TinyProblem, batch_shape: Tuple[int, ...] = ()
               ) -> SolverState:
    """Zero workspace for this problem (tiny_setup's zero-init,
    tiny_api.cpp:68-133), on the problem's device."""
    return _init_state_spec(prob.spec, batch_shape, prob.dtype, prob.device)
