"""tinympc_tpu_torch: the PyTorch/CUDA port of tinympc_tpu for NVIDIA Hopper.

It imports ``torch`` and ``numpy`` only, never JAX or the JAX package.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``::

    import tinympc_tpu_torch as tt
    s = tt.systems.quadrotor_20hz()
    prob = tt.setup(s["A"], s["B"], s["Qdiag"], s["Rdiag"], rho=s["rho"],
                    N=20, dtype=torch.float32)
    prob = tt.with_bounds(prob, x_min=-5.0, x_max=5.0, u_min=-0.5, u_max=0.5)
    prob = tt.with_cones(prob, state_cones=[(0, 3, 0.25)])   # optional
    prob = tt.with_settings(prob, max_iter=100, check_termination=25)
    sol, res = tt.kernels.solve_fused(prob, Xref, None, x0s)   # CUDA kernel
    sol, state, cache = tt.solve(prob, tt.init_state(prob, (B,)), Xref,
                                 None, x0s)                    # plain PyTorch

The serving loop: ``kernels.solve_fused_warm`` with a ``FusedCarry``
(``init_carry``, ``shift_carry``) for an external plant, and
``kernels.closed_loop_fused`` for whole closed loops on the card, with
``closed_loop`` / ``shift_state`` as their plain PyTorch counterpart.

Constraint families: box bounds (``with_bounds``), second-order cones
(``with_cones``), hyperplanes (``with_linear_constraints``) and time-varying
hyperplanes (``with_tv_linear_constraints``, ``tv_from_stacked``), in the
plain solve and in the cold and warm fused kernel; the fused closed loop
takes box bounds only, as the JAX one does.

Adaptive rho: ``with_settings(prob, adaptive_rho=True)`` attaches the rho
sensitivities (``with_sensitivities``; ``systems.crazyflie_sensitivity_
tables`` gives the reference's), and ``solve`` returns each problem's
final cache; the fused kernel runs it for box problems at (12, 4), cold
and warm, the final rho a 5th residual row (``kernels.adapted_cache``)
and, warm, a ``FusedCarry`` field.
"""
from . import admm, convert, kernels, rho_adapt, systems
from .admm import solve
from .closed_loop import closed_loop, shift_state
from .kernels import (FusedCarry, closed_loop_fused, init_carry,
                      shift_carry, solve_fused_warm)
from .api import (init_state, setup, tv_from_stacked, with_bounds,
                  with_cones, with_linear_constraints, with_sensitivities,
                  with_settings, with_tv_linear_constraints)
from .riccati import compute_sensitivities, precompute_cache
from .types import (Cache, ConstraintData, ProblemSpec, Settings, Solution,
                    SolverState, TinyProblem)

__all__ = [
    "admm", "convert", "kernels", "rho_adapt", "systems", "solve",
    "closed_loop",
    "shift_state", "FusedCarry", "init_carry", "shift_carry",
    "solve_fused_warm", "closed_loop_fused", "init_state", "setup",
    "with_bounds", "with_cones", "with_linear_constraints",
    "with_tv_linear_constraints", "tv_from_stacked", "with_settings",
    "with_sensitivities", "precompute_cache", "compute_sensitivities",
    "Cache",
    "ConstraintData", "ProblemSpec", "Settings", "Solution", "SolverState",
    "TinyProblem",
]
