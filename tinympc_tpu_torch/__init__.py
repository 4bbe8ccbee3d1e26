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
takes box bounds only, as the JAX one does, at (12, 4), (6, 3), (4, 1),
(2, 2), (2, 1), (3, 3) and (1, 1).

Scenario-tree consensus: ``with_consensus(prob, rho_c=...)`` drives the
first input of every problem in a group (the last batch axis) to a common
value, in the plain solve (batch shape ``(n_groups, G)``) and in the cold
and warm fused kernel (x0s ``(n_groups, G, nx)``, G a power of two up to
128).

Long horizons: ``kernels.solve_fused_streamed`` and
``solve_fused_streamed_warm`` (the same carry) run each iteration as a
backward and a forward kernel over the horizon, with only the tables that do
not grow with N in shared memory, so N may pass the resident kernel's
shared-memory wall (~1190 at (12, 4)); every family, at (12, 4) and
(6, 3), at fixed rho with or without consensus, or with adaptive rho. The
forward launch of a box problem at fixed rho runs on lane teams (a thread
a row of each lane), every other on one thread a lane.

To convergence: ``kernels.make_compact_solver`` (and the one-shot
``kernels.solve_fused_compact``) splits the budget into phases of warm
``solve_fused_warm(final=True)`` (or streamed) solves and regathers the
lanes still running between phases; bitwise equal to one long solve for box
problems at fixed rho, and in group units under consensus.

Adaptive rho: ``with_settings(prob, adaptive_rho=True)`` attaches the rho
sensitivities (``with_sensitivities``; ``systems.crazyflie_sensitivity_
tables`` gives the reference's), and ``solve`` returns each problem's
final cache; the fused and the streamed kernels run it with every family
at (12, 4) and (6, 3), cold and warm, the final rho a 5th residual row
(``kernels.adapted_cache``) and, warm, a ``FusedCarry`` field.

Heterogeneous fleets: ``make_fleet_solver(probs, warm=...)`` (and the
one-shot ``solve_fused_fleet``) solve a batch whose problems name their
system in a host assignment array, in one multi-system launch of the fused
kernel (``solve_fused_multi`` for a system-major batch), cold or warm.
``python -m tinympc_tpu_torch.roofline`` measures the fused solve beside the
probes of ``kernels.dot_probe`` and ``kernels.elementwise_probe`` on the
card.
"""
from . import admm, convert, kernels, rho_adapt, systems
from .admm import solve
from .closed_loop import closed_loop, shift_state
from .kernels import (FusedCarry, closed_loop_fused, init_carry,
                      make_fleet_solver, shift_carry, solve_fused_fleet,
                      solve_fused_multi, solve_fused_multi_reference,
                      solve_fused_streamed, solve_fused_streamed_warm,
                      solve_fused_warm)
from .api import (init_state, setup, tv_from_stacked, with_bounds,
                  with_cones, with_consensus, with_linear_constraints,
                  with_sensitivities, with_settings,
                  with_tv_linear_constraints)
from .riccati import compute_sensitivities, precompute_cache
from .types import (Cache, ConstraintData, ProblemSpec, Settings, Solution,
                    SolverState, TinyProblem)

__all__ = [
    "admm", "convert", "kernels", "rho_adapt", "systems", "solve",
    "closed_loop",
    "shift_state", "FusedCarry", "init_carry", "shift_carry",
    "solve_fused_warm", "solve_fused_streamed", "solve_fused_streamed_warm",
    "closed_loop_fused", "solve_fused_multi", "solve_fused_multi_reference",
    "make_fleet_solver", "solve_fused_fleet", "init_state", "setup",
    "with_bounds", "with_cones", "with_consensus", "with_linear_constraints",
    "with_tv_linear_constraints", "tv_from_stacked", "with_settings",
    "with_sensitivities", "precompute_cache", "compute_sensitivities",
    "Cache",
    "ConstraintData", "ProblemSpec", "Settings", "Solution", "SolverState",
    "TinyProblem",
]
