"""Hand-written GPU kernels of the port (counterpart of
``tinympc_tpu.kernels``). Kernels are built and loaded on first use, never
at import."""
from .admm_fused import (FusedCarry, adapted_cache, fused_supported,
                         init_carry, shift_carry, solve_fused,
                         solve_fused_multi, solve_fused_multi_reference,
                         solve_fused_reference, solve_fused_warm,
                         solve_fused_warm_reference)
from .admm_stream import (solve_fused_streamed,
                          solve_fused_streamed_reference,
                          solve_fused_streamed_warm,
                          solve_fused_streamed_warm_reference,
                          stream_supported)
from .closed_loop_kernel import (closed_loop_fused,
                                closed_loop_fused_reference,
                                closed_loop_fused_supported)
from .compact import make_compact_solver, solve_fused_compact
from .fleet import make_fleet_solver, solve_fused_fleet
from .roofline import (dot_probe, dot_probe_reference, elementwise_probe,
                       elementwise_probe_reference)

__all__ = ["FusedCarry", "adapted_cache", "fused_supported", "init_carry",
           "shift_carry", "solve_fused", "solve_fused_reference",
           "solve_fused_warm", "solve_fused_warm_reference",
           "solve_fused_streamed", "solve_fused_streamed_reference",
           "solve_fused_streamed_warm", "solve_fused_streamed_warm_reference",
           "stream_supported", "closed_loop_fused",
           "closed_loop_fused_reference", "closed_loop_fused_supported",
           "make_compact_solver", "solve_fused_compact",
           "solve_fused_multi", "solve_fused_multi_reference",
           "make_fleet_solver", "solve_fused_fleet", "dot_probe",
           "dot_probe_reference", "elementwise_probe",
           "elementwise_probe_reference"]
