"""Hand-written GPU kernels of the port (counterpart of
``tinympc_tpu.kernels``). Kernels are built and loaded on first use, never
at import."""
from .admm_fused import (FusedCarry, fused_supported, init_carry,
                         shift_carry, solve_fused, solve_fused_reference,
                         solve_fused_warm, solve_fused_warm_reference)
from .closed_loop_kernel import (closed_loop_fused,
                                closed_loop_fused_reference,
                                closed_loop_fused_supported)

__all__ = ["FusedCarry", "fused_supported", "init_carry", "shift_carry",
           "solve_fused", "solve_fused_reference", "solve_fused_warm",
           "solve_fused_warm_reference", "closed_loop_fused",
           "closed_loop_fused_reference", "closed_loop_fused_supported"]
