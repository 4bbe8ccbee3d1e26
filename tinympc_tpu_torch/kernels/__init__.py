"""Hand-written GPU kernels of the port (counterpart of
``tinympc_tpu.kernels``). Kernels are built and loaded on first use, never
at import."""
from .admm_fused import fused_supported, solve_fused, solve_fused_reference

__all__ = ["fused_supported", "solve_fused", "solve_fused_reference"]
