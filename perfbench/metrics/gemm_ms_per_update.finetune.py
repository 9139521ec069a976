"""Device ms per update of the library GEMMs (cuBLAS / CUTLASS kernels by
name) in the traced updates."""
from perfbench.trace import is_library_gemm


def read(ctx):
    if ctx.job != "finetune" or ctx.trace is None or not ctx.traced_updates:
        return None
    t = ctx.trace.time_of(is_library_gemm)
    return 1e3 * t / ctx.traced_updates if t > 0 else None
