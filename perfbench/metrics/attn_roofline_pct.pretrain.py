"""Share of the float32 K1 / K2 kernels' device time in the traced
updates that their least time takes: the launches the updates' shapes
call for (checked against the port's launch counters), each at the
larger of its bytes at 3.35 TB/s and its operations as three TF32
products at 495 TFLOP/s."""
from perfbench.roofline import K_F32_PARTS


def read(ctx):
    if ctx.job != "pretrain" or ctx.trace is None or ctx.least_s is None:
        return None
    t = ctx.trace.time_of(lambda n: any(k in n for _, k in K_F32_PARTS))
    return 100.0 * ctx.least_s / t if t > 0 else None
