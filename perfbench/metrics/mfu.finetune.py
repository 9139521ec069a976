"""Model FLOPs of the window's updates (forward and backward at the
cell's shapes and rollout lengths, counted by FlopCounterMode on the plain
reference, no recompute) over the window's seconds, as a share of the
165 TFLOP/s of float32 work the H100's TF32 tensor cores give as 3xTF32
(495 / 3; NVIDIA data sheet, SXM, 700 W)."""


def read(ctx):
    if ctx.job != "finetune" or not ctx.window_flops or not ctx.window.seconds:
        return None
    return 100.0 * ctx.window_flops / ctx.window.seconds \
        / ctx.peak_flop_per_s
