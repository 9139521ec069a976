"""Share of the stretch traced on the device alone (no host operator
calls recorded) in which no kernel, copy or set ran on the device, from
torch.profiler (which may lose events)."""


def read(ctx):
    if ctx.job != "pretrain" or ctx.trace is None or not ctx.trace.window_s \
            or not ctx.trace.busy_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
