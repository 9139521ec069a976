"""PyTorch operator calls per update in the updates traced with the
host's calls: the trace's aten:: events, counted as tools/step_calls.py
counts them."""


def read(ctx):
    if ctx.job != "finetune" or ctx.host_trace is None \
            or not ctx.host_traced_updates or not ctx.host_trace.aten_calls:
        return None
    return ctx.host_trace.aten_calls / ctx.host_traced_updates
