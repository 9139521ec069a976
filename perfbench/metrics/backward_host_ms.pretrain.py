"""Host ms per update in the backward: the span `update/backward`.

Read from the port's own update records
(`vln_goat_tpu_torch.utils.logger.records`, one per update, spans by path
in host ns): the median over the window's updates, the records just
before the two traced stretches' ones; None where the port keeps no
records or the deque no longer holds the window's."""
import statistics


def read(ctx):
    if ctx.job != "pretrain":
        return None
    try:
        from vln_goat_tpu_torch.utils.logger import records
    except ImportError:
        return None
    recs = list(records())
    n, tail = ctx.window.updates, ctx.traced_updates + ctx.host_traced_updates
    if not n or len(recs) < n + tail:
        return None
    vals = [v for v in map(value, recs[len(recs) - tail - n:len(recs) - tail])
            if v is not None]
    return statistics.median(vals) if vals else None


def value(rec):
    return rec.get("update/backward", [0, 0])[0] / 1e6
