"""The port's device-to-host reads per update: the count of every span
`read` of the record.

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


def is_read(path):
    return path == "read" or path.endswith("/read")


def value(rec):
    return sum(n for p, (_, n) in rec.items() if is_read(p))
