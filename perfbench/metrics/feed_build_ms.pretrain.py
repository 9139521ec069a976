"""Host ms per batch that the pretrain feed's prefetch thread spent
building a batch and copying it to the card: the spans `feed.build` and
`feed.copy`, over the count of `feed.build`, in the records that hold
one.

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
    n = rec.get("feed.build", [0, 0])[1]
    return (rec["feed.build"][0] + rec.get("feed.copy", [0, 0])[0]) \
        / n / 1e6 if n else None
