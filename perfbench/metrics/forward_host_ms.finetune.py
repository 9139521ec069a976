"""Host ms per update in the update's forward: the spans `update/text`,
`update/teacher` and `update/sample`, less the reads under them.

Read from the port's own update records
(`vln_goat_tpu_torch.utils.logger.records`, one per update, spans by path
in host ns): the median over the window's updates, the records just
before the two traced stretches' ones; None where the port keeps no
records or the deque no longer holds the window's."""
import statistics


def read(ctx):
    if ctx.job != "finetune":
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


def less_reads(rec, path):
    """ns of `path` less those of the reads under it."""
    return rec.get(path, [0, 0])[0] - sum(
        ns for p, (ns, _) in rec.items()
        if p.startswith(path + "/") and is_read(p))


def value(rec):
    return sum(less_reads(rec, f"update/{k}")
               for k in ("text", "teacher", "sample")) / 1e6
