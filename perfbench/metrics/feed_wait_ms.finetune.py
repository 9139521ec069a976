"""Host ms per update that the window's updates waited on their batch:
the benchmark's own span around its call into the finetune feed."""


def read(ctx):
    if ctx.job != "finetune" or not ctx.window.feed_s:
        return None
    return 1e3 * sum(ctx.window.feed_s) / len(ctx.window.feed_s)
