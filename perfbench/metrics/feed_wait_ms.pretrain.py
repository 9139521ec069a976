"""Host ms per update that the window's updates waited on their batch:
the benchmark's own span around its call into the pretrain feed."""


def read(ctx):
    if ctx.job != "pretrain" or not ctx.window.feed_s:
        return None
    return 1e3 * sum(ctx.window.feed_s) / len(ctx.window.feed_s)
