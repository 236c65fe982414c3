"""epoch_ms (end to end, host clock): the window's wall time over the
epochs it completed, eval included. The window is whole run(k) calls, each
ending in its host read."""


def read(ctx):
    return 1e3 * ctx.clock["window_s"] / ctx.clock["epochs"]
