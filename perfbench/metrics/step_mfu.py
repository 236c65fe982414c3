"""step_mfu (the whole epoch, device trace): the least time the card could
take for everything the window's epochs need (each layer's aggregation
forward and backward at its aggregation width, each matmul forward and
backward, the eval forwards; per op the larger of its operations over the
dtype's published peak and its bytes over 3.35 TB/s, perfbench/work.py),
over the traced window's span, in %. The counts come from the configuration
and the graph, never from what the program launches. Moves epoch_ms."""

from perfbench import work


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    ops = work.window_ops(ctx.config, ctx.traffic, tr.epochs, tr.runs)
    return 100.0 * work.bound_s(ops) / tr.span_s
