"""gather_roofline (slot passes, device trace): the least time the card
could take for the window's aggregations, over the time its slot-pass
kernels took, in %. The bound counts each input byte once (the int32
indices, the edge values where GCN has them, the gathered table at the
configuration's gather dtype, the row offsets) and each float32 output byte
once, from the graph's V and E and the widths, for each epoch's training
passes and one eval forward a run (perfbench/work.py). Moves epoch_ms."""

import re

from perfbench import work

KERNELS = re.compile(r"gather_pass_kernel")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    seconds = tr.kernel_seconds(KERNELS)
    if not seconds:
        return None
    ops = work.window_ops(ctx.config, ctx.traffic, tr.epochs, tr.runs)
    return 100.0 * work.bound_s(ops, "aggregate") / seconds
