"""gather_ms (slot passes, device trace): the device time of the slot-pass
kernels (K1 static for GCN, K2 mask for GAT, forward and transpose, all on
ops/csrc/gather_pass.cuh) in the traced window, per epoch, in ms. Moves
epoch_ms."""

import re

KERNELS = re.compile(r"gather_pass_kernel")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    seconds = tr.kernel_seconds(KERNELS)
    return 1e3 * seconds / tr.epochs if seconds else None
