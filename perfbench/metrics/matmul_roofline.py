"""matmul_roofline (dense layers, device trace): the least time the card
could take for the window's layer matmuls (forward, weight gradient, input
gradient past the first layer, GAT's attention products z @ a, d(za) a^T
and z^T d(za); each epoch's and one eval forward's a run; float32 at 67
TFLOP/s with TF32 off, or their bytes at 3.35 TB/s, whichever bounds;
perfbench/work.py), over the time of its GEMM and GEMV kernels, in %.
Moves epoch_ms."""

import re

from perfbench import work

KERNELS = re.compile(r"gemm|gemv|sgemm|cutlass|xmma", re.IGNORECASE)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    seconds = tr.kernel_seconds(KERNELS)
    if not seconds:
        return None
    ops = work.window_ops(ctx.config, ctx.traffic, tr.epochs, tr.runs)
    return 100.0 * work.bound_s(ops, "matmul") / seconds
