"""tail_ms (the models' elementwise work, activations, loss, Adam, device
trace): the device time of every kernel that is neither a slot pass nor a
GEMM or GEMV (the gather table's casts, the output fills, tanh, LeakyReLU,
the softmax cross-entropy, Adam's updates, the copies of the group's
results), per epoch of the traced window, in ms. Moves epoch_ms."""

import re

NOT_TAIL = re.compile(r"gather_pass_kernel|gemm|gemv|sgemm|cutlass|xmma", re.IGNORECASE)


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    seconds = tr.kernel_seconds(exclude=NOT_TAIL)
    return 1e3 * seconds / tr.epochs if seconds else None
