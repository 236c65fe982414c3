"""device_idle (group loop and epoch graphs, device trace): the share of the
traced window in which no kernel, copy or fill ran on the card: 1 minus the
union of their intervals over the window's span, in %. Moves epoch_ms."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.span_s)
