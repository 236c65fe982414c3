"""slot_fill (slot passes, program counter): the share of the hyb plans'
slots that hold an edge, in %: 100 * 2E / (forward slots + backward slots),
from the program's gauges hyb.edges and hyb.slots.fwd / .bwd (each slot
pass reads every slot of its plan, padding included: useful reads over
reads). The same on every seed of a cell: the degrees are the traffic's.
Nothing where the program has no such gauges. Moves epoch_ms."""

from dorylus_tpu_torch.common import metrics as program


def read(ctx):
    gauges = getattr(program, "gauges", None)
    g = gauges() if gauges else {}
    if not {"hyb.edges", "hyb.slots.fwd", "hyb.slots.bwd"} <= g.keys():
        return None
    slots = g["hyb.slots.fwd"] + g["hyb.slots.bwd"]
    return 100.0 * 2 * g["hyb.edges"] / slots if slots else None
