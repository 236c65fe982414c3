"""finalize_s (op build, program span): the seconds of the program's
graph.finalize span in the process (Graph.finalize: the host sort by
destination and the GCN norms; the span's `native` attribute says whether
native/libgraphcore.so ran them). Read from the program's recorder
(dorylus_tpu_torch/common/metrics.py); nothing where the program has none.
Moves setup_s."""

from dorylus_tpu_torch.common import metrics as program

SPANS = ("graph.finalize",)


def read(ctx):
    spans = getattr(program, "spans", None)
    found = [s["total_s"] for name, s in spans().items() if name in SPANS] if spans else []
    return sum(found) if found else None
