"""plan_host_s (op build, program span): the seconds the hyb op's build
spends on the host before any upload, in the process: its checks
(hyb.check: dst-sorted, endpoints in range), the stable argsort of the
sources that orders the transpose (hyb.transpose_order) and both plans'
builds (hyb.plan, forward and backward). Read from the program's recorder
(dorylus_tpu_torch/common/metrics.py); nothing where the program has none.
Moves setup_s."""

from dorylus_tpu_torch.common import metrics as program

SPANS = ("hyb.check", "hyb.transpose_order", "hyb.plan")


def read(ctx):
    spans = getattr(program, "spans", None)
    found = [s["total_s"] for name, s in spans().items() if name in SPANS] if spans else []
    return sum(found) if found else None
