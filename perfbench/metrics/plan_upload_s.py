"""plan_upload_s (op build, program span): the seconds of both hyb plans'
uploads in the process (hyb.upload, forward and backward: the numpy plans
copied to the card and each plan's descriptor table checked,
ops/gather_parts.PartTable). Read from the program's recorder
(dorylus_tpu_torch/common/metrics.py); nothing where the program has none.
Moves setup_s."""

from dorylus_tpu_torch.common import metrics as program

SPANS = ("hyb.upload",)


def read(ctx):
    spans = getattr(program, "spans", None)
    found = [s["total_s"] for name, s in spans().items() if name in SPANS] if spans else []
    return sum(found) if found else None
