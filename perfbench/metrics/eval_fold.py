"""eval_fold (group loop and epoch graphs, program counter): the share of
the process's evaluations, per epoch and final, that the program read off
a forward already run on the same params, in %: 100 * folded / (folded +
eval forwards), from the program's counters engine.evals_folded and
engine.eval_forwards. Nothing where the program has no such counters.
Moves epoch_ms."""

from dorylus_tpu_torch.common import metrics as program


def read(ctx):
    c = program.counters()
    if not {"engine.evals_folded", "engine.eval_forwards"} <= c.keys():
        return None
    evals = c["engine.evals_folded"] + c["engine.eval_forwards"]
    return 100.0 * c["engine.evals_folded"] / evals if evals else None
