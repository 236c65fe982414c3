"""run_end_ms (group loop and epoch graphs, device trace): the mean length,
in ms, of the program's engine.run_end annotations inside the traced
window: the end of each run() (its cost and memory notes, then two eager
evals, val and test, each read on the host). Nothing where the trace holds
none. Moves epoch_ms."""

NAME = "engine.run_end"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    ends = [b - a for name, cat, a, b in tr.host if cat == "user_annotation" and name == NAME]
    return 1e-3 * sum(ends) / len(ends) if ends else None
