"""loop_idle_ms (group loop and epoch graphs, device trace): the card's
idle time inside the traced window while the program's engine.run span is
open and its engine.dispatch is not (the groups' host reads and records,
the time between a group's start and its dispatch, each run()'s start and
end), whatever finer host event runs inside it, per epoch, in ms. Idle
while a group's epochs are being dispatched is left out: that is the
dispatch's own. Nothing where the trace holds no engine.run span. Moves
epoch_ms."""

LOOP = "engine.run"
DISPATCH = "engine.dispatch"


def merged(ivs):
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def outside(ivs, t0, t1):
    """[t0, t1] less the merged intervals `ivs`."""
    edges = [t0] + [x for iv in ivs for x in iv] + [t1]
    return [[a, b] for a, b in zip(edges[::2], edges[1::2]) if b > a]


def overlap(xs, ys):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append([a, b])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device:
        return None
    notes = [(name, a, b) for name, cat, a, b in tr.host if cat == "user_annotation"]
    loop = merged([(a, b) for name, a, b in notes if name == LOOP])
    if not loop:
        return None
    dispatch = merged([(a, b) for name, a, b in notes if name == DISPATCH])
    idle = outside(merged([(a, b) for _, _, a, b in tr.device]), tr.t0, tr.t1)
    kept = overlap(overlap(idle, loop), outside(dispatch, tr.t0, tr.t1))
    return 1e-3 * sum(b - a for a, b in kept) / tr.epochs
