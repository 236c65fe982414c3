"""Rank bodies for the port's multi-process tests (started by
dorylus_tpu_torch.parallel.multihost.spawn_local, which needs module-level
functions it can name in a fresh interpreter). Imports torch and the port
only, so a rank starts without loading jax."""

from __future__ import annotations

import contextlib
import sys
from typing import NamedTuple

import numpy as np
import torch

from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig
from dorylus_tpu_torch.engine import graphs
from dorylus_tpu_torch.graph.partition import partition_graph
from dorylus_tpu_torch.ops.reuse_sharded import ShardedReuseSpMM
from dorylus_tpu_torch.parallel import halo, multihost
from dorylus_tpu_torch.parallel.train_step import ShardedEngine


class HostRead(RuntimeError):
    pass


# What waits for the device on the host, which a capture refuses.
_HOST_READS = ("item", "tolist", "numpy", "__bool__", "__float__", "__int__")


@contextlib.contextmanager
def host_reads_refused():
    """Tensor.item, .tolist, .numpy, bool(), float(), int() and
    torch.cuda.synchronize raise HostRead inside the block."""
    def refuse(name):
        def call(*args, **kw):
            raise HostRead(f"{name} inside a captured body")
        return call

    saved = {name: torch.Tensor.__dict__.get(name) for name in _HOST_READS}
    sync = torch.cuda.synchronize
    for name in _HOST_READS:
        setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
    torch.cuda.synchronize = refuse("torch.cuda.synchronize")
    try:
        yield
    finally:
        for name, fn in saved.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)
        torch.cuda.synchronize = sync


class Rerun(graphs._Graph):
    """A stand-in for a captured graph on the CPU: the capture records the
    body and runs nothing; a replay reruns it (with host reads refused
    where `guard` is set) and leaves the host's state of `eng` (Adam's
    step) as a graph replay does. `made` counts the captures."""

    eng = None
    guard = False
    made = 0
    pool = None

    def __init__(self, body, pool=None):
        Rerun.made += 1
        self.body, self.added = body, []

    def replay(self):
        state = self.eng.opt_state
        with host_reads_refused() if self.guard else contextlib.nullcontext():
            out = self.body()
        self.eng.opt_state = state
        return out


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def rebind(eng, what: str) -> None:
    """Replace state a captured epoch reads by other tensors of the same
    values: "adam" new m and v objects, "param" each param's storage
    (`p.data = ...`: the same object at a new address)."""
    if what == "adam":
        st = eng.opt_state
        eng.opt_state = st._replace(m={k: t.clone() for k, t in st.m.items()},
                                    v={k: t.clone() for k, t in st.v.items()})
    else:
        for p in eng.params.values():
            p.data = p.data.clone()


def stand_in_graphs(eng, guard: bool = False) -> contextlib.ExitStack:
    """EpochGraphs with the capture stood in for by `Rerun` (the eager
    warm-up on the current stream) for `eng`; undone when the stack
    closes."""
    stack = contextlib.ExitStack()
    stack.enter_context(_patched(graphs, "_Graph", Rerun))
    stack.enter_context(_patched(graphs.EpochGraphs, "_eager", lambda self, fn: fn()))
    stack.enter_context(_patched(Rerun, "eng", eng))
    stack.enter_context(_patched(Rerun, "guard", guard))
    return stack


def engine_rank(rank, world, device, graph, dims, cfg_kw, epochs, opts):
    """Train `epochs` on this rank's shard; returns what the tests compare.
    opts: "grads" (the loss's gradients at the initial params, summed over
    the world as the train step sums them, taken before training),
    "profile" (ShardedEngine.profile after training), "predict",
    "constants" (engine/engine.py module constants set before the engine
    is built, e.g. reuse="auto"'s gate), "run" (epochs to run when they
    differ from cfg.epochs, the horizon the gate reads), "threshold"
    (kernel="auto"'s edge threshold the sharded engine resolves with),
    "as_card" (the engine decides whether it captures as on the card over
    this backend name), "graphs" (the epochs through EpochGraphs with the
    capture stood in for by `Rerun`; implies as_card "nccl"), "guard"
    (host reads refused while the stand-in's bodies run), "sequence" (the
    run() calls to make, each {"graphs": bool, "rebind": None, "adam" or
    "param"}, in place of one run(); each one's records and the captures
    so far come back under "runs")."""
    import functools

    from dorylus_tpu_torch.common import config
    from dorylus_tpu_torch.engine import engine as engine_module
    from dorylus_tpu_torch.parallel import train_step

    torch.set_num_threads(1)
    for name, value in opts.get("constants", {}).items():
        setattr(engine_module, name, value)
    if "threshold" in opts:
        train_step.resolve_kernel = functools.partial(config.resolve_kernel,
                                                      threshold=opts["threshold"])
    logs = []

    def log(msg, *args, **kw):
        logs.append(msg % args if args else msg)
        real_log(msg, *args, **kw)

    real_log = train_step.log

    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(train_step, "log", log))
        as_card = opts.get("as_card", "nccl" if opts.get("graphs") else None)
        if as_card is not None:
            real = train_step.epoch_graph_refusal
            stack.enter_context(_patched(train_step, "epoch_graph_refusal",
                                         lambda dev, be: real(torch.device("cuda"), as_card)))
        cfg = TrainConfig(epochs=epochs, **cfg_kw)
        eng = ShardedEngine(graph, LayerConfig(list(dims)), cfg, device=device,
                            partition_method=opts.get("partition", "range"))
        if opts.get("graphs"):
            stack.enter_context(stand_in_graphs(eng, opts.get("guard", False)))
        made = Rerun.made
        return _engine_result(eng, opts, logs, made)


def _engine_result(eng, opts, logs, made):
    grads = None
    if opts.get("grads"):
        names = list(eng.params)
        loss = eng.model.loss(eng.batch, eng.compute_dtype, eng.halo)
        gs = torch.autograd.grad(loss, [eng.params[k] for k in names])
        grads = {k: multihost.all_reduce_sum(g.detach().clone()).cpu().numpy()
                 for k, g in zip(names, gs)}
    runs = []
    for call in opts.get("sequence", [{"graphs": True}]):
        if call.get("rebind"):
            rebind(eng, call["rebind"])
        n0 = len(eng.report.epochs)
        rep = eng.run(opts.get("run"), graphs=call["graphs"])
        runs.append({"losses": [e.loss for e in rep.epochs[n0:]],
                     "accuracies": [e.accuracy for e in rep.epochs[n0:]],
                     "val_acc": rep.final_accuracy, "captures": Rerun.made - made,
                     "graphed": eng._graphs is not None})
    out = {"losses": [e.loss for e in rep.epochs],
           "accuracies": [e.accuracy for e in rep.epochs],
           "times": [e.time_ms for e in rep.epochs],
           "val_acc": rep.final_accuracy, "test_acc": rep.test_accuracy,
           "kernel": eng.kernel_selected, "overlap": bool(eng.cfg.overlap),
           "edges_per_shard": eng.meta.ep,
           "wire": None if eng.halo_plan is None else eng.halo_plan.wire,
           "params": {k: p.detach().cpu().numpy() for k, p in eng.params.items()},
           "foreign_modules": sorted(m for m in sys.modules
                                     if m.split(".")[0] in ("dorylus_tpu", "bench")),
           "mesh": (eng.mesh.n_shards, eng.mesh.feat_shards, eng.mesh.graph_index,
                    eng.mesh.feat_index),
           "notes": dict(rep.notes), "grads": grads, "runs": runs, "logs": logs,
           "graph_refusal": eng.graph_refusal}
    if eng.opt_state is not None:
        st = eng.opt_state
        out["adam"] = (st.step, {k: t.cpu().numpy() for k, t in st.m.items()},
                       {k: t.cpu().numpy() for k, t in st.v.items()})
    split = eng.model.spmm_split
    op = eng.model.spmm_op
    out["plan"] = ("edge_split" if eng.model.edge_split is not None
                   else "pair" if isinstance(split, tuple)
                   else "fused" if split is not None
                   else "edge_op" if op is None else type(op).__name__)
    out["boundary_edges"] = eng.shard.num_edges - eng.shard.num_int
    if isinstance(op, ShardedReuseSpMM):
        out["pairs"] = (op.plan_fwd.num_pairs, op.plan_bwd.num_pairs)
        if op.f_in is not None:
            out["f_in"], out["f_out"] = op.f_in.cpu().numpy(), op.f_out.cpu().numpy()
            out["recv_cnt"] = (None if eng.halo_plan is None
                               else np.asarray(eng.halo_plan.recv_cnt))
    if opts.get("predict"):
        out["predict"] = eng.predict()
    if opts.get("profile"):
        out["profile"] = eng.profile(iters=2)
    return out


def engines_rank(rank, world, device, graph, dims, runs):
    """Several engine runs in one launch (a launch costs seconds): `runs`
    is a list of (cfg_kw, epochs, opts); returns engine_rank's result for
    each."""
    return [engine_rank(rank, world, device, graph, dims, cfg_kw, epochs, opts)
            for cfg_kw, epochs, opts in runs]


def cases_rank(rank, world, device, cases):
    """engine_rank for each (graph, dims, cfg_kw, epochs, opts) of `cases`,
    in one launch."""
    return [engine_rank(rank, world, device, *case) for case in cases]


def staging_rank(rank, world, device):
    """The collectives' host staging over two groups: the (2, 2) mesh's feat
    and graph reductions, gathers and all-to-alls of one shape and dtype,
    interleaved, with every tensor staged through the shared per-tag host
    buffers (on the CPU the buffers are plain, unpinned tensors). Returns
    each result as it stood when the call returned and as it stands at the
    end, and the expected values."""
    from dorylus_tpu_torch.parallel.mesh import make_mesh

    multihost._staged = lambda t: True
    multihost._host = _shared_host
    mesh = make_mesh(2, 2)
    fg, gg = mesh.feat_group, mesh.graph_group
    x = torch.full((3, 4), float(rank + 1))
    calls = [("feat", lambda: multihost.all_reduce_sum(x.clone(), fg)),
             ("graph", lambda: multihost.all_reduce_sum(10 * x, gg)),
             ("feat", lambda: multihost.all_reduce_sum(100 * x, fg)),
             ("gather_graph", lambda: multihost.all_gather_rows(x, gg)),
             ("gather_feat", lambda: multihost.all_gather_rows(2 * x, fg)),
             ("a2a_graph", lambda: multihost.all_to_all_rows(
                 torch.arange(4.0)[:, None].repeat(1, 3) + 10 * rank, [2, 2], [2, 2], gg)),
             ("a2a_feat", lambda: multihost.all_to_all_rows(
                 torch.arange(4.0)[:, None].repeat(1, 3) + 100 * rank, [2, 2], [2, 2], fg)),
             ("world", lambda: multihost.all_reduce_sum(x.clone()))]
    kept, at_return = [], []
    for _, call in calls:
        t = call()
        kept.append(t)
        at_return.append(t.clone().numpy())
    return {"names": [c[0] for c in calls], "at_return": at_return,
            "at_end": [t.numpy() for t in kept], "mesh": tuple(mesh[:4])}


_SHARED: dict = {}


def _shared_host(tag, shape, dtype):
    """multihost._host without pinning: one buffer per (tag, dtype), grown
    as needed, views of it handed out."""
    need = int(np.prod(shape)) if len(shape) else 1
    buf = _SHARED.get((tag, dtype))
    if buf is None or buf.numel() < need:
        buf = torch.empty(max(need, 1), dtype=dtype)
        _SHARED[(tag, dtype)] = buf
    return buf[:need].view(*shape)


def halo_rank(rank, world, device, graph, method, wire, h_all, g_all, dtype):
    """One exchange forward and backward on this rank: (ghosts, dh, table
    of halo_exchange) for the shard's rows of h_all and the cotangent
    g_all[rank]."""
    torch.set_num_threads(1)
    sharded = partition_graph(graph, world, method=method)
    shard = sharded.shards[rank]
    plan = halo.HaloPlan(shard, world, wire, device)
    tdt = getattr(torch, dtype)
    h = torch.tensor(h_all[rank], device=device).to(tdt).requires_grad_(True)
    ghosts = halo.halo_recv(h, plan)
    ghosts.backward(torch.tensor(g_all[rank], device=device).to(tdt))
    table = halo.halo_exchange(h.detach(), plan)
    return {"ghosts": ghosts.detach().float().cpu().numpy(),
            "dh": h.grad.float().cpu().numpy(),
            "table": table.float().cpu().numpy(),
            "send_cnt": np.asarray(plan.send_cnt), "recv_cnt": np.asarray(plan.recv_cnt),
            "wire_rows": plan.wire_rows(rank)}


def failing_rank(rank, world, device, bad):
    """Rank `bad` raises before the others' first collective returns."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    t = torch.ones(1)
    torch.distributed.all_reduce(t)
    return float(t)


def sleeping_rank(rank, world, device, seconds):
    """Outlasts the launcher's timeout."""
    import time

    time.sleep(seconds)
    return rank


def collective_capture_rank(rank, world, device):
    """chip_smoke.py's `collective_capture` on this rank: all_to_all_rows
    and an all-reduce captured in one CUDA graph, whether each replay was
    exact."""
    import chip_smoke

    return chip_smoke.collective_capture(device)


class _Done(NamedTuple):
    h: torch.Tensor
    ghosts: torch.Tensor


class _Arrived(torch.autograd.Function):
    """Ghost rows exchanged before, as HaloRecvFn's output at this point of
    the forward: the backward is the whole reverse exchange."""

    @staticmethod
    def forward(ctx, h, plan, ghosts):
        ctx.plan, ctx.h_dtype = plan, h.dtype
        return ghosts.view_as(ghosts)

    @staticmethod
    def backward(ctx, g):
        return halo.reverse_whole(g, ctx.plan).to(ctx.h_dtype), None, None


class Serial(halo.Halo):
    """The exchange as the overlap paths ran it before it was split: the
    whole exchange at `start`, the interior work after it, the reverse
    exchange whole. Its autograd node stands where the finish is, as
    HaloRecvFn's does, so autograd reaches it in the order the models
    create the layer's nodes in."""

    def start(self, h):
        with torch.no_grad():
            return _Done(h, halo.halo_recv(h, self.plan))

    def finish(self, done):
        return _Arrived.apply(done.h, self.plan, done.ghosts)


class ReverseWhole(halo.Halo):
    """The order before the backward was split: the forward exchange in
    two steps, its reverse whole in HaloRecvFn's backward (no join)."""

    def start(self, h):
        return halo.HaloPending(h, halo.halo_start(h, self.plan), None)


class WholeAtFinish(halo.ReverseExchange):
    """A reverse exchange that runs whole where the join finishes it."""

    def start(self, g):
        self.g = g

    def finish(self):
        return halo.reverse_whole(self.g, self.plan)


class OneCall(halo.Halo):
    """Both exchanges called whole where their finish is: the forward one
    at `finish`, the reverse one in the join's backward."""

    def start(self, h):
        reverse = WholeAtFinish(self.plan)
        return halo.HaloPending(halo.HaloJoinFn.apply(h, reverse), None, reverse)


HALOS = {"one-call": OneCall, "reverse-whole": ReverseWhole, "serial": Serial}


def _recording(eng, events, stack, exchanges=True):
    """Record, in `events`, each interior op the model issues on its overlap
    path (the fused plan's pure range, the degree pair's interior op, the
    edgewise split's interior aggregation) and, with `exchanges`, each
    all_to_all_rows_start / finish of this process. In the backward: each
    interior op's gradient ("interior"), GCN's self term's ("self") and
    each of GAT's attention gradients, leaky's ("attention"), as autograd
    starts their nodes."""
    from dorylus_tpu_torch.models import gat as gat_module
    from dorylus_tpu_torch.models import gcn as gcn_module

    def wrap(fn, tag, keep=lambda *a, **k: True, forward=True):
        def call(*args, **kw):
            kept = keep(*args, **kw)
            if kept and forward:
                events.append(tag)
            out = fn(*args, **kw)
            if kept and getattr(out, "grad_fn", None) is not None:
                out.grad_fn.register_prehook(lambda *a: events.append(tag))
            return out
        return call

    for name, tag in (("all_to_all_rows_start", "start"), ("all_to_all_rows_finish", "finish")):
        if exchanges:
            stack.enter_context(_patched(multihost, name, wrap(getattr(multihost, name), tag)))
    stack.enter_context(_patched(gcn_module, "self_term",
                                 wrap(gcn_module.self_term, "self", forward=False)))
    stack.enter_context(_patched(gat_module, "leaky_relu",
                                 wrap(gat_module.leaky_relu, "attention", forward=False)))
    split, esplit = eng.model.spmm_split, eng.model.edge_split
    if getattr(split, "fused", False):
        stack.enter_context(_patched(split, "pure_range", wrap(split.pure_range, "interior")))
    elif split is not None:
        for name in ("apply_static", "apply_dst", "apply"):
            stack.enter_context(_patched(split[0], name, wrap(getattr(split[0], name),
                                                              "interior")))
    else:
        stack.enter_context(_patched(gcn_module, "aggregate",
                                     wrap(gcn_module.aggregate, "interior")))
        stack.enter_context(_patched(
            gat_module, "spmm_edgewise",
            wrap(gat_module.spmm_edgewise, "interior",
                 lambda *a, **k: k.get("op") is esplit[0])))


# What autograd runs between a layer's reverse start and finish, per
# (kernel, model): the interior op's gradient, the self term's, GAT's
# attention gradients (two on the edgewise split: the boundary edges',
# then the interior edges').
BESIDE = {("hyb", "gcn"): ["self"], ("hyb", "gat"): ["attention"],
          ("degree", "gcn"): ["interior", "self"], ("degree", "gat"): ["interior", "attention"],
          ("xla", "gcn"): ["interior"], ("xla", "gat"): ["interior", "attention", "attention"]}


def events_of(kernel, model, layers, fork=("start",), join=("finish",)):
    """The recorded order of one loss and its gradient: each forward
    exchange around its layer's interior op, then each reverse one around
    what BESIDE lists."""
    fork, join = list(fork), list(join)
    return ((fork + ["interior"] + join) * layers
            + (fork + BESIDE[kernel, model] + join) * layers)


def _count_reverse(counts, stack):
    """Count, in `counts`, the reverse exchanges started in two steps
    ("split": `ReverseExchange.start`) and run whole ("whole":
    `halo.reverse_whole`, HaloRecvFn's whole backward)."""
    real_start, real_whole = halo.ReverseExchange.start, halo.reverse_whole

    def start(self, g):
        counts["split"] += 1
        return real_start(self, g)

    def whole(g, plan):
        counts["whole"] += 1
        return real_whole(g, plan)

    stack.enter_context(_patched(halo.ReverseExchange, "start", start))
    stack.enter_context(_patched(halo, "reverse_whole", whole))


def overlap_rank(rank, world, device, graph, dims, cases):
    """For each case (cfg_kw, epochs, halo): a ShardedEngine trained on
    this rank with its halo as built ("two-step", and first the events of
    one loss and its backward, `_recording`; "plain": nothing recorded),
    with both exchanges called whole at their finish ("one-call",
    `OneCall`), with the reverse exchange whole in HaloRecvFn's backward
    ("reverse-whole", `ReverseWhole`) or as before the forward split
    ("serial"). Returns the records, the final params and the plan's pure
    rows; for "two-step" and "plain", the reverse exchanges of that one
    loss's gradient, split and whole (`_count_reverse`)."""
    torch.set_num_threads(1)
    out = []
    for cfg_kw, epochs, how in cases:
        eng = ShardedEngine(graph, LayerConfig(list(dims)), TrainConfig(epochs=epochs, **cfg_kw),
                            device=device)
        events, reverse = [], {"split": 0, "whole": 0}
        if how in ("two-step", "plain"):
            with contextlib.ExitStack() as stack:
                if how == "two-step":
                    _recording(eng, events, stack)
                _count_reverse(reverse, stack)
                loss = eng.model.loss(eng.batch, eng.compute_dtype, eng.halo)
                torch.autograd.grad(loss, list(eng.params.values()))
        elif how in HALOS:
            eng.halo = HALOS[how](eng.halo.plan, ghosts_only=True)
        rep = eng.run()
        split = eng.model.spmm_split
        out.append({"losses": [e.loss for e in rep.epochs],
                    "accuracies": [e.accuracy for e in rep.epochs],
                    "params": {k: p.detach().cpu().numpy() for k, p in eng.params.items()},
                    "events": events, "reverse": reverse, "overlap": bool(eng.cfg.overlap),
                    "kernel": eng.kernel_selected,
                    "n_pure": getattr(split, "n_pure", None),
                    "pure_edges": getattr(split, "pure_edges", None)})
    return out


def busy_tag_rank(rank, world, device):
    """Two starts on the staged path's pinned buffers (CPU tensors staged
    through the shared stand-in buffers): the second is refused; the first
    finishes, and a later exchange runs. Returns the refusal's text, both
    results and the rows each should hold."""
    multihost._staged = lambda t: True
    multihost._host = _shared_host
    x = torch.arange(8.0).reshape(4, 2) + 10 * rank
    ex = multihost.all_to_all_rows_start(x, [2, 2], [2, 2])
    try:
        multihost.all_to_all_rows_start(x, [2, 2], [2, 2])
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    first = multihost.all_to_all_rows_finish(ex).clone().numpy()
    again = multihost.all_to_all_rows(x, [2, 2], [2, 2]).numpy()
    want = np.concatenate([np.arange(8.0).reshape(4, 2)[2 * rank: 2 * rank + 2] + 10 * p
                           for p in range(world)])
    return {"refused": refused, "first": first, "again": again, "want": want}


def nccl_standin_rank(rank, world, device, graph, dims, model, lr, replayed=False):
    """The NCCL transport's path on the CPU: the backend's name reads
    "nccl", the side and current streams are stand-ins that record the
    fork (the side stream waits for the current one) and the join (the
    reverse), gloo moves the rows underneath. For each overlap plan: the
    events of one loss and its backward, then the epochs through
    EpochGraphs (the capture stood in for by `Rerun`, host reads refused
    inside the bodies) and eagerly from the same init. replayed: also the
    events of one more replay of the stood-in train graph's body
    ("replayed_events"), host reads refused."""
    from dorylus_tpu_torch.parallel import train_step

    torch.set_num_threads(1)
    events = []

    class Stream:
        def __init__(self, name):
            self.name = name

        def wait_stream(self, other):
            events.append("fork" if self.name == "side" else "join")

    side, cur = Stream("side"), Stream("current")
    real_a2a = torch.distributed.all_to_all_single

    def collective(*args, **kw):
        events.append("collective")
        return real_a2a(*args, **kw)

    real_refusal = train_step.epoch_graph_refusal
    out = {}
    with contextlib.ExitStack() as stack:
        for obj, name, value in (
                (multihost, "backend_name", lambda: "nccl"),
                (multihost, "_side_stream", lambda dev: side),
                (torch.cuda, "current_stream", lambda device=None: cur),
                (torch.cuda, "stream", lambda s: contextlib.nullcontext()),
                (torch.distributed, "all_to_all_single", collective),
                (train_step, "epoch_graph_refusal",
                 lambda dev, be: real_refusal(torch.device("cuda"), be))):
            stack.enter_context(_patched(obj, name, value))
        for kernel in ("hyb", "degree", "xla"):
            cfg = TrainConfig(epochs=3, model=model, kernel=kernel, overlap=True,
                              learning_rate=lr, eval_every=1, reuse="off")
            row = {}
            for graphed in (True, False):
                eng = ShardedEngine(graph, LayerConfig(list(dims)), cfg, device=device)
                with contextlib.ExitStack() as inner:
                    if graphed:
                        events.clear()
                        with contextlib.ExitStack() as rec:
                            _recording(eng, events, rec, exchanges=False)
                            loss = eng.model.loss(eng.batch, eng.compute_dtype, eng.halo)
                            torch.autograd.grad(loss, list(eng.params.values()))
                        row["events"] = list(events)
                        eng = ShardedEngine(graph, LayerConfig(list(dims)), cfg, device=device)
                        inner.enter_context(stand_in_graphs(eng, guard=True))
                    rep = eng.run(graphs=graphed)
                    if graphed and replayed:
                        events.clear()
                        with contextlib.ExitStack() as rec:
                            _recording(eng, events, rec, exchanges=False)
                            eng._graphs.train[False].replay()
                        row["replayed_events"] = list(events)
                key = "graph_losses" if graphed else "eager_losses"
                row[key] = [e.loss for e in rep.epochs]
                if graphed:
                    row["graphed"] = eng._graphs is not None
            out[kernel] = row
    return out


def refusal_rank(rank, world, device, graph):
    """One layer's exchange in two steps both ways on this rank's shard
    (h (vp, 4) from the rank's seed): h's gradient against the whole
    exchange's (bit for bit: the same two sums); a backward that runs the
    join but prunes HaloRecvFn's node (the gradient of the joined h alone)
    and one that runs HaloRecvFn's node but prunes the join (the gradient
    with respect to the joined h), then a forward and a reverse start after
    it. Returns whether the gradients were equal and each refusal's text
    ("" where nothing was refused)."""
    torch.set_num_threads(1)
    shard = partition_graph(graph, world).shards[rank]
    plan = halo.HaloPlan(shard, world, "ragged", device)
    two = halo.Halo(plan, ghosts_only=True)
    rng = np.random.default_rng(rank)
    h = torch.tensor(rng.normal(size=(plan.vp, 4)).astype(np.float32), requires_grad=True)
    c = torch.tensor(rng.normal(size=(plan.n * plan.max_h, 4)).astype(np.float32))

    def refused(fn):
        try:
            fn()
        except RuntimeError as e:
            return str(e)
        return ""

    p = two.start(h)
    (split,) = torch.autograd.grad((two.finish(p) * c).sum() + (p.h * p.h).sum(), [h])
    (whole,) = torch.autograd.grad((two(h) * c).sum() + (h * h).sum(), [h])
    out = {"equal": torch.equal(split, whole), "max_abs": float((split - whole).abs().max())}
    p = two.start(h)
    two.finish(p)
    out["pruned_start"] = refused(lambda: torch.autograd.grad((p.h * 2).sum(), [h]))
    p = two.start(h)
    ghosts = two.finish(p)
    # the start runs, the finish is pruned (HaloRecvFn returns h no gradient)
    torch.autograd.grad(ghosts.sum(), [p.h], allow_unused=True)
    out["forward_after"] = refused(lambda: two.start(h))
    out["reverse_after"] = refused(lambda: halo.ReverseExchange(plan).start(ghosts.detach()))
    return out


def bwd_exchanges_rank(rank, world, device, graph, dims, cases):
    """For each case (cfg_kw, epochs, how): a ShardedEngine trained on this
    rank with multihost.EXCHANGES set to 0 just before, its halo as built
    ("two-step") or with both exchanges whole at their finish ("one-call",
    `OneCall`). Returns the losses, params and the counts."""
    torch.set_num_threads(1)
    out = []
    for cfg_kw, epochs, how in cases:
        eng = ShardedEngine(graph, LayerConfig(list(dims)), TrainConfig(epochs=epochs, **cfg_kw),
                            device=device)
        if how in HALOS:
            eng.halo = HALOS[how](eng.halo.plan, ghosts_only=True)
        multihost.reset_exchanges()
        rep = eng.run()
        torch.cuda.synchronize()
        out.append({"losses": [e.loss for e in rep.epochs],
                    "params": {k: p.detach().cpu().numpy() for k, p in eng.params.items()},
                    "exchanges": dict(multihost.EXCHANGES), "kernel": eng.kernel_selected,
                    "overlap": bool(eng.cfg.overlap)})
    return out
