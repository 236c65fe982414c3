"""The sharded slice of the port against the JAX package, on the CPU:

  * `ShardedHybSpMM` (ops/hyb_sharded.py), the combined and the fused
    plan, against JAX's op on the same shard (JAX's stacked arrays, one
    shard's slice of them): outputs, dh, dghosts, d_dst;
  * `ShardedEngine` (parallel/train_step.py) without a process group: one
    shard equal to `Engine`, a rank built from its shard file, the layer
    order under a halo, and each refusal. The multi-rank runs against the
    JAX `ShardedEngine` are in test_torch_port_sharded_engine.py.

Tolerances: ops in f32 1e-5 (relative to max|ref|; only summation orders
differ), with bf16 gather tables <= 2e-3 * max|ref| (the ~1e-3 relative
per pass the JAX package documents). Engines over 5 epochs: GCN train loss
atol 1e-4; GAT, whose losses are O(100) at init, rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.graph.graph import Graph, clustered_synthetic_graph, synthetic_graph
from dorylus_tpu.graph.partition import partition_graph
from dorylus_tpu.ops.hyb_sharded import ShardedHybSpMM as JShardedHybSpMM
from dorylus_tpu.parallel import ShardedEngine as JShardedEngine
from dorylus_tpu.parallel import make_mesh
from dorylus_tpu_torch.engine.engine import Engine as TEngine
from dorylus_tpu_torch.graph import partition as tpart
from dorylus_tpu_torch.ops.hyb_sharded import ShardedHybSpMM
from dorylus_tpu_torch.parallel.train_step import ShardedEngine

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs >=4 devices (virtual CPU mesh)")

DIMS = [16, 8, 5]


def hub_graph(v=403, seed=5, feat=16, classes=5):
    """Zipf in-degrees (hubs past max_width=16) on a vertex count that
    does not divide by 2 or 4: the shape that exposed the JAX package's
    `_pad_rows` aliasing (vertex vp-1 zeroed under an uneven hub split)."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.6, v), 120)
    dst = np.sort(np.repeat(rng.permutation(v).astype(np.int32), deg))
    src = rng.integers(0, v, size=len(dst)).astype(np.int32)
    return Graph(num_vertices=v, src=src, dst=dst,
                 features=rng.normal(size=(v, feat)).astype(np.float32),
                 labels=(np.arange(v) % classes).astype(np.int32),
                 num_classes=classes).finalize()


def t32(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32)).requires_grad_(grad)


def close(got, ref, narrow):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    tol = (2e-3 if narrow else 1e-5) * max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got - ref).max()) <= tol


# ---- the sharded op ----


@pytest.fixture(scope="module", params=["gcn", "gat"])
def shards(request):
    static = request.param == "gcn"
    g = hub_graph()
    sg = partition_graph(g, 4, method="hash", for_gat=not static)  # heavy cut, hubs mix
    return g, sg, static


@pytest.mark.parametrize("narrow", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("edges", ["combined", "fused"])
def test_sharded_op_matches_jax(shards, edges, narrow):
    """Every shard's forward and gradients, through the op's autograd
    entries, against JAX's custom-VJP entries on that shard's slice of the
    stacked plan. The port plans over the shard's real edges with its own
    width DP, JAX over the padded edges with pooled widths: the sums are
    the same."""
    g, sg, static = shards
    n, vp, mh = sg.n_shards, sg.vp, sg.max_h
    kw = dict(max_width=16, lam_slots=8, static_vals=static, edges=edges)
    jop = JShardedHybSpMM(sg, dynamic=False,
                          gather_dtype=jnp.bfloat16 if narrow else None, **kw)
    rng = np.random.default_rng(3)
    f = 6
    saw_top = saw_pure = False
    for s in range(n):
        top = ShardedHybSpMM(sg.shards[s], n, gather_dtype=torch.bfloat16 if narrow else None,
                             device="cpu", **kw)
        saw_top |= top.fwd["top"] is not None
        saw_pure |= top.n_pure > 0
        ja = jax.tree.map(lambda v: v[s], jop.arrays)
        h = rng.normal(size=(vp, f)).astype(np.float32)
        gh = rng.normal(size=(n * mh, f)).astype(np.float32)
        dv = rng.normal(size=vp).astype(np.float32)
        gout = rng.normal(size=(vp, f)).astype(np.float32)
        table = np.concatenate([h, gh])
        if edges == "combined":
            tt, td = t32(table, True), t32(dv, True)
            if static:
                out = top.apply_static(tt)
                jout, vjp = jax.vjp(lambda t: jop.apply_static(ja, t), jnp.asarray(table))
            else:
                out = top.apply_dst(tt, td)
                jout, vjp = jax.vjp(lambda t, d: jop.apply_dst(ja, t, d), jnp.asarray(table),
                                    jnp.asarray(dv))
            out.backward(t32(gout))
            jg = vjp(jnp.asarray(gout))
            close(out.detach(), jout, narrow)
            close(tt.grad, jg[0], narrow)
            if not static:
                close(td.grad, jg[1], narrow)
                close(top.apply_unit(t32(table)), jop.apply_dst(ja, jnp.asarray(table),
                                                                jnp.ones(vp)), narrow)
        else:
            th, tg, td = t32(h, True), t32(gh, True), t32(dv, True)
            if static:
                out = top.apply_static_fused(th, tg)
                jout, vjp = jax.vjp(lambda a, b: jop.apply_static_fused(ja, a, b),
                                    jnp.asarray(h), jnp.asarray(gh))
            else:
                out = top.apply_dst_fused(th, tg, td)
                jout, vjp = jax.vjp(lambda a, b, d: jop.apply_dst_fused(ja, a, b, d),
                                    jnp.asarray(h), jnp.asarray(gh), jnp.asarray(dv))
            out.backward(t32(gout))
            jg = vjp(jnp.asarray(gout))
            close(out.detach(), jout, narrow)
            close(th.grad, jg[0], narrow)   # dh
            close(tg.grad, jg[1], narrow)   # dghosts
            if not static:
                close(td.grad, jg[2], narrow)   # d_dst
            close(top.apply_unit_fused(t32(h), t32(gh)),
                  jop.apply_unit_fused(ja, jnp.asarray(h), jnp.asarray(gh)), narrow)
    assert saw_top, "want hub coverage"
    assert edges == "combined" or saw_pure, "want pure buckets"


def test_fused_classification_is_jaxs(shards):
    """A vertex is mixed when any in-edge source is a ghost or its degree
    exceeds max_width; pure buckets come first, hubs only in the mixed
    top, every real edge in exactly one group."""
    g, sg, static = shards
    n, vp = sg.n_shards, sg.vp
    for shard in sg.shards:
        op = ShardedHybSpMM(shard, n, edges="fused", static_vals=static, max_width=16,
                            lam_slots=8, device="cpu")
        e = shard.num_edges
        src, dst = np.asarray(shard.src[:e]), np.asarray(shard.dst[:e])
        deg = np.bincount(dst, minlength=vp)
        ghost_dst = np.zeros(vp, bool)
        ghost_dst[dst[src >= vp]] = True
        mixed = ghost_dst | (deg > 16)
        pure_v = np.concatenate([b["v"].numpy() for b in op.fwd["buckets"][: op.n_pure]]
                                or [np.zeros(0, np.int64)])
        mixed_v = np.concatenate([b["v"].numpy() for b in op.fwd["buckets"][op.n_pure:]]
                                 + ([op.fwd["top"]["v"].numpy()] if op.fwd["top"] else []))
        assert not mixed[pure_v].any() and mixed[mixed_v].all()
        assert set(pure_v) | set(mixed_v) == set(np.where(deg > 0)[0])
        assert op.pure_edges + op.mixed_edges == e
        assert op.pure_edges == int((~mixed[dst]).sum())
        for b in op.fwd["buckets"][: op.n_pure]:
            live = np.arange(b["rows"].shape[1])[None, :] < b["cnt"].numpy()[:, None]
            assert (b["rows"].numpy()[live] < vp).all()  # pure slots read local rows only
        if op.fwd["top"] is not None:
            assert (deg[op.fwd["top"]["v"].numpy()] > 16).all()


def test_sharded_op_refusals():
    g = hub_graph()
    sg = tpart.partition_graph(g, 2)
    shard = sg.shards[0]
    with pytest.raises(ValueError, match="edges='split'"):
        ShardedHybSpMM(shard, 2, edges="split", device="cpu")
    inter = ShardedHybSpMM(shard, 2, edges="interior", device="cpu")
    assert (inter.num_in, inter.num_out) == (sg.vp, sg.vp)
    with pytest.raises(RuntimeError, match="edges='interior'"):
        inter.apply_unit_fused(torch.zeros((sg.vp, 3)), torch.zeros((2 * sg.max_h, 3)))
    comb = ShardedHybSpMM(shard, 2, edges="combined", static_vals=False, device="cpu")
    fused = ShardedHybSpMM(shard, 2, edges="fused", static_vals=False, device="cpu")
    h, gh = torch.zeros((sg.vp, 3)), torch.zeros((2 * sg.max_h, 3))
    with pytest.raises(RuntimeError, match="edges='combined'"):
        comb.apply_unit_fused(h, gh)
    with pytest.raises(RuntimeError, match="edges='fused'"):
        fused.apply_unit(torch.cat([h, gh]))
    with pytest.raises(RuntimeError, match="without static values"):
        comb.apply_static(torch.cat([h, gh]))
    with pytest.raises(RuntimeError, match="without static values"):
        fused.apply_static_fused(h, gh)
    bad = dataclasses.replace(shard, dst=shard.dst[::-1].copy())
    with pytest.raises(ValueError, match="dst-sorted"):
        ShardedHybSpMM(bad, 2, device="cpu")


# ---- the sharded engine ----


def jax_sharded(g, n, epochs=5, **kw):
    eng = JShardedEngine(g, LayerConfig(DIMS), TrainConfig(epochs=epochs, reuse="off", **kw),
                         mesh=make_mesh(n))
    rep = eng.run()
    return np.array([e.loss for e in rep.epochs]), eng


def port_single(g, epochs=5, **kw):
    eng = TEngine(g, LayerConfig(DIMS), TrainConfig(epochs=epochs, reuse="off", **kw),
                  device="cpu")
    return np.array([e.loss for e in eng.run().epochs]), eng


def loss_close(got, ref, model, narrow):
    if model == "gcn":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 if narrow else 1e-4)
    else:
        np.testing.assert_allclose(got, ref, rtol=5e-3 if narrow else 1e-5, atol=0)


@pytest.fixture(scope="module")
def graph():
    return clustered_synthetic_graph(600, 8, 16, 5, seed=11, window=128, cut=0.2)


@pytest.mark.parametrize("model,lr", [("gcn", 0.01), ("gat", 0.005)])
def test_one_shard_is_the_single_device_engine(graph, model, lr):
    """Without a process group the sharded engine is one shard: the
    single-device engine's losses, accuracies and predictions."""
    cfg = TrainConfig(epochs=5, model=model, kernel="hyb", learning_rate=lr, reuse="off",
                      eval_every=1)
    sh = ShardedEngine(graph, LayerConfig(DIMS), cfg, device="cpu")
    assert sh.n == 1 and sh.halo is None
    rep = sh.run()
    single_l, single = port_single(graph, model=model, kernel="hyb", learning_rate=lr,
                                   eval_every=1)
    loss_close([e.loss for e in rep.epochs], single_l, model, False)
    assert abs(rep.final_accuracy - single.report.final_accuracy) < 1e-6
    np.testing.assert_allclose(sh.predict(), single.predict(), rtol=1e-5, atol=1e-5)
    assert sh.output() == rep.summary()


def test_a_rank_trains_from_its_shard_file(graph, tmp_path):
    """The parent partitions once and hands each rank its shard as a
    file; the engine built from (Shard, ShardMeta) is the engine built
    from the graph."""
    sg = tpart.partition_graph(graph, 1)
    tpart.save_shard(tmp_path / "s0.npz", sg.shards[0], tpart.ShardMeta.of(sg))
    cfg = TrainConfig(epochs=3, kernel="hyb", reuse="off")
    a = ShardedEngine(tpart.load_shard(tmp_path / "s0.npz"), LayerConfig(DIMS), cfg,
                      device="cpu").run()
    b = ShardedEngine(graph, LayerConfig(DIMS), cfg, device="cpu").run()
    assert [e.loss for e in a.epochs] == [e.loss for e in b.epochs]
    sg2 = tpart.partition_graph(graph, 2)
    with pytest.raises(ValueError, match="handed to rank"):
        ShardedEngine((sg2.shards[1], tpart.ShardMeta.of(sg2)), LayerConfig(DIMS), cfg,
                      device="cpu")


def test_halo_exchanges_run_at_the_layer_output_widths():
    """Under a halo JAX's gather-cliff rule is off, so the port's plain
    transform-first rule orders the layers as JAX does: at 16-8-5 both
    exchanges carry the layer's output width (8, then 5), never 16."""
    g = synthetic_graph(200, 5, 16, 5, seed=3)
    eng = ShardedEngine(g, LayerConfig(DIMS), TrainConfig(kernel="hyb", reuse="off"),
                        device="cpu")
    widths = []

    def halo(h):
        widths.append(h.shape[1])
        return h  # one shard: the table is the local rows

    eng.model.forward(eng.batch, halo=halo)
    assert widths == [8, 5]


@pytest.mark.parametrize("kw,exc,match", [
    # tensor parallelism, refused until it was ported: now the mesh's n x m
    # world check (one process is no 1 x 2 mesh) and JAX's "divisible" refusal
    (dict(kernel="degree", feat_shards=2), ValueError, "feat axis"),
    (dict(kernel="hyb", reuse="pairs", feat_shards=2), ValueError, "feat axis"),
    (dict(kernel="hyb", feat_shards=3), ValueError, "divisible"),
    (dict(model="sage"), NotImplementedError, "model="),
    (dict(kernel="pallas"), NotImplementedError, "kernel="),
    (dict(kernel="hyb", compute_dtype="float16"), NotImplementedError, "compute_dtype"),
    (dict(kernel="hyb", halo="exact"), NotImplementedError, "halo="),
    (dict(kernel="hyb", param_dtype="bfloat16"), NotImplementedError, "param_dtype"),
])
def test_sharded_engine_refusals(kw, exc, match):
    g = synthetic_graph(120, 4, 16, 5, seed=1)
    with pytest.raises(exc, match=match):
        ShardedEngine(g, LayerConfig(DIMS), TrainConfig(**kw), device="cpu")


def test_sharded_profile_is_refused():
    """Once refused (stage profiling was not ported): profile() on one shard
    now returns JAX's brackets for the same config (no halo line with one
    graph shard), each > 0, and fills stage_times. A feature width that
    does not match the layer config is still refused."""
    g = synthetic_graph(120, 4, 16, 5, seed=1)
    cfg = TrainConfig(kernel="hyb", reuse="off", epochs=1)
    eng = ShardedEngine(g, LayerConfig(DIMS), cfg, device="cpu")
    times = eng.profile(iters=1)
    want = JShardedEngine(g, LayerConfig(DIMS), cfg, mesh=make_mesh(1)).profile(iters=1)
    assert set(times) == set(want) == set(eng.report.stage_times)
    assert all(v > 0 for v in times.values())
    with pytest.raises(ValueError, match="feature dim"):
        ShardedEngine(g, LayerConfig([12, 8, 5]), TrainConfig(kernel="hyb"), device="cpu")


def _op_makers():
    """Each entry point that places its tensors on a device: the engines and
    every op constructor, on a 120-vertex graph and rank 0 of its 2-way
    partition, and the command line's train. make(device=...) builds it; no
    argument means the card."""
    from dorylus_tpu_torch import cli
    from dorylus_tpu_torch.ops.degree_sharded import ShardedDegreeSpMM
    from dorylus_tpu_torch.ops.degree_spmm import DegreeSpMM
    from dorylus_tpu_torch.ops.hyb_spmm import HybSpMM
    from dorylus_tpu_torch.ops.reuse_sharded import ShardedReuseSpMM
    from dorylus_tpu_torch.ops.reuse_spmm import ReuseSpMM
    from dorylus_tpu_torch.ops.spmm import EdgeSpMM
    from dorylus_tpu_torch.parallel.halo import HaloPlan, ghost_counts

    g = synthetic_graph(120, 4, 16, 5, seed=1)
    sg = tpart.partition_graph(g, 2)
    shard = sg.shards[0]
    recv = [ghost_counts(s, 2, sg.vp, sg.max_h) for s in sg.shards]
    counts = (np.array([recv[q][0] for q in range(2)]), recv[0])
    v, cfg = g.num_vertices, TrainConfig(kernel="hyb", reuse="off")
    return {
        "Engine": lambda **kw: TEngine(g, LayerConfig(DIMS), cfg, **kw),
        "ShardedEngine": lambda **kw: ShardedEngine(g, LayerConfig(DIMS), cfg, **kw),
        "HybSpMM": lambda **kw: HybSpMM(g.src, g.dst, v, v, static_val=g.edge_norm, **kw),
        "DegreeSpMM": lambda **kw: DegreeSpMM(g.src, g.dst, v, v, **kw),
        "ReuseSpMM": lambda **kw: ReuseSpMM(g.src, g.dst, v, v, **kw),
        "EdgeSpMM": lambda **kw: EdgeSpMM(g.src, g.dst, v, v, **kw),
        "ShardedHybSpMM": lambda **kw: ShardedHybSpMM(shard, 2, edges="fused", **kw),
        "ShardedDegreeSpMM": lambda **kw: ShardedDegreeSpMM(shard, 2, **kw),
        "ShardedReuseSpMM": lambda **kw: ShardedReuseSpMM(shard, 2, **kw),
        "HaloPlan": lambda **kw: HaloPlan(shard, 2, "ragged", counts=counts, **kw),
        # the command line's train: the engine it builds from its flags
        "cli": lambda **kw: cli.build_engine(cli.parse_args(
            ["train", "--synth-vertices", "120", "--synth-degree", "4", "--kernel", "hyb",
             "--reuse", "off"]
            + [a for k, v in kw.items() for a in (f"--{k}", v)])),
    }


_ENTRY_POINTS = ["Engine", "ShardedEngine", "HybSpMM", "DegreeSpMM", "ReuseSpMM", "EdgeSpMM",
                 "ShardedHybSpMM", "ShardedDegreeSpMM", "ShardedReuseSpMM", "HaloPlan", "cli"]


@pytest.mark.parametrize("make", _ENTRY_POINTS)
def test_device_none_means_the_card(make):
    """device=None is the card: without one the engines and every op
    constructor raise instead of carrying on on the CPU; device="cpu"
    builds on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: device=None runs on it")
    build = _op_makers()[make]
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        build()
    assert build(device="cpu").device == torch.device("cpu")


def test_split_op_pair_is_refused():
    """The models take the fused op or an (interior, boundary) pair that
    writes the same rows; anything else handed in as `spmm_split` or
    `edge_split` is refused at construction."""
    from dorylus_tpu_torch.models.gat import GAT
    from dorylus_tpu_torch.models.gcn import GCN
    from dorylus_tpu_torch.ops.spmm import EdgeSpMM

    g = synthetic_graph(120, 4, 16, 5, seed=1)
    shard = tpart.partition_graph(g, 2).shards[0]
    comb = ShardedHybSpMM(shard, 2, edges="combined", device="cpu")
    static = ShardedHybSpMM(shard, 2, edges="interior", static_vals=True, device="cpu")
    fused = ShardedHybSpMM(shard, 2, edges="fused", device="cpu")
    other = ShardedHybSpMM(tpart.partition_graph(g, 3).shards[0], 3, edges="boundary", device="cpu")
    eop = EdgeSpMM(shard.src[:0], shard.dst[:0], 8, 8, device="cpu")
    for model in (GCN, GAT):
        for bad in ((comb, comb, comb), comb, (fused, fused), (comb, static), (comb, other)):
            with pytest.raises(ValueError, match="spmm_split"):
                model(LayerConfig(DIMS), spmm_split=bad)
        with pytest.raises(ValueError, match="edge_split"):
            model(LayerConfig(DIMS), edge_split=(eop,))
        model(LayerConfig(DIMS), spmm_split=(comb, comb))  # a well-formed pair
