"""The port's own copies of the JAX package's host-side modules, each
pinned to its original: the same inputs give the same arrays, field for
field and bit for bit (the copies are numpy code moved, not rewritten, so
every comparison is exact).

    common/config.py   TrainConfig / LayerConfig fields and defaults,
                       resolve_kernel, the split portions
    common/metrics.py  RunReport's summary and JSON
    graph/graph.py     synthetic_graph, clustered_synthetic_graph,
                       community_core_edges, build_graph (bench.py's)
    graph/reorder.py   degree_order, bfs_order, apply_order
    graph/reuse.py     mine_reuse
    graph/dataio.py    the bsnap readers and writers (bytes and arrays),
                       load_dataset on the vendored datasets,
                       prepare_from_text, the text edge parsers, the parts
                       files, the int32-range and endpoint checks
    graph/partition.py partition_graph (range and hash, for_gat both ways),
                       every Shard field, build_recv_plan, the shard files
    models/init.py     the reference initializers
    engine/convergence.py  ConvergeMonitor
    native.py          the same library, the same answers
    tools/scale_pipeline.py  gen_graph (the JAX package's tools/ copy)
"""

import dataclasses
import struct
from pathlib import Path

import numpy as np
import pytest

import bench
from dorylus_tpu import native as jnative
from dorylus_tpu.common import config as jconfig
from dorylus_tpu.common import metrics as jmetrics
from dorylus_tpu.engine import convergence as jconv
from dorylus_tpu.graph import dataio as jdataio
from dorylus_tpu.graph import graph as jgraph
from dorylus_tpu.graph import partition as jpart
from dorylus_tpu.graph import reorder as jreorder
from dorylus_tpu.graph import reuse as jreuse
from dorylus_tpu.models import init as jinit
from dorylus_tpu.parallel import halo as jhalo
from dorylus_tpu_torch import native as tnative
from dorylus_tpu_torch.common import config as tconfig
from dorylus_tpu_torch.common import metrics as tmetrics
from dorylus_tpu_torch.engine import convergence as tconv
from dorylus_tpu_torch.graph import dataio as tdataio
from dorylus_tpu_torch.graph import graph as tgraph
from dorylus_tpu_torch.graph import partition as tpart
from dorylus_tpu_torch.graph import reorder as treorder
from dorylus_tpu_torch.graph import reuse as treuse
from dorylus_tpu_torch.models import init as tinit


def same(a, b, what=""):
    """Exact equality of two values of the same kind: arrays by dtype,
    shape and content; dataclasses field by field; containers by item."""
    if dataclasses.is_dataclass(a):
        names = [f.name for f in dataclasses.fields(a)]
        assert names == [f.name for f in dataclasses.fields(b)], what
        for n in names:
            same(getattr(a, n), getattr(b, n), f"{what}.{n}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, \
            f"{what}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            same(a[k], b[k], f"{what}[{k!r}]")
    else:
        assert a == b or (a != a and b != b), f"{what}: {a!r} vs {b!r}"


def to_port(g):
    """The JAX package's Graph as the port's (same fields, by name)."""
    return tgraph.Graph(**{f.name: getattr(g, f.name) for f in dataclasses.fields(g)})


# ---- common ----


@pytest.mark.parametrize("name", ["TrainConfig", "LayerConfig", "RunConfig"])
def test_config_fields_and_defaults(name):
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    jf, tf = dataclasses.fields(j), dataclasses.fields(t)
    assert [f.name for f in jf] == [f.name for f in tf]
    for a, b in zip(jf, tf):
        assert a.type == b.type, a.name
        assert a.default == b.default, a.name
        if a.default_factory is not dataclasses.MISSING:
            da, db = a.default_factory(), b.default_factory()
            if dataclasses.is_dataclass(da):
                da, db = dataclasses.asdict(da), dataclasses.asdict(db)
            assert da == db, a.name


def test_config_constants_presets_and_json():
    assert (jconfig.TRAIN_PORTION, jconfig.VAL_PORTION) == \
        (tconfig.TRAIN_PORTION, tconfig.VAL_PORTION)
    a = jconfig.TrainConfig(epochs=7, model="gat", halo="ragged")
    b = tconfig.TrainConfig.from_json(a.to_json())
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert b.to_json() == a.to_json()
    la, lb = jconfig.LayerConfig([602, 128, 41]), tconfig.LayerConfig([602, 128, 41])
    assert (la.num_layers, la.feature_dim, la.num_classes) == \
        (lb.num_layers, lb.feature_dim, lb.num_classes)
    for preset in ("reddit", "reddit-small"):
        try:
            want = jconfig.LayerConfig.preset(preset).dims
        except (KeyError, ValueError):
            with pytest.raises((KeyError, ValueError)):
                tconfig.LayerConfig.preset(preset)
        else:
            assert tconfig.LayerConfig.preset(preset).dims == want


@pytest.mark.parametrize("kernel", ["auto", "hyb", "xla", "degree"])
@pytest.mark.parametrize("edges", [0, 1000, 7_999_999, 8_000_000, 8_000_001, 1 << 30])
def test_resolve_kernel(kernel, edges):
    """JAX's rule at JAX's threshold (the port's own threshold is the card's,
    tests/test_torch_port_switch_points.py)."""
    assert tconfig.resolve_kernel(kernel, edges, threshold=jconfig.AUTO_KERNEL_EDGES) == \
        jconfig.resolve_kernel(kernel, edges)


def test_run_report():
    reps = []
    for m in (jmetrics, tmetrics):
        rep = m.RunReport()
        for e in range(4):
            rep.add_epoch(m.EpochRecord(e, 10.0 + e, loss=1.0 / (e + 1),
                                        accuracy=0.5 if e % 2 else None))
        rep.final_accuracy, rep.test_accuracy, rep.total_time_s = 0.75, 0.7, 1.5
        rep.notes["kernel"] = "hyb"
        reps.append(rep)
    assert reps[0].summary() == reps[1].summary()
    assert reps[0].to_json() == reps[1].to_json()
    assert reps[0].avg_epoch_ms == reps[1].avg_epoch_ms


# ---- graph ----


@pytest.mark.parametrize("make,args", [
    ("synthetic_graph", (300, 6, 16, 5)),
    ("synthetic_graph", (1000, 8, 32, 6)),
    ("clustered_synthetic_graph", (600, 8, 12, 4)),
])
def test_graph_generators(make, args):
    for seed in (0, 42):
        same(to_port(getattr(jgraph, make)(*args, seed=seed)),
             getattr(tgraph, make)(*args, seed=seed), make)


@pytest.mark.parametrize("edges,deg", [(20_000, 16), (50_000, 8)])
def test_scale_pipeline_gen_graph(edges, deg):
    """dorylus_tpu_torch/tools/scale_pipeline.py `gen_graph` against the
    JAX package's tools/scale_pipeline.py one."""
    import importlib.util

    from dorylus_tpu_torch.tools import scale_pipeline as tscale

    spec = importlib.util.spec_from_file_location(
        "jax_scale_pipeline", Path(__file__).resolve().parent.parent / "tools" /
        "scale_pipeline.py")
    jscale = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jscale)
    same(to_port(jscale.gen_graph(edges, deg, 8, 16)), tscale.gen_graph(edges, deg, 8, 16),
         "gen_graph")


def test_graph_methods():
    gj = jgraph.synthetic_graph(200, 5, 8, 3, seed=1)
    gt = tgraph.synthetic_graph(200, 5, 8, 3, seed=1)
    assert gj.num_edges == gt.num_edges and gj.split_bounds() == gt.split_bounds()
    same(list(gj.masks()), list(gt.masks()), "masks")
    same(gj.dense_norm_adj(), gt.dense_norm_adj(), "dense_norm_adj")
    rng = np.random.default_rng(0)
    s, d = rng.integers(0, 50, 200).astype(np.int32), rng.integers(0, 50, 200).astype(np.int32)
    same(list(jgraph.Graph.make_undirected(s, d)), list(tgraph.Graph.make_undirected(s, d)),
         "make_undirected")


@pytest.mark.parametrize("kw", [dict(), dict(comm=40, core=30, p_core=0.85, seed=0),
                                dict(comm=30, core=15, seed=2)])
def test_community_core_edges(kw):
    same(list(jgraph.community_core_edges(800, 12, **kw)),
         list(tgraph.community_core_edges(800, 12, **kw)), "community_core_edges")


def test_build_graph_is_the_bench_graph():
    same(to_port(bench.build_graph(3000, 20, 24, 7, seed=1)),
         tgraph.build_graph(3000, 20, 24, 7, seed=1), "build_graph")


@pytest.mark.parametrize("ascending", [False, True])
def test_reorder(ascending):
    gj = bench.build_graph(2000, 10, 8, 5, seed=3)
    gt = tgraph.build_graph(2000, 10, 8, 5, seed=3)
    oj, ot = jreorder.degree_order(gj, ascending), treorder.degree_order(gt, ascending)
    same(oj, ot, "degree_order")
    same(to_port(jreorder.apply_order(gj, oj)), treorder.apply_order(gt, ot), "apply_order")
    same(jreorder.bfs_order(gj), treorder.bfs_order(gt), "bfs_order")


@pytest.mark.parametrize("passes,max_pairs", [(1, 0), (2, 0), (2, 60)])
def test_mine_reuse(passes, max_pairs):
    src, dst = tgraph.community_core_edges(1500, 16, comm=40, core=30, p_core=0.85, seed=0)
    pj = jreuse.mine_reuse(src, dst, 1500, min_uses=3, passes=passes, max_pairs=max_pairs)
    pt = treuse.mine_reuse(src, dst, 1500, min_uses=3, passes=passes, max_pairs=max_pairs)
    assert pt.num_pairs == pj.num_pairs > 0
    same(pj.levels, pt.levels, "levels")
    same(pj.src, pt.src, "src")
    same(pj.dst, pt.dst, "dst")
    assert (pj.num_vertices, pj.table_size) == (pt.num_vertices, pt.table_size)
    same(pj.stats, pt.stats, "stats")
    h = np.random.default_rng(1).normal(size=(1500, 4)).astype(np.float32)
    same(pj.build_table_np(h), pt.build_table_np(h), "build_table_np")


# ---- partition ----


def _hub_graph(v=403, seed=5):
    """Zipf in-degrees on V not divisible by 4, hubs spread over the ids."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.6, v), 120)
    dst = np.sort(np.repeat(rng.permutation(v).astype(np.int32), deg))
    src = rng.integers(0, v, size=len(dst)).astype(np.int32)
    kw = dict(num_vertices=v, src=src, dst=dst,
              features=rng.normal(size=(v, 6)).astype(np.float32),
              labels=(np.arange(v) % 3).astype(np.int32), num_classes=3)
    return jgraph.Graph(**kw).finalize(), tgraph.Graph(**kw).finalize()


@pytest.mark.parametrize("for_gat", [False, True], ids=["gcn", "gat"])
@pytest.mark.parametrize("method", ["range", "hash"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_partition_graph(n, method, for_gat):
    gj, gt = _hub_graph()
    sj = jpart.partition_graph(gj, n, method=method, for_gat=for_gat)
    st = tpart.partition_graph(gt, n, method=method, for_gat=for_gat)
    same(sj, st, "ShardedGraph")  # every scalar, and every field of every Shard
    same(jpart.assign_partitions(gj, n, method), tpart.assign_partitions(gt, n, method),
         "assign_partitions")


def test_partition_with_given_parts():
    gj, gt = _hub_graph(seed=9)
    parts = np.random.default_rng(2).integers(0, 3, gj.num_vertices).astype(np.int32)
    same(jpart.partition_graph(gj, 3, parts=parts), tpart.partition_graph(gt, 3, parts=parts),
         "parts")


def test_build_recv_plan_and_ghost_counts():
    from dorylus_tpu_torch.parallel import halo as thalo

    gj, gt = _hub_graph()
    sj, st = jpart.partition_graph(gj, 4, method="hash"), tpart.partition_graph(gt, 4,
                                                                                 method="hash")
    for a, b in zip(sj.shards, st.shards):
        same(list(jhalo.build_recv_plan(a.send_idx)), list(tpart.build_recv_plan(b.send_idx)),
             "build_recv_plan")
    # the exact per-pair counts a rank derives from its own shard are the
    # stacked ragged plan's
    recv_sz = jhalo.build_ragged_plan(sj)["recv_sz"]
    for p, b in enumerate(st.shards):
        same(recv_sz[p].astype(np.int64), thalo.ghost_counts(b, 4, st.vp, st.max_h),
             "ghost_counts")


def test_shard_files_round_trip(tmp_path):
    _, gt = _hub_graph()
    sg = tpart.partition_graph(gt, 4, for_gat=True)
    meta = tpart.ShardMeta.of(sg)
    assert (meta.vp, meta.ep, meta.max_h, meta.denom) == (sg.vp, sg.ep, sg.max_h, sg.denom)
    for s in sg.shards:
        path = tmp_path / f"shard_{s.shard_id}.npz"
        tpart.save_shard(path, s, meta)
        got, gmeta = tpart.load_shard(path)
        assert gmeta == meta
        e = s.num_edges
        for name in tpart._SHARD_ARRAYS:
            want = getattr(s, name)
            same(want[:e] if name in ("src", "dst", "edge_val") else want,
                 getattr(got, name), name)
        assert (got.shard_id, got.num_local, got.num_edges, got.num_int) == \
            (s.shard_id, s.num_local, s.num_edges, s.num_int)


# ---- models/init, engine/convergence, native ----


@pytest.mark.parametrize("fn", ["xavier_reference", "kaiming_reference", "xavier_fast",
                                "xavier"])
def test_initializers(fn):
    for d1, d2, seed in ((16, 8, 8888), (41, 1, 8889), (7, 13, 3)):
        same(getattr(jinit, fn)(d1, d2, seed), getattr(tinit, fn)(d1, d2, seed), fn)


def test_minstd_engine():
    a, b = jinit.MinStd0(8888), tinit.MinStd0(8888)
    assert [a.next() for _ in range(50)] == [b.next() for _ in range(50)]
    assert [a.uniform(-1, 2) for _ in range(20)] == [b.uniform(-1, 2) for _ in range(20)]
    assert [a.normal_pair() for _ in range(20)] == [b.normal_pair() for _ in range(20)]


@pytest.mark.parametrize("target,switch", [(None, 0.02), (0.9, 0.02), (0.5, 0.3)])
def test_converge_monitor(target, switch):
    accs = [None, 0.1, 0.3, None, 0.45, 0.6, 0.88, 0.89, 0.95, 0.2]
    a, b = jconv.ConvergeMonitor(target, switch), tconv.ConvergeMonitor(target, switch)
    for acc in accs:
        assert a.update(acc).name == b.update(acc).name
        assert (a.synchronous, a.done) == (b.synchronous, b.done)
    assert [s.name for s in jconv.ConvergeState] == [s.name for s in tconv.ConvergeState]


def test_native_bindings():
    assert tnative.available() == jnative.available()
    assert tnative.has_mine_pairs() == jnative.has_mine_pairs()
    rng = np.random.default_rng(0)
    src = rng.integers(0, 300, 4000).astype(np.int32)
    dst = rng.integers(0, 300, 4000).astype(np.int32)
    if tnative.available():
        same(jnative.sort_by_dst(dst, 300), tnative.sort_by_dst(dst, 300), "sort_by_dst")
        same(list(jnative.gcn_norms(src, dst, 300)), list(tnative.gcn_norms(src, dst, 300)),
             "gcn_norms")


# ---- graph/dataio ----

DATA = Path(__file__).parent / "data"


@pytest.mark.parametrize("name", ["digits", "golden"])
@pytest.mark.parametrize("undirected", [True, False])
def test_load_dataset(name, undirected):
    same(to_port(jdataio.load_dataset(DATA / name, undirected=undirected)),
         tdataio.load_dataset(DATA / name, undirected=undirected), "load_dataset")


@pytest.mark.parametrize("name", ["digits", "golden"])
def test_bsnap_readers(name):
    d = DATA / name
    same(list(jdataio.read_graph_bsnap(d / "graph.bsnap")),
         list(tdataio.read_graph_bsnap(d / "graph.bsnap")), "read_graph_bsnap")
    same(jdataio.read_features_bsnap(d / "features.bsnap"),
         tdataio.read_features_bsnap(d / "features.bsnap"), "read_features_bsnap")
    same(list(jdataio.read_labels_bsnap(d / "labels.bsnap")),
         list(tdataio.read_labels_bsnap(d / "labels.bsnap")), "read_labels_bsnap")


def test_save_dataset_writes_the_same_bytes(tmp_path):
    g = tgraph.synthetic_graph(150, 5, 6, 3, seed=4)
    jdataio.save_dataset(tmp_path / "j", jgraph.synthetic_graph(150, 5, 6, 3, seed=4))
    tdataio.save_dataset(tmp_path / "t", g)
    for f in ("graph.bsnap", "features.bsnap", "labels.bsnap"):
        assert (tmp_path / "j" / f).read_bytes() == (tmp_path / "t" / f).read_bytes(), f
    same(to_port(jdataio.load_dataset(tmp_path / "t")), tdataio.load_dataset(tmp_path / "j"),
         "cross load")


def test_parts_files_and_features_text(tmp_path):
    parts = np.random.default_rng(3).integers(0, 4, 97).astype(np.int32)
    jdataio.write_parts_file(tmp_path / "j.parts", parts)
    tdataio.write_parts_file(tmp_path / "t.parts", parts)
    assert (tmp_path / "j.parts").read_bytes() == (tmp_path / "t.parts").read_bytes()
    same(jdataio.read_parts_file(tmp_path / "t.parts"), tdataio.read_parts_file(tmp_path / "j.parts"),
         "read_parts_file")
    src = DATA / "golden" / "features.bsnap"
    jdataio.features_to_text(src, tmp_path / "j.txt")
    tdataio.features_to_text(src, tmp_path / "t.txt")
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()


_EDGE_TEXT = """# comment line
% another comment
0 1
1 2 extra_col 99
3 3
5\t7
   8 9
bogus line
12
1 2.5
-1 2
3000000000 5
12x 5
12 5x
2147483647 1
2147483648 1
13 14"""


@pytest.mark.parametrize("parser", ["read_text_edges", "_read_text_edges_py"])
def test_text_edge_parsers(tmp_path, parser):
    p = tmp_path / "edges.txt"
    p.write_text(_EDGE_TEXT)
    got = list(getattr(tdataio, parser)(p))
    same(list(getattr(jdataio, parser)(p)), got, parser)
    assert list(zip(got[0].tolist(), got[1].tolist()))[:2] == [(0, 1), (1, 2)]


@pytest.mark.parametrize("undirected", [True, False])
def test_prepare_from_text(tmp_path, undirected):
    rng = np.random.default_rng(8)
    edges = rng.integers(0, 60, (300, 2))
    np.savetxt(tmp_path / "e.txt", edges, fmt="%d")
    np.savetxt(tmp_path / "f.txt", rng.normal(size=(60, 5)), fmt="%.6f")
    np.savetxt(tmp_path / "l.txt", rng.integers(0, 4, 60), fmt="%d")
    args = [tmp_path / "e.txt", tmp_path / "f.txt", tmp_path / "l.txt"]
    gj = jdataio.prepare_from_text(*args, tmp_path / "j", feature_dim=5, label_kinds=4,
                                   undirected=undirected)
    gt = tdataio.prepare_from_text(*args, tmp_path / "t", feature_dim=5, label_kinds=4,
                                   undirected=undirected)
    same(to_port(gj), gt, "prepare_from_text")
    for f in ("graph.bsnap", "features.bsnap", "labels.bsnap"):
        assert (tmp_path / "j" / f).read_bytes() == (tmp_path / "t" / f).read_bytes(), f


@pytest.mark.parametrize("case", ["vertex_range", "endpoint", "no_edges", "coverage"])
def test_dataio_refusals(tmp_path, case):
    """The checks of the reference's fix 2549ce5: vertex counts past the
    int32 range and endpoints past num_vertices refuse to load; a text
    edge list with no edge, or features and labels that do not cover the
    vertices, refuse to prepare. Both packages raise ValueError alike."""
    if case in ("vertex_range", "endpoint"):
        num_v = 2**31 if case == "vertex_range" else 10
        path = tmp_path / "g.bsnap"
        with open(path, "wb") as f:
            f.write(struct.pack("<iIQ", 4, num_v, 2))
            f.write(np.array([[0, 1], [3, 10]], "<u4").tobytes())
        def call(m):
            return m.read_graph_bsnap(path)
    else:
        (tmp_path / "e.txt").write_text("# nothing\n3 3\n" if case == "no_edges" else "0 5\n")
        (tmp_path / "f.txt").write_text("1 2\n3 4\n")
        (tmp_path / "l.txt").write_text("0\n1\n")

        def call(m):
            return m.prepare_from_text(tmp_path / "e.txt", tmp_path / "f.txt",
                                       tmp_path / "l.txt", tmp_path / "out",
                                       feature_dim=2, label_kinds=2)
    msgs = []
    for m in (jdataio, tdataio):
        with pytest.raises(ValueError) as err:
            call(m)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
