"""The port's benchmark (dorylus_tpu_torch/bench.py) against the repo's
bench.py, on the CPU (one run of `main("cpu")` at bench.py's CPU scale,
~90-140 s here; the rest ~10 s):

  * its JSON's key set is bench.py's, read from bench.py's AST (the printed
    object and, on the card, the reuse cells' dicts) without importing
    jax, with the port's extras listed by name; every number finite > 0;
  * its graph is bench.py's `build_graph` on the same seed, renumbered as
    bench.py renumbers it;
  * the reuse cell's host work on small community graphs mines what JAX's
    `mine_reuse` mines; its plans survive the .npz; the cell's passes (the
    plain versions here) agree with the plain operator; the community
    epoch cells' keys;
  * the live slot rows the gather bound copies are the graph's sources;
  * `main()` without a card raises; a `gpu`-marked test runs the card's
    path at a small scale.
"""

import ast
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from dorylus_tpu_torch import bench

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
# The port's extras beside bench.py's keys.
PORT_EXTRAS = {"device", "torch_sparse_mm_edges_per_s", "epoch_timing"}
PORT_REUSE_EXTRAS = {"reuse_miner", "reuse_reddit_community_row_cut",
                     "reuse_reddit_community_mine_s"}
STRINGS = {"platform", "device", "kernel", "epoch_timing", "reuse_miner"}


def bench_py_keys() -> tuple[set, set, set]:
    """(top-level keys, extras keys, the reuse cells' keys) of the object
    bench.py prints, from its AST."""
    tree = ast.parse((REPO / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")

    def keys(d: ast.Dict) -> set:
        return {k.value for k in d.keys if isinstance(k, ast.Constant)}

    printed = next(n for n in ast.walk(main) if isinstance(n, ast.Dict)
                   and "metric" in keys(n))
    extras = next(v for k, v in zip(printed.keys, printed.values)
                  if isinstance(k, ast.Constant) and k.value == "extras")
    reuse = set()
    for n in ast.walk(main):
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and any(getattr(t, "id", None) == "reuse_extras" for t in n.targets)):
            reuse |= keys(n.value)
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "update"
                and getattr(n.func.value, "id", None) == "reuse_extras"):
            reuse |= keys(n.args[0])
    return keys(printed), keys(extras), reuse


def load_bench_py():
    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def numbers_ok(extras: dict) -> None:
    for k, x in extras.items():
        if k in STRINGS:
            assert isinstance(x, str) and x, (k, x)
        else:
            assert isinstance(x, (int, float)) and math.isfinite(x) and x > 0, (k, x)


@pytest.fixture(scope="module")
def cpu_run():
    return bench.main("cpu")


def test_bench_py_keys_read():
    """bench.py's keys, from its AST, are the ones the port's bench lists
    (chip_smoke.py checks the card's record against those)."""
    top, extras, reuse = bench_py_keys()
    assert top == {"metric", "value", "unit", "vs_baseline", "extras"}
    assert extras == set(bench.BENCH_PY_EXTRAS) and reuse == set(bench.BENCH_PY_REUSE)
    assert {"spmm_ms", "gather_bound_edges_per_s", "gat_reddit_config_epoch_bf16_ms"} <= extras
    assert {"reuse_largev_V", "reuse_row_cut", "reuse_mine_s",
            "reuse_reddit_community_speedup"} <= reuse and len(reuse) == 10


def test_cpu_run_has_bench_py_keys(cpu_run):
    """bench.py has no reuse cells off the TPU; the port none off the card."""
    top, extras, _ = bench_py_keys()
    assert set(cpu_run) == top
    assert set(cpu_run["extras"]) == extras | PORT_EXTRAS
    assert cpu_run["metric"] == "spmm_aggregation_edges_per_s_per_chip"
    assert cpu_run["unit"] == "edges/s"
    assert cpu_run["extras"]["platform"] == "cpu"
    numbers_ok(cpu_run["extras"])
    assert math.isfinite(cpu_run["value"]) and cpu_run["value"] > 0
    assert cpu_run["vs_baseline"] == pytest.approx(
        cpu_run["value"] / cpu_run["extras"]["cpu_scipy_edges_per_s"])
    assert cpu_run["value"] == pytest.approx(
        cpu_run["extras"]["num_edges"] / (cpu_run["extras"]["spmm_ms"] * 1e-3))


def test_cpu_run_graph_is_bench_py(cpu_run):
    """bench.py's CPU scale: V 23,296, degree 20, its seed; the graph arrays
    equal bench.py's after the same renumbering."""
    from dorylus_tpu.graph.reorder import apply_order, degree_order

    jb = load_bench_py()
    jg = jb.build_graph(23_296, 20, 602, 41, seed=1)
    jg = apply_order(jg, degree_order(jg, ascending=True))
    assert (cpu_run["extras"]["num_vertices"], cpu_run["extras"]["num_edges"]) == \
        (jg.num_vertices, jg.num_edges) == (23_296, 465_920)
    g = bench.bench_graph(23_296, 20)
    for k in ("src", "dst", "features", "labels", "edge_norm"):
        np.testing.assert_array_equal(getattr(g, k), getattr(jg, k))


@pytest.mark.parametrize("v,deg,comm,core", [(3000, 15, 100, 20), (2000, 10, 40, 15)])
def test_reuse_cell_mines_what_jax_mines(v, deg, comm, core):
    """largev_host's graph and rewrite against JAX's community_core_edges
    and mine_reuse(min_uses=3, passes=2); the plans through the .npz's flat
    arrays; the cell on the CPU (plain passes): the rewrite's pass equals
    the plain operator's within the bf16 limit."""
    from dorylus_tpu.graph.graph import community_core_edges
    from dorylus_tpu.graph.reuse import mine_reuse

    host = bench.largev_host(v, deg, comm=comm, core=core, p_core=0.85, seed=0)
    src, dst = community_core_edges(v, deg, comm=comm, core=core, p_core=0.85, seed=0)
    plan = mine_reuse(src, dst, v, min_uses=3, passes=2)
    assert int(host["e"]) == len(src)
    assert float(host["row_cut"]) == plan.stats["row_reduction"] > 0.1
    assert int(host["num_pairs"]) == plan.num_pairs > 0
    assert int(host["table_size"]) == plan.table_size
    assert int(host["n_levels"]) == len(plan.levels) == 2
    for i, lv in enumerate(plan.levels):
        np.testing.assert_array_equal(host[f"level{i}"], lv)
    from dorylus_tpu_torch.ops.hyb_plan import build_hyb_plan
    from dorylus_tpu_torch.ops.hyb_spmm import _upload, hyb_mask_pass

    h = torch.randn(v, 8, generator=torch.Generator().manual_seed(1))
    direct = _upload(build_hyb_plan(src, dst, None, v), v, torch.float32, torch.device("cpu"))
    back = _upload(bench._plan_of(host, "plain_"), v, torch.float32, torch.device("cpu"))
    assert torch.equal(hyb_mask_pass(h, back, v), hyb_mask_pass(h, direct, v))
    cell = bench.largev_cell(host, torch.device("cpu"), iters=1)
    _, _, reuse = bench_py_keys()
    assert set(cell) == {k for k in reuse if not k.startswith("reuse_reddit")} | {"reuse_miner"}
    numbers_ok(cell)
    assert cell["reuse_largev_V"] == v and cell["reuse_row_cut"] == float(host["row_cut"])


def test_community_cells_keys():
    """The community epoch pair on a 1,200-vertex community graph: bench.py's
    keys, the rewrite's cut above 0."""
    cg = bench.community_graph(1200, 12, feat=bench.FEAT, comm=40, core=20, p_core=0.85,
                               seed=0)
    cells = bench.community_cells(cg, torch.device("cpu"))
    _, _, reuse = bench_py_keys()
    assert set(cells) == ({k for k in reuse if k.startswith("reuse_reddit")}
                          | PORT_REUSE_EXTRAS)
    numbers_ok(cells)
    assert cells["reuse_reddit_community_speedup"] == pytest.approx(
        cells["reuse_reddit_community_epoch_off_ms"] / cells["reuse_reddit_community_epoch_ms"])


def test_gather_rows_are_the_sources():
    """The rows the gather bound copies are the live slots' sources: the
    graph's src, one per edge; laid out as P3's streams, wrapped at the end."""
    g = bench.bench_graph(2000, 6)
    op = bench.HybSpMM(g.src, g.dst, 2000, 2000, gather_dtype=torch.bfloat16,
                       static_val=g.edge_norm, device="cpu")
    rows = bench.live_rows(op.fwd)
    np.testing.assert_array_equal(np.sort(rows.numpy()), np.sort(g.src))
    idx = bench.gather_streams(rows, 7)
    assert idx.shape == (7, math.ceil(g.num_edges / 7)) and idx.dtype == torch.int32
    assert torch.equal(idx.flatten()[:g.num_edges], rows)
    assert torch.equal(idx.flatten()[g.num_edges:], rows[:idx.numel() - g.num_edges])


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runs on the card by default"):
        bench.main()


@pytest.mark.gpu
def test_card_path(monkeypatch):
    """bench.main() on the card at a small scale: every cell, the reuse
    cells included, each checked against its plain version; bench.py's
    keys with the port's extras."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    monkeypatch.setitem(bench.SCALES, "cuda", dict(v=20_000, deg=20, iters=3))
    monkeypatch.setattr(bench, "LARGEV", dict(bench.LARGEV, v=40_000))
    res = bench.main()
    top, extras, reuse = bench_py_keys()
    assert set(res) == top
    assert set(res["extras"]) == extras | reuse | PORT_EXTRAS | PORT_REUSE_EXTRAS
    assert res["extras"]["platform"] == "gpu"
    numbers_ok(res["extras"])
