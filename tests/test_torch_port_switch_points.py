"""The card's switch points (dorylus_tpu_torch/tools/switch_points.py): the
port's kernel="auto" decision around its own threshold and on per-shard
edges (2 gloo ranks), overlap="auto" per kernel (2 gloo ranks, a run with
auto bit for bit equal to the explicit resolved setting), the rules that set
the three constants, applied to made-up readings, and the tool's CPU record.

The JAX package's rule at JAX's threshold is held against the port's in
tests/test_torch_port_copies.py::test_resolve_kernel.
"""

import math

import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from dorylus_tpu_torch.common.config import AUTO_KERNEL_EDGES, resolve_kernel
from dorylus_tpu_torch.graph.graph import clustered_synthetic_graph
from dorylus_tpu_torch.graph.partition import partition_graph
from dorylus_tpu_torch.ops.hyb_plan import _LAMBDA_SLOTS
from dorylus_tpu_torch.parallel.multihost import spawn_local
from dorylus_tpu_torch.parallel.train_step import AUTO_OVERLAP
from dorylus_tpu_torch.tools import switch_points as sp

torch.set_num_threads(1)

DIMS = [16, 8, 5]
PLAN_NAMES = {("hyb", True): "fused", ("hyb", False): "ShardedHybSpMM",
              ("degree", True): "pair", ("degree", False): "ShardedDegreeSpMM",
              ("xla", True): "edge_split", ("xla", False): "edge_op"}


@pytest.fixture(scope="module")
def graph():
    return clustered_synthetic_graph(600, 8, 16, 5, seed=11, window=128, cut=0.2)


@pytest.mark.parametrize("offset,want", [(-1, "xla"), (0, "xla"), (1, "hyb")])
def test_kernel_decision_around_the_threshold(offset, want):
    """kernel="auto": the edgewise path up to the port's threshold, hyb past
    it; an explicit kernel is kept whatever the edges."""
    edges = AUTO_KERNEL_EDGES + offset
    assert resolve_kernel("auto", edges) == want
    for kernel in ("hyb", "xla", "degree"):
        assert resolve_kernel(kernel, edges) == kernel
    assert resolve_kernel("auto", edges, threshold=edges) == "xla"
    assert resolve_kernel("auto", edges, threshold=edges - 1) == "hyb"


def test_kernel_decision_reads_per_shard_edges(graph):
    """On 2 gloo ranks kernel="auto" reads the per-shard (padded) edge
    count: at a threshold equal to it, the edgewise path although the
    whole graph holds more edges; one below, hyb. Each auto run equals the
    explicit kernel's run bit for bit."""
    ep = partition_graph(graph, 2).ep
    assert ep < graph.num_edges
    base = dict(model="gcn", learning_rate=0.01, eval_every=1, reuse="off")
    runs = [(dict(base, kernel="auto"), 3, {"threshold": ep}),
            (dict(base, kernel="auto"), 3, {"threshold": ep - 1}),
            (dict(base, kernel="xla"), 3, {}),
            (dict(base, kernel="hyb"), 3, {})]
    res = spawn_local(2, ranks.engines_rank, (graph, DIMS, runs), backend="gloo",
                      device="cpu", timeout_s=240)
    at, below, xla, hyb = res[0]
    assert at["edges_per_shard"] == ep
    assert (at["kernel"], below["kernel"]) == ("xla", "hyb")
    for auto, explicit in ((at, xla), (below, hyb)):
        assert auto["losses"] == explicit["losses"]
        assert (auto["overlap"], auto["plan"]) == (explicit["overlap"], explicit["plan"])
        for k, p in auto["params"].items():
            assert np.array_equal(p, explicit["params"][k]), k


@pytest.mark.parametrize("model,lr", [("gcn", 0.01), ("gat", 0.005)])
def test_overlap_auto_per_kernel(graph, model, lr):
    """overlap="auto" resolves from AUTO_OVERLAP per kernel on 2 gloo ranks,
    and trains what the explicit resolved setting trains, bit for bit."""
    base = dict(model=model, learning_rate=lr, eval_every=1, reuse="off")
    runs = []
    for kernel in AUTO_OVERLAP:
        runs += [(dict(base, kernel=kernel), 3, {}),
                 (dict(base, kernel=kernel, overlap=AUTO_OVERLAP[kernel]), 3, {})]
    res = spawn_local(2, ranks.engines_rank, (graph, DIMS, runs), backend="gloo",
                      device="cpu", timeout_s=240)
    for r in range(2):
        for i, kernel in enumerate(AUTO_OVERLAP):
            auto, explicit = res[r][2 * i], res[r][2 * i + 1]
            want = AUTO_OVERLAP[kernel]
            assert (auto["kernel"], auto["overlap"]) == (kernel, want)
            assert auto["plan"] == explicit["plan"] == PLAN_NAMES[kernel, want]
            assert auto["losses"] == explicit["losses"]
            assert auto["accuracies"] == explicit["accuracies"]
            for k, p in auto["params"].items():
                assert np.array_equal(p, explicit["params"][k]), (kernel, k)


# ---- the rules, on made-up readings ----

def _t(median, spread=0.1):
    return {"median": median, "spread": spread}


def _point(edges, hyb, xla, hyb_run=10.0, xla_run=5.0):
    """A kernel point: warm ms of hyb and xla for both models, and their
    default_run_s."""
    def eng(ms, run):
        return {"warm_ms": _t(ms), "default_run_s": run}
    return {"edges": edges, **{m: {"hyb": eng(hyb, hyb_run), "xla": eng(xla, xla_run)}
                               for m, _ in sp.MODELS}}


M = 1_000_000


@pytest.mark.parametrize("case,points,want", [
    ("kept: hyb wins per epoch, xla's default run is shorter below 8M",
     [_point(2 * M, 1.8, 2.0), _point(4 * M, 3.5, 4.0), _point(12 * M, 7.0, 8.0)],
     (1 << 23, "kept", 2 * M)),
    ("up: hyb slower at 12M, faster from 27M",
     [_point(4 * M, 4.5, 4.0), _point(12 * M, 9.0, 8.0), _point(27 * M, 15.0, 18.0)],
     (27 * M, "up", 27 * M)),
    ("down: hyb wins per epoch and on the default run from 4M",
     [_point(2 * M, 2.0, 2.0), _point(4 * M, 3.5, 4.0, 1.0, 2.0),
      _point(7 * M, 6.0, 7.0, 1.0, 2.0), _point(12 * M, 7.0, 8.0)],
     (4 * M, "down", 4 * M)),
    ("kept: differences inside the spread",
     [_point(4 * M, 4.05, 4.0), _point(12 * M, 7.95, 8.0)], (1 << 23, "kept", None)),
])
def test_decide_kernel(case, points, want):
    got = sp.decide_kernel(points, start=1 << 23)
    assert (got["threshold"], got["move"], got["c"]) == want, case


def _overlap(fused, combined):
    """Overlap readings: every kernel's overlap plan at `fused` ms and its
    combined plan at `combined`, both models, 4 and 2 ranks."""
    per_model = {k: {plan: {"kernel_ms": _t(fused)}, "combined": {"kernel_ms": _t(combined)}}
                 for k, plan in sp.OVERLAP_PLANS.items()}
    return {f"{n} ranks": {m: per_model for m, _ in sp.MODELS} for n in (4, 2)}


@pytest.mark.parametrize("fused,combined,want", [
    (1.0, 1.5, {"hyb": True, "degree": True, "xla": True}),
    (1.5, 1.0, {"hyb": False, "degree": False, "xla": False}),
    (1.0, 1.05, {"hyb": True, "degree": False, "xla": True}),  # a tie keeps start's
])
def test_decide_overlap(fused, combined, want):
    start = {"hyb": True, "degree": False, "xla": True}
    assert sp.decide_overlap(_overlap(fused, combined), start) == want


def _lam(headline: dict, other: dict) -> dict:
    """λ readings: the headline pass and one other pass, ms per λ."""
    return {"reddit": {"K1 bf16 F=128": {str(k): _t(v) for k, v in headline.items()}},
            "largest": {"K2 bf16 F=64": {str(k): _t(v) for k, v in other.items()}},
            "reddit plan": {}}


@pytest.mark.parametrize("headline,other,want", [
    ({0: 2.0, 1 << 17: 1.5, 1 << 19: 2.0}, {0: 1.0, 1 << 17: 1.0, 1 << 19: 1.0}, 1 << 17),
    ({0: 1.4, 1 << 17: 1.5, 1 << 19: 2.0}, {0: 1.0, 1 << 17: 1.0, 1 << 19: 1.0}, 0),
    ({0: 2.0, 1 << 17: 1.5, 1 << 19: 2.0}, {0: 1.0, 1 << 17: 1.5, 1 << 19: 1.0}, 1 << 19),
    ({0: 1.95, 1 << 17: 2.05, 1 << 19: 2.0}, {0: 1.0, 1 << 17: 1.0, 1 << 19: 1.0}, 1 << 19),
], ids=["faster", "fastest-of-two", "another-pass-slower", "inside-the-spread"])
def test_decide_lambda(headline, other, want, monkeypatch):
    monkeypatch.setattr(sp, "LAMBDAS", (0, 1 << 17, 1 << 19))
    assert sp.decide_lambda(_lam(headline, other), start=1 << 19)["lam_slots"] == want


def test_pool_joins_the_runs_of_each_reading():
    """pool: each reading's runs joined, its median and spread over all of
    them, default_run_s from the pooled medians, the rest the first's."""
    def rec(setup, warm, lam):
        eng = {"kernel_selected": "hyb", "setup_s": sp.spread(setup),
               "first_epoch_s": sp.spread([0.1]), "warm_ms": sp.spread(warm)}
        return {"device": "card", "kernel_points": [
                    {"edges": 10, **{m: {key: dict(eng) for _, _, key in sp.ENGINES}
                                     for m, _ in sp.MODELS}}],
                "lambda_points": {"reddit": {"K1": {"0": dict(sp.spread(lam),
                                                               bit_equal=True)}}}}
    got = sp.pool([rec([1.0, 2.0], [5.0], [1.0]), rec([4.0], [7.0, 9.0], [3.0])])
    e = got["kernel_points"][0]["gat"]["xla"]
    assert e["setup_s"] == {"median": 2.0, "spread": 3.0, "runs": [1.0, 2.0, 4.0]}
    assert e["warm_ms"]["median"] == 7.0 and e["kernel_selected"] == "hyb"
    assert e["default_run_s"] == pytest.approx(2.0 + 0.1 + 99 * 7.0 / 1e3)
    lam = got["lambda_points"]["reddit"]["K1"]["0"]
    assert (lam["median"], lam["spread"], lam["bit_equal"]) == (2.0, 2.0, True)
    assert got["device"] == "card"


# ---- the tool's CPU record ----

def _numbers(x, path=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _numbers(v, f"{path}/{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _numbers(v, f"{path}/{i}")
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield path, x


def test_switch_points_cpu_record(capsys):
    """`main("cpu")`: one JSON line; every reading present, every number
    finite; the decisions' keys; the current constants the port's."""
    rec = sp.main("cpu")
    assert capsys.readouterr().out.strip().startswith("{")
    assert (rec["platform"], rec["device"]) == ("cpu", "cpu")
    assert rec["current"] == {"AUTO_KERNEL_EDGES": AUTO_KERNEL_EDGES,
                              "AUTO_OVERLAP": AUTO_OVERLAP, "_LAMBDA_SLOTS": _LAMBDA_SLOTS}
    assert len(rec["kernel_points"]) == len(sp.KERNEL_POINTS["cpu"])
    for p in rec["kernel_points"]:
        for m, _ in sp.MODELS:
            assert set(p[m]) == {key for _, _, key in sp.ENGINES}
            for key, kernel in (("hyb", "hyb"), ("xla", "xla"), ("hyb_bf16", "hyb")):
                e = p[m][key]
                assert e["kernel_selected"] == kernel
                for k in ("setup_s", "first_epoch_s", "warm_ms"):
                    assert len(e[k]["runs"]) == sp.REPS and e[k]["median"] > 0
                assert e["default_run_s"] > e["setup_s"]["median"]
    lam = rec["lambda_points"]
    assert set(lam) == {"reddit", "largest", "powerlaw", "reddit plan", "largest plan",
                        "powerlaw plan"}
    for case in ("reddit", "largest", "powerlaw"):
        assert set(lam[f"{case} plan"]) == {str(x) for x in sp.LAMBDAS}
        for label, by_lam in lam[case].items():
            assert set(by_lam) == {str(x) for x in sp.LAMBDAS}
            assert by_lam[str(sp.JAX_LAMBDA)]["bit_equal"]
        for st in lam[f"{case} plan"].values():
            assert st["launches_per_pass"] == math.ceil(st["parts"] / 56)
    assert len(lam["reddit"]) == 4 and len(lam["largest"]) == 2
    for n in sp.PARTITIONS:
        part = rec["overlap_points"][f"{n} ranks"]
        assert len(part["edges_per_shard"]) == n
        for m, _ in sp.MODELS:
            for kernel, plan in sp.OVERLAP_PLANS.items():
                assert set(part[m][kernel]) == {plan, "combined"}
    d = rec["decisions"]
    assert set(d) == {"AUTO_KERNEL_EDGES", "AUTO_OVERLAP", "_LAMBDA_SLOTS"}
    assert set(d["AUTO_OVERLAP"]) == set(AUTO_OVERLAP)
    bad = [(p, x) for p, x in _numbers(rec) if not math.isfinite(x)]
    assert not bad, bad
