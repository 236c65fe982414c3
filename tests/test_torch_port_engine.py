"""dorylus_tpu_torch Engine against dorylus_tpu's Engine and the golden
trajectory (CPU), its refusals, and the port's independence from jax.

Tolerances: 5-epoch GCN train loss against JAX atol 1e-4 with f32
aggregation (only summation orders differ) and 1e-3 with bf16 gather tables
(~1e-3 relative per pass); GAT, whose losses are O(100) at init, relative:
rtol 1e-5 in f32 and 5e-3 with bf16 gather tables; val accuracy equal up
to one vertex per epoch; the golden trajectory within tests/test_golden.py's
bounds.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.graph.dataio import load_dataset
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu_torch.engine.engine import Engine as TEngine

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN_DIR = Path(__file__).parent / "data" / "golden"


@pytest.mark.parametrize("agg_dtype", ["float32", "bfloat16"])
def test_engine_trajectory_matches_jax(agg_dtype):
    from dorylus_tpu.engine.engine import Engine as JEngine

    g = synthetic_graph(400, 6, 24, 5, seed=31)
    layers = LayerConfig([24, 12, 5])
    cfg = TrainConfig(epochs=5, eval_every=1, kernel="hyb", reuse="off",
                      agg_dtype=agg_dtype, compile_cache="off")
    jrep = JEngine(g, layers, cfg).run()
    trep = TEngine(g, layers, cfg, device="cpu").run()
    assert len(trep.epochs) == len(jrep.epochs) == 5
    jl = [e.loss for e in jrep.epochs]
    tl = [e.loss for e in trep.epochs]
    n_val = int(g.masks()[1].sum())
    if agg_dtype == "float32":
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    else:  # bf16 gather tables: ~1e-3 relative on each aggregation
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-3)
    for je, te in zip(jrep.epochs, trep.epochs):
        assert abs(je.accuracy - te.accuracy) <= 1.0 / n_val + 1e-9
    assert abs(jrep.final_accuracy - trep.final_accuracy) <= 1.0 / n_val + 1e-9
    assert trep.notes["kernel"] == "hyb" and trep.notes["device"] == "cpu"


@pytest.mark.parametrize("model,kernel,agg_dtype", [
    ("gat", "hyb", "float32"), ("gat", "hyb", "bfloat16"),
    ("gcn", "auto", "float32"), ("gat", "auto", "float32"),
], ids=["gat-hyb-f32", "gat-hyb-bf16", "gcn-auto", "gat-auto"])
def test_engine_gat_and_edgewise_match_jax(model, kernel, agg_dtype):
    """GAT on the mask-mode hyb kernel, and both models on the default
    kernel ("auto" -> xla below 8M edges: the edgewise CSR op)."""
    from dorylus_tpu.engine.engine import Engine as JEngine

    g = synthetic_graph(400, 6, 24, 5, seed=37)
    layers = LayerConfig([24, 12, 5])
    cfg = TrainConfig(epochs=5, eval_every=1, kernel=kernel, reuse="off",
                      model=model, agg_dtype=agg_dtype, compile_cache="off",
                      learning_rate=0.005 if model == "gat" else 0.01)
    jrep = JEngine(g, layers, cfg).run()
    teng = TEngine(g, layers, cfg, device="cpu")
    trep = teng.run()
    jl = [e.loss for e in jrep.epochs]
    tl = [e.loss for e in trep.epochs]
    if model == "gcn":
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    else:
        assert jl[0] > 10 and tl[-1] < tl[0]
        np.testing.assert_allclose(tl, jl, rtol=5e-3 if agg_dtype == "bfloat16"
                                   else 1e-5)
    n_val = int(g.masks()[1].sum())
    for je, te in zip(jrep.epochs, trep.epochs):
        assert abs(je.accuracy - te.accuracy) <= 1.0 / n_val + 1e-9
    assert trep.notes["kernel"] == jrep.notes["kernel"] == ("hyb" if kernel == "hyb"
                                                            else "xla")
    # hyb ships COO stubs (the plans carry what aggregation reads); the
    # edgewise path reads the COO arrays
    assert teng.batch.src.shape[0] == (0 if kernel == "hyb" else g.num_edges)


def test_engine_sgd_decay_eval_cadence_match_jax():
    from dorylus_tpu.engine.engine import Engine as JEngine

    g = synthetic_graph(300, 5, 16, 4, seed=33)
    layers = LayerConfig([16, 8, 4])
    cfg = TrainConfig(epochs=5, eval_every=2, kernel="hyb", reuse="off",
                      adam=False, learning_rate=0.5, lr_decay_every=2,
                      compile_cache="off")
    jrep = JEngine(g, layers, cfg).run()
    trep = TEngine(g, layers, cfg, device="cpu").run()
    np.testing.assert_allclose([e.loss for e in trep.epochs],
                               [e.loss for e in jrep.epochs], rtol=0, atol=1e-4)
    # eval on epochs 0, 2 and the last one only
    assert [e.accuracy is not None for e in trep.epochs] == \
        [True, False, True, False, True]


def test_engine_hits_golden_trajectory():
    spec = json.loads((GOLDEN_DIR / "golden.json").read_text())
    g = load_dataset(GOLDEN_DIR, feature_dim=spec["dims"][0])
    cfg = TrainConfig(epochs=spec["epochs"], learning_rate=spec["lr"],
                      eval_every=1, kernel="hyb")
    report = TEngine(g, LayerConfig(spec["dims"]), cfg, device="cpu").run()
    losses = [e.loss for e in report.epochs]
    accs = [e.accuracy for e in report.epochs]
    np.testing.assert_allclose(losses, spec["train_loss"], rtol=0, atol=0.02)
    assert np.max(np.abs(np.array(accs) - np.array(spec["val_acc"]))) <= 0.055
    assert abs(report.test_accuracy - spec["test_acc"]) <= 0.055


def test_engine_default_config_hits_golden_trajectory():
    """The golden fixture's own configuration: kernel="auto", which
    resolves to the edgewise path at its size (as tests/test_golden.py
    runs the JAX engine)."""
    spec = json.loads((GOLDEN_DIR / "golden.json").read_text())
    g = load_dataset(GOLDEN_DIR, feature_dim=spec["dims"][0])
    cfg = TrainConfig(epochs=spec["epochs"], learning_rate=spec["lr"],
                      eval_every=1)
    report = TEngine(g, LayerConfig(spec["dims"]), cfg, device="cpu").run()
    assert report.notes["kernel"] == "xla"
    losses = [e.loss for e in report.epochs]
    accs = [e.accuracy for e in report.epochs]
    np.testing.assert_allclose(losses, spec["train_loss"], rtol=0, atol=0.02)
    assert np.max(np.abs(np.array(accs) - np.array(spec["val_acc"]))) <= 0.055
    assert abs(report.test_accuracy - spec["test_acc"]) <= 0.055


def test_engine_early_stop_and_predict():
    g = synthetic_graph(300, 6, 16, 4, seed=35)
    eng = TEngine(g, LayerConfig([16, 8, 4]),
                  TrainConfig(epochs=50, kernel="hyb", target_accuracy=0.5),
                  device="cpu")
    rep = eng.run()
    assert len(rep.epochs) < 50 and rep.notes["converge_state"] == "DONE"
    logits = eng.predict()
    probs = eng.predict(softmax=True)
    assert logits.shape == probs.shape == (300, 4)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("overrides", [
    {"num_shards": 2},
    {"param_dtype": "bfloat16"},
    {"compute_dtype": "float16"},
    {"model": "sage"},
    {"kernel": "pallas"},
    {"agg_dtype": "float16"},
    {"feat_shards": 2},
], ids=lambda d: next(iter(d)) + "=" + str(next(iter(d.values()))))
def test_engine_raises_outside_the_slice(overrides):
    g = synthetic_graph(100, 4, 8, 3, seed=1)
    cfg = TrainConfig(**{"kernel": "hyb", **overrides})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TEngine(g, LayerConfig([8, 4, 3]), cfg, device="cpu")


@pytest.mark.parametrize("kernel", ["xla", "degree"])
def test_engine_reuse_pairs_off_hyb_falls_back(kernel):
    """reuse="pairs" needs kernel="hyb": on another kernel the engine logs
    and trains on that kernel without the rewrite, as JAX's does."""
    from dorylus_tpu_torch.ops.degree_spmm import DegreeSpMM

    g = synthetic_graph(200, 5, 12, 3, seed=5)
    eng = TEngine(g, LayerConfig([12, 6, 3]),
                  TrainConfig(epochs=2, kernel=kernel, reuse="pairs"), device="cpu")
    if kernel == "xla":
        assert eng.model.spmm_op is None and eng.model.edge_op is not None
    else:
        assert isinstance(eng.model.spmm_op, DegreeSpMM)
    rep = eng.run()
    assert rep.notes["kernel"] == kernel and np.isfinite(rep.epochs[-1].loss)


_NO_JAX = r"""
import pkgutil, sys
for name in [m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "dorylus_tpu", "bench")]:
    del sys.modules[name]
# any import of jax, of the JAX package or of its bench now raises ImportError
sys.modules["jax"] = sys.modules["dorylus_tpu"] = sys.modules["bench"] = None
import importlib
import torch
torch.set_num_threads(1)
import dorylus_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dorylus_tpu_torch.__path__,
                                                "dorylus_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # import only: its module top needs the port and torch alone
import numpy as np
from dorylus_tpu_torch import LayerConfig, TrainConfig
from dorylus_tpu_torch.graph.graph import Graph, community_core_edges, synthetic_graph
from dorylus_tpu_torch.engine.engine import Engine
from dorylus_tpu_torch.ops.reuse_spmm import ReuseSpMM
g = synthetic_graph(200, 5, 12, 3, seed=3)
src, dst = community_core_edges(300, 10, comm=30, core=15, seed=2)
gc = Graph(num_vertices=300, src=src, dst=dst,
           features=np.random.default_rng(0).normal(size=(300, 12)).astype(np.float32),
           labels=(np.arange(300) % 3).astype(np.int32), num_classes=3).finalize()
runs = [(g, model, kernel, "off") for model in ("gcn", "gat")
        for kernel in ("hyb", "xla", "degree")]
runs += [(gc, "gcn", "hyb", "pairs"), (gc, "gat", "hyb", "pairs")]
for graph, model, kernel, reuse in runs:
    eng = Engine(graph, LayerConfig([12, 6, 3]),
                 TrainConfig(epochs=2, kernel=kernel, model=model, reuse=reuse),
                 device="cpu")
    if reuse == "pairs":
        assert isinstance(eng.model.spmm_op, ReuseSpMM)
        assert eng.model.spmm_op.plan_fwd.num_pairs > 0
    rep = eng.run()
    assert len(rep.epochs) == 2 and all(e.loss == e.loss for e in rep.epochs)
    assert rep.notes["cost"]["chip_seconds"] >= 0
# stage profiling (engine/profiling.py) on the last engine
assert all(v > 0 for v in eng.profile(iters=1).values())
# a grouped run (engine/graphs.py imported above): groups of 3 with eval
# every 2 epochs at staleness 1; one record per epoch, evaluated where flagged
eng = Engine(g, LayerConfig([12, 6, 3]),
             TrainConfig(epochs=7, eval_every=2, epochs_per_call=3, staleness=1),
             device="cpu")
rep = eng.run()
assert [e.accuracy is not None for e in rep.epochs] == [True, False, True, False, True,
                                                        False, True]
assert rep.epochs[0].time_ms == rep.epochs[2].time_ms != rep.epochs[3].time_ms
# the sharded engine, two ranks over gloo: each rank is a fresh interpreter
# and reports whether it loaded jax or the JAX package
sys.path.insert(0, "tests")
import _torch_ranks
from dorylus_tpu_torch.parallel.multihost import spawn_local
# one launch per graph: hyb (the fused plan) and kernel="degree" (the
# interior/boundary pair) on the planted graph, reuse="pairs" on the
# community graph, both models
for graph, cfgs, plans in (
        (g, [dict(kernel="hyb"), dict(kernel="degree")], ["fused", "pair"]),
        (gc, [dict(kernel="hyb", reuse="pairs")], ["ShardedReuseSpMM"])):
    runs = [(dict(model=model, **kw), 2, {}) for kw in cfgs for model in ("gcn", "gat")]
    res = spawn_local(2, _torch_ranks.engines_rank, (graph, [12, 6, 3], runs),
                      backend="gloo", device="cpu", timeout_s=120)
    for i, (kw, _, _) in enumerate(runs):
        assert all(len(r[i]["losses"]) == 2 and not r[i]["foreign_modules"] for r in res), res
        assert res[0][i]["losses"] == res[1][i]["losses"]
        assert res[0][i]["plan"] == plans[i // 2], (kw, res[0][i]["plan"])
        if kw.get("reuse") == "pairs":
            assert res[0][i]["pairs"][0] > 0
# tensor parallelism (parallel/mesh.py): 2 graph x 2 feat shards, 4 ranks, with
# the sharded profile
runs = [(dict(model=model, kernel="hyb", feat_shards=2), 2, {"profile": True})
        for model in ("gcn", "gat")]
res = spawn_local(4, _torch_ranks.engines_rank, (g, [12, 6, 3], runs), backend="gloo",
                  device="cpu", timeout_s=120)
for i in range(2):
    assert all(len(r[i]["losses"]) == 2 and not r[i]["foreign_modules"] for r in res), res
    assert [r[i]["mesh"] for r in res] == [(2, 2, 0, 0), (2, 2, 0, 1), (2, 2, 1, 0),
                                           (2, 2, 1, 1)]
    assert res[0][i]["losses"] == res[3][i]["losses"] and "halo_l0_ms" in res[0][i]["profile"]
# the command line on the CPU: prepare-data, train with staleness and
# checkpoints, resume, infer, partition (graph/dataio.py, engine/checkpoint.py)
import tempfile
from pathlib import Path
from dorylus_tpu_torch.cli import main
from dorylus_tpu_torch.graph.dataio import save_dataset
d = Path(tempfile.mkdtemp())
save_dataset(d / "ds", g)
np.savetxt(d / "e.txt", np.c_[g.src, g.dst], fmt="%d")
np.savetxt(d / "f.txt", g.features, fmt="%.6f")
np.savetxt(d / "l.txt", g.labels, fmt="%d")
assert main(["prepare-data", "--edges", str(d / "e.txt"), "--features", str(d / "f.txt"),
             "--labels", str(d / "l.txt"), "--out", str(d / "prep"), "--feature-dim", "12",
             "--classes", "3"]) == 0
(d / "l.config").write_text("12 6 3")
common = ["--data-dir", str(d / "ds"), "--config", str(d / "l.config"), "--device", "cpu"]
for extra in ([], ["--resume"]):
    assert main(["train", *common, "--epochs", "2", "--staleness", "1", "--model", "gat",
                 "--checkpoint-dir", str(d / "ck"), "--checkpoint-every", "2", *extra]) == 0
assert main(["infer", *common, "--model", "gat", "--checkpoint-dir", str(d / "ck"),
             "--out", str(d / "p.txt")]) == 0
assert np.loadtxt(d / "p.txt").shape == (200, 3)
assert main(["partition", "--graph", str(d / "ds" / "graph.bsnap"), "--n", "2"]) == 0
# the reference-scale tools and the entry points: each imported above; a
# reference config's command line at a tiny scale, and the entry's forward
from dorylus_tpu_torch import graft_entry
from dorylus_tpu_torch.tools import (reference_configs, scale_pipeline, switch_points,
                                     validate_32way)
assert {"dorylus_tpu_torch.bench", "dorylus_tpu_torch.graft_entry",
        "dorylus_tpu_torch.tools.reference_configs",
        "dorylus_tpu_torch.tools.scale_pipeline",
        "dorylus_tpu_torch.tools.switch_points",
        "dorylus_tpu_torch.tools.validate_32way"} <= set(names)
# the switch-point sweep's engine timing, on a small graph
from dorylus_tpu_torch import bench
t = switch_points.engine_times(bench.bench_graph(300, 4), TrainConfig(kernel="hyb", epochs=1),
                               torch.device("cpu"), reps=1)
assert t["kernel_selected"] == "hyb" and t["warm_ms"]["median"] > 0
rec = reference_configs.run("amazon-gat", scale=400 / 9430088, epochs=2, device="cpu")
assert rec["vertices"] in (399, 400) and len(rec["losses"]) == 2
assert all(l == l for l in rec["losses"])
fn, (params, batch) = graft_entry.entry(device="cpu")
assert fn(params, batch).shape == (4096, 41)
# the benchmark's every CPU cell on a small graph
bench.SCALES["cpu"] = dict(v=1000, deg=4, iters=1)
assert bench.main("cpu")["extras"]["num_edges"] == 4000
import shutil
shutil.rmtree(d)
assert not any(m.split(".")[0] in ("jax", "dorylus_tpu", "bench")
               for m, v in sys.modules.items() if v is not None)
print("OK", len(names))
"""


def test_port_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1].startswith("OK"), res.stdout
    # every module was imported
    assert int(res.stdout.strip().splitlines()[-1].split()[1]) >= 30


def test_port_source_never_imports_jax():
    """No source line of the port or of chip_smoke.py imports jax, the JAX
    package or its bench."""
    banned = ("import jax", "from jax", "import dorylus_tpu.", "from dorylus_tpu.",
              "from dorylus_tpu ", "import bench", "from bench")
    paths = list((REPO / "dorylus_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in paths:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(banned) and s != "import dorylus_tpu", f"{path}: {line}"
    assert not (REPO / "dorylus_tpu_torch" / "_shared.py").exists()
