"""The port's weak-scaling harness and pair-miner bench
(dorylus_tpu_torch/tools/weak_scaling.py, bench_mine.py) against the JAX
package's tools/weak_scaling.py and tools/bench_mine.py, on the CPU at tiny
sizes (base 512-1024 vertices, degree 8, F 16, C 4, 2 epochs, 1 repeat):

  * `_halo_traffic` equal to JAX's dict on the same clustered graph, GCN at
    2 and 4 shards and GAT at 2;
  * the 2-shard --cpu record (kernel xla, --overlap both --decompose)
    against JAX's `run_once` on the virtual CPU mesh: the same keys, the
    same graph, partition and halo, the same stage keys;
  * 2 pinned gloo ranks (hyb GCN f32) in a child under taskset: their
    losses against JAX's `ShardedEngine` on `make_mesh(2)` (atol 1e-4), each
    rank's cores and threads;
  * both of JAX's efficiency formulas on made-up records, JAX's `main` and
    the port's `sweep` beside each other;
  * `--pin --shards 1 2 N` through `python -m`: the pinned summary;
  * device mode: raises without a card, skips counts above the card count;
  * bench_mine on a 20,000-vertex community graph against JAX's tool.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dorylus_tpu.common.config import LayerConfig as JLayerConfig
from dorylus_tpu.common.config import TrainConfig as JTrainConfig
from dorylus_tpu.graph.graph import clustered_synthetic_graph as jclustered
from dorylus_tpu.graph.partition import partition_graph as jpartition
from dorylus_tpu.parallel.mesh import make_mesh
from dorylus_tpu.parallel.train_step import ShardedEngine as JShardedEngine
from dorylus_tpu_torch.graph.partition import partition_graph
from dorylus_tpu_torch.tools import bench_mine, weak_scaling

REPO = Path(__file__).resolve().parent.parent
TINY = ["--base-vertices", "1024", "--degree", "8", "--feature-dim", "16", "--classes", "4",
        "--epochs", "2", "--repeats", "1"]
RECORD_KEYS = {"shards", "vertices", "edges", "overlap", "edges_per_s", "epoch_ms",
               "edges_per_s_runs"}


def _load(name: str):
    """The JAX package's tool `tools/<name>.py`, loaded from its path."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jws():
    return _load("weak_scaling")


def args_of(*extra):
    return weak_scaling.build_parser().parse_args(TINY + list(extra))


@pytest.mark.parametrize("model,n", [("gcn", 2), ("gcn", 4), ("gat", 2)])
def test_halo_traffic_equals_jax(jws, model, n):
    args = args_of("--model", model, "--base-vertices", "512")
    g = weak_scaling.make_graph(args, n)
    layers, _ = weak_scaling.make_config(args)
    got = weak_scaling._halo_traffic(partition_graph(g, n, for_gat=model == "gat"), layers,
                                     model)
    jg = jclustered(512 * n, 8, 16, 4, seed=123, window=64, cut=0.1)
    want = jws._halo_traffic(jpartition(jg, n, for_gat=model == "gat"),
                             JLayerConfig([16, 32, 4]), model)
    assert got == want
    assert got["ghost_rows_needed"] > 0


def test_cpu_record_against_jax_run_once(jws):
    args = args_of("--cpu", "--overlap", "both", "--decompose")
    rec, ranks = weak_scaling.run_shards(args, 2)
    want = jws.run_once(args, 2)
    assert set(rec) == set(want) == RECORD_KEYS | {"serial", "overlap_speedup", "stages_ms",
                                                   "halo"}
    for k in ("shards", "vertices", "edges", "overlap", "halo"):
        assert rec[k] == want[k], k
    assert set(rec["stages_ms"]) == set(want["stages_ms"])
    assert set(rec["serial"]) == set(want["serial"]) == {"edges_per_s", "epoch_ms",
                                                         "edges_per_s_runs"}
    assert rec["edges_per_s"] > 0 and rec["overlap_speedup"] > 0
    assert len(rec["edges_per_s_runs"]) == 1 and np.isfinite(rec["epoch_ms"])
    # every rank reads the same max-over-ranks epoch
    assert ranks[0]["measure"] == ranks[1]["measure"]
    assert all(r["backend"] == "gloo" and r["threads"] == max(1, os.cpu_count() // 2)
               for r in ranks)
    # xla's edgewise split: K3 ran in its plain version, which counts no launch
    assert ranks[0]["launches"] == {}


_PINNED_RANKS = """
import json, sys
from dorylus_tpu_torch.tools import weak_scaling as ws
args = ws.build_parser().parse_args(sys.argv[1:])
rec, ranks = ws.run_shards(args, 2)
print(json.dumps({"rec": rec, "ranks": [{k: r[k] for k in ("losses", "cores", "threads")}
                                        for r in ranks]}))
"""


def test_pinned_ranks_losses_against_jax_sharded_engine():
    if not hasattr(os, "sched_getaffinity") or len(os.sched_getaffinity(0)) < 2:
        pytest.skip("needs two cores to pin")
    res = subprocess.run(["taskset", "-c", "0-1", sys.executable, "-c", _PINNED_RANKS, *TINY,
                          "--_child", "2", "--cpu", "--kernel", "hyb"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert [r["cores"] for r in out["ranks"]] == [2, 2]  # the affinity survives the spawn
    assert [r["threads"] for r in out["ranks"]] == [1, 1]
    g = jclustered(2048, 8, 16, 4, seed=123, window=128, cut=0.1)
    assert out["rec"]["edges"] == g.num_edges
    cfg = JTrainConfig(epochs=2, eval_every=0, kernel="hyb", model="gcn", overlap=True,
                       reuse="off")
    want = [e.loss for e in JShardedEngine(g, JLayerConfig([16, 32, 4]), cfg,
                                           mesh=make_mesh(2)).run().epochs]
    for r in out["ranks"]:
        np.testing.assert_allclose(r["losses"], want, rtol=0, atol=1e-4)


MADE_UP = {1: 1000.0, 2: 1710.0, 4: 3100.0}


def _fake_child(cmd, **kw):
    n = int(cmd[cmd.index("--_child") + 1])
    rec = {"shards": n, "edges_per_s": MADE_UP[n]}
    return subprocess.CompletedProcess(cmd, 0, stdout=f"log line\n{json.dumps(rec)}\n",
                                       stderr="")


@pytest.mark.parametrize("mode", ["--pin", "--cpu"])
def test_efficiency_arithmetic_as_jax(jws, monkeypatch, capsys, mode):
    """JAX's main and the port's sweep on the same made-up records: pinned
    mode against base['shards'], shared mode against first / n."""
    shards = ["--shards", "1", "2", "4"]
    monkeypatch.setattr(subprocess, "run", _fake_child)
    monkeypatch.setattr(jws, "run_once", lambda a, n: {"shards": n, "edges_per_s": MADE_UP[n]})
    monkeypatch.setattr(sys, "argv", ["weak_scaling.py", mode, *shards])
    jws.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setattr(weak_scaling, "run_shards",
                        lambda a, n, t: ({"shards": n, "edges_per_s": MADE_UP[n]},
                                         [{"threads": 8 // n}]))
    got, _ = weak_scaling.sweep(weak_scaling.build_parser().parse_args([mode, *shards]),
                                out=lambda line: None)
    assert got["weak_scaling"] == want["weak_scaling"]
    effs = [r["weak_scaling_efficiency"] for r in got["weak_scaling"]]
    assert effs == [1.0, round(1710 / 2000, 3), round(3100 / 4000, 3)]
    assert got["mode"] == want["mode"] == ("pinned-cpu" if mode == "--pin" else "shared-cpu")
    assert set(got) == set(want) | {"backend", "threads_per_rank"}
    assert got["backend"] == "gloo"


def test_pin_command_line():
    many = (os.cpu_count() or 1) + 1
    res = subprocess.run([sys.executable, "-m", "dorylus_tpu_torch.tools.weak_scaling",
                          "--pin", "--shards", "1", "2", str(many), *TINY,
                          "--base-vertices", "512", "--kernel", "hyb"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("# pinned-cpu") and "plain torch" in lines[0]
    assert f"# skipping {many} shards (only {os.cpu_count()} cores to pin)" in lines
    summary = json.loads(lines[-1])
    assert set(summary) == {"weak_scaling", "mode", "graph", "cut", "kernel", "model",
                            "cores", "repeats", "backend", "threads_per_rank"}
    assert summary["mode"] == "pinned-cpu" and summary["backend"] == "gloo"
    assert summary["threads_per_rank"] == {"1": 1, "2": 1}
    recs = summary["weak_scaling"]
    assert [r["shards"] for r in recs] == [1, 2]
    assert recs[0]["weak_scaling_efficiency"] == 1.0
    assert set(recs[0]) == RECORD_KEYS | {"weak_scaling_efficiency"}
    assert set(recs[1]) == RECORD_KEYS | {"halo", "weak_scaling_efficiency"}


def test_device_mode_needs_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: device mode runs there")
    with pytest.raises(RuntimeError, match="--cpu"):
        weak_scaling.main(["--shards", "1"])
    with pytest.raises(RuntimeError, match="--pin"):
        weak_scaling.run_shards(args_of(), 1)
    # with one card, counts above it are skipped, and the record says nccl
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(weak_scaling, "run_shards",
                        lambda a, n, t: ({"shards": n, "edges_per_s": 5.0}, [{"threads": 4}]))
    lines = []
    got, _ = weak_scaling.sweep(args_of("--shards", "1", "2", "4"), out=lines.append)
    assert [r["shards"] for r in got["weak_scaling"]] == [1]
    assert "# skipping 2 shards (only 1 devices)" in lines
    assert "# skipping 4 shards (only 1 devices)" in lines
    assert (got["mode"], got["backend"]) == ("device", "nccl")


def test_bench_mine_against_jax(monkeypatch, capsys):
    from dorylus_tpu_torch import native
    from dorylus_tpu_torch.graph.graph import community_core_edges
    from dorylus_tpu_torch.graph.reuse import _mine_one, mine_reuse

    if not native.has_mine_pairs():
        pytest.skip("the native miner does not build on this host")
    jbm = _load("bench_mine")
    monkeypatch.setattr(sys, "argv", ["bench_mine.py", "--vertices", "20000",
                                      "--numpy-also"])
    jbm.main()
    jlines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    want = jlines[0]
    got = bench_mine.bench(20000, numpy_also=True, out=lambda line: None)
    assert set(got) == set(want) | set(jlines[1])
    for k in ("edges", "vertices", "passes", "pairs", "row_reduction"):
        assert got[k] == want[k], k
    assert got["pairs"] > 0 and got["native_edges_per_s"] > 0
    # the numpy level is the native one, pair for pair
    src, dst = community_core_edges(20000, 20, comm=1000, core=60, seed=7)
    level = mine_reuse(src, dst, 20000, min_uses=3).levels[0]
    np.testing.assert_array_equal(_mine_one(src, dst, 20000, 3, 0)[0], level)
    # where the native miner does not build, the bench says so
    monkeypatch.setattr(native, "has_mine_pairs", lambda: False)
    with pytest.raises(RuntimeError, match="native pair miner"):
        bench_mine.bench(2000)
