"""The port's scale harnesses (dorylus_tpu_torch/tools/validate_32way.py and
scale_pipeline.py) on the CPU, at tiny sizes:

  * validate_32way on 4 gloo ranks of a 4,096-vertex graph: the record's
    keys (the JAX record's), the losses of 4 ranks within 1e-3 of one
    device (its parity bar; the delta is summation order alone), the one
    device's losses against the JAX `Engine` on the same graph (GCN f32,
    atol 1e-4, PERF.md section 2), and its command line;
  * scale_pipeline partition-1b: every phase timed, a plan's bytes per rank,
    the exact wire's rows equal to the JAX package's ragged plan's on the
    same graph (`build_ragged_plan`), the edges of the shards the graph's;
  * scale_pipeline train-300m on 4 gloo CPU ranks against the one-device
    engine (its 2e-3 bar), and the one device's losses against the JAX
    `Engine` on the same graph (GCN with bf16 gather, atol 1e-3);
  * both tools, like every entry point of the port, raise without a card
    unless asked for the CPU;
  * (slow) validate_32way at 32 ranks, at tests/test_32way.py's size
    (32,768 vertices, degree 8, 3 epochs), through its command line.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.engine import Engine as JEngine
from dorylus_tpu.graph.graph import clustered_synthetic_graph
from dorylus_tpu.graph.partition import partition_graph as jpartition
from dorylus_tpu.parallel.halo import build_ragged_plan
from dorylus_tpu_torch.tools import scale_pipeline, validate_32way

torch.set_num_threads(1)

JAX_KEYS = {"what", "num_vertices", "num_edges", "kernel", "epochs", "loss_single",
            "loss_32way", "max_abs_loss_delta", "parity_ok"}


def jax_losses(g, dims, **kw) -> list:
    """The JAX one-device engine's losses on g (kernel="hyb", reuse="off")."""
    eng = JEngine(g, LayerConfig(dims),
                  TrainConfig(eval_every=0, kernel="hyb", reuse="off", **kw))
    return [e.loss for e in eng.run().epochs]


def test_validate_32way_at_4_ranks():
    rec = validate_32way.validate(ranks=4, vertices=4096, degree=8, epochs=3, device="cpu")
    assert JAX_KEYS <= set(rec) and rec["wall_s_32way"] > 0
    assert (rec["ranks"], rec["kernel"], rec["overlap"], rec["wire"]) == (4, "hyb", True,
                                                                          "ragged")
    assert len(rec["loss_single"]) == len(rec["loss_32way"]) == 3
    assert rec["parity_ok"] and rec["max_abs_loss_delta"] < 1e-3
    assert rec["loss_32way"][-1] < rec["loss_32way"][0]
    g = clustered_synthetic_graph(4096, 8, 32, 8, seed=7, cut=0.1)
    assert (rec["num_vertices"], rec["num_edges"]) == (g.num_vertices, g.num_edges)
    np.testing.assert_allclose(rec["loss_single"], jax_losses(g, validate_32way.DIMS, epochs=3),
                               rtol=0, atol=1e-4)


def test_validate_32way_command_line(tmp_path, capsys):
    out = tmp_path / "rec.json"
    assert validate_32way.main(["--ranks", "2", "--vertices", "1024", "--degree", "6",
                                "--epochs", "2", "--device", "cpu", "--out", str(out)]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(out.read_text())


def test_partition_1b_tiny():
    rec = scale_pipeline.partition_1b(2e5, shards=8, degree=16, feature_dim=8)
    assert set(rec["phases"]) == {"generate_s", "partition_s", "halo_plans_s",
                                  "hyb_fused_plans_s"}
    assert all(v >= 0 for v in rec["phases"].values())
    assert set(rec["rss_gb"]) == {f"after_{p}" for p in ("generate", "partition",
                                                         "halo_plans", "hyb_fused_plans")}
    assert len(rec["hyb_fused_plan_bytes"]) == len(rec["halo_plan_bytes"]) == 8
    assert all(b > 0 for b in rec["hyb_fused_plan_bytes"] + rec["halo_plan_bytes"])
    assert rec["hyb_fused_plan_bytes_total"] == sum(rec["hyb_fused_plan_bytes"])
    # the same graph through the JAX package's partition and ragged plan
    g = clustered_synthetic_graph(int(2e5) // 16, 16, 8, 16, seed=17, window=8192, cut=0.1)
    assert (rec["vertices"], rec["edges"]) == (g.num_vertices, g.num_edges)
    sg = jpartition(g, 8, method="range")
    assert (rec["vp"], rec["max_h"]) == (sg.vp, sg.max_h)
    assert rec["ragged_rows_on_wire"] == int(np.asarray(build_ragged_plan(sg)["send_sz"]).sum())
    assert 0 < rec["edge_cut"] < 1


def test_train_300m_tiny():
    rec = scale_pipeline.train_300m(2e5, ranks=4, epochs=3, device="cpu")
    assert rec["edges"] > 1.9e5 and sum(rec["rank_edges"]) == rec["edges"]
    assert len(rec["single_losses"]) == len(rec["sharded_losses"]) == 3
    assert rec["overlap_fused"] and rec["parity_ok"] and rec["max_loss_delta"] < 2e-3
    assert all(np.isfinite(rec["sharded_losses"]))
    g = clustered_synthetic_graph(int(2e5) // 16, 16, 16, 16, seed=17, window=8192, cut=0.1)
    assert (rec["vertices"], rec["edges"]) == (g.num_vertices, g.num_edges)
    np.testing.assert_allclose(rec["single_losses"],
                               jax_losses(g, [16, 32, 16], epochs=3, agg_dtype="bfloat16"),
                               rtol=0, atol=1e-3)


def test_tools_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: device=None runs there")
    with pytest.raises(RuntimeError):
        validate_32way.validate(ranks=2, vertices=256, degree=4, epochs=1)
    with pytest.raises(RuntimeError):
        validate_32way.main(["--ranks", "2", "--vertices", "256", "--epochs", "1"])
    with pytest.raises(RuntimeError):
        scale_pipeline.train_300m(1e3, ranks=2, epochs=1)


def test_scale_pipeline_command_line(tmp_path, capsys):
    out = tmp_path / "rec.json"
    assert scale_pipeline.main(["partition-1b", "--edges", "5e4", "--shards", "4",
                                "--out", str(out)]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(out.read_text())


@pytest.mark.slow
def test_validate_32way_at_32_ranks():
    """32 gloo ranks, one process each: about 20 s on an 8-core host, the
    processes' RSS summing to about 7 GiB at the peak."""
    out = subprocess.run([sys.executable, "-m", "dorylus_tpu_torch.tools.validate_32way",
                          "--vertices", "32768", "--degree", "8", "--epochs", "3",
                          "--device", "cpu"],
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    rec = json.loads(out.stdout)
    assert rec["ranks"] == 32 and rec["parity_ok"], rec
