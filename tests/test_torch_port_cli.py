"""The port's command line (dorylus_tpu_torch/cli.py) against the JAX
package's (dorylus_tpu/cli.py), in-process with `--device cpu`:

  * every subcommand: train (one device, 2 gloo ranks, from a prepared
    directory, with checkpoints and staleness), infer, prepare-data,
    partition; the JAX command lines run unchanged with `--device cpu`
    added;
  * `infer` writes the prediction file JAX's `infer` writes from the same
    checkpoint, within tools/compare_output.py's threshold (1e-4 on each
    vertex's line sum), on tests/data/digits and tests/data/golden, for a
    checkpoint of either package;
  * the port reaches tests/test_real_dataset.py's accuracy band on the
    digits graph through the command line;
  * `--profile` runs and a `--feat-shards` that does not divide a width
    exits non-zero with one line; without `--device` and without a card
    `train`, `infer` and `bench` exit non-zero with one line; the TPU-only
    flags are accepted, logged and ignored;
  * `bench --device cpu` prints one JSON line in bench.py's shape (the
    port's benchmark at a small scale here; tests/test_torch_port_bench.py
    runs it at bench.py's CPU scale);
  * `--epochs-per-call 3` runs JAX's epoch groups: the per-epoch records
    (losses, evaluated epochs' accuracies) and the checkpoint steps of
    JAX's run.
"""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dorylus_tpu.cli import main as jmain
from dorylus_tpu.graph import dataio as jdataio
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu_torch.cli import main as tmain

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from compare_output import compare  # noqa: E402

torch.set_num_threads(1)

DATA = Path(__file__).parent / "data"
SYNTH = ["--synth-vertices", "300", "--synth-degree", "5"]


def test_train_synthetic(capsys, tmp_path):
    rc = tmain(["train", "--dataset", "synthetic", "--epochs", "5", "--eval-every", "5",
                *SYNTH, "--device", "cpu", "--output", str(tmp_path / "rep.json")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "final val accuracy" in out
    rep = json.loads((tmp_path / "rep.json").read_text())
    assert len(rep["epochs"]) == 5 and rep["notes"]["kernel"] == "xla"


def test_train_matches_jax_command_line(capsys, tmp_path):
    """One JAX command line (hyb, staleness 1, LR decay) run by both
    packages: the same per-epoch losses (GCN atol 1e-4)."""
    argv = ["train", *SYNTH, "--epochs", "6", "--eval-every", "0", "--kernel", "hyb",
            "--staleness", "1", "--lr-decay-every", "2", "--reorder", "degree-asc"]
    assert jmain(argv + ["--output", str(tmp_path / "j.json")]) == 0
    assert tmain(argv + ["--output", str(tmp_path / "t.json"), "--device", "cpu"]) == 0
    jl, tl = ([e["loss"] for e in json.loads((tmp_path / f).read_text())["epochs"]]
              for f in ("j.json", "t.json"))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)


def test_train_sharded(capsys, tmp_path):
    """--shards 2: two gloo ranks on the CPU; rank 0 writes the report and
    the checkpoint; the losses are the single-device run's."""
    argv = ["train", "--epochs", "4", "--eval-every", "2", "--kernel", "hyb", *SYNTH,
            "--device", "cpu", "--staleness", "1"]
    assert tmain(argv + ["--output", str(tmp_path / "one.json")]) == 0
    assert tmain(argv + ["--shards", "2", "--output", str(tmp_path / "two.json"),
                         "--checkpoint-dir", str(tmp_path / "ck"),
                         "--checkpoint-every", "4"]) == 0
    assert "final val accuracy" in capsys.readouterr().out
    one, two = (json.loads((tmp_path / f).read_text()) for f in ("one.json", "two.json"))
    assert two["notes"]["shards"] == 2
    np.testing.assert_allclose([e["loss"] for e in two["epochs"]],
                               [e["loss"] for e in one["epochs"]], rtol=0, atol=1e-4)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["LATEST",
                                                                   "ckpt_00000004.npz"]


def test_prepare_and_train_from_dir(tmp_path, capsys):
    (tmp_path / "edges.txt").write_text("\n".join(f"{i} {(i + 1) % 40}" for i in range(40)))
    (tmp_path / "feats.txt").write_text("\n".join("1 0 1 0" for _ in range(40)))
    (tmp_path / "labels.txt").write_text("\n".join(str(i % 3) for i in range(40)))
    args = ["--edges", str(tmp_path / "edges.txt"), "--features", str(tmp_path / "feats.txt"),
            "--labels", str(tmp_path / "labels.txt"), "--feature-dim", "4", "--classes", "3"]
    assert tmain(["prepare-data", *args, "--out", str(tmp_path / "ds")]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info == {"vertices": 40, "edges": 80, "classes": 3, "out": str(tmp_path / "ds")}
    assert jmain(["prepare-data", *args, "--out", str(tmp_path / "jds")]) == 0
    for f in ("graph.bsnap", "features.bsnap", "labels.bsnap"):
        assert (tmp_path / "ds" / f).read_bytes() == (tmp_path / "jds" / f).read_bytes()
    assert tmain(["train", "--data-dir", str(tmp_path / "ds"), "--epochs", "3",
                  "--eval-every", "0", "--device", "cpu"]) == 0


@pytest.mark.parametrize("method", ["range", "hash"])
def test_partition(tmp_path, method):
    jdataio.save_dataset(tmp_path, synthetic_graph(120, 5, 4, 3, seed=6))
    g = str(tmp_path / "graph.bsnap")
    assert tmain(["partition", "--graph", g, "--n", "3", "--method", method,
                  "--out", str(tmp_path / "t.parts")]) == 0
    assert jmain(["partition", "--graph", g, "--n", "3", "--method", method,
                  "--out", str(tmp_path / "j.parts")]) == 0
    assert (tmp_path / "t.parts").read_bytes() == (tmp_path / "j.parts").read_bytes()
    # the parts file drives a sharded run
    assert tmain(["train", "--data-dir", str(tmp_path), "--epochs", "2", "--eval-every", "0",
                  "--shards", "3", "--partition", "metis", "--parts-file",
                  str(tmp_path / "t.parts"), "--device", "cpu"]) == 0


def test_train_checkpoint_then_infer(tmp_path, capsys):
    data = tmp_path / "data"
    data.mkdir()
    jdataio.save_dataset(data, synthetic_graph(120, 5, 8, 4, seed=6))
    (tmp_path / "l.config").write_text("8\n6\n4\n")
    ck = tmp_path / "ck"
    common = ["--data-dir", str(data), "--config", str(tmp_path / "l.config"), "--device", "cpu"]
    assert tmain(["train", *common, "--epochs", "4", "--eval-every", "0",
                  "--checkpoint-dir", str(ck), "--checkpoint-every", "2"]) == 0
    out = tmp_path / "preds.txt"
    assert tmain(["infer", *common, "--checkpoint-dir", str(ck), "--out", str(out),
                  "--softmax"]) == 0
    preds = np.loadtxt(out)
    assert preds.shape == (120, 4)
    np.testing.assert_allclose(preds.sum(1), 1.0, atol=1e-4)
    # no checkpoint: a warning, and the initial weights' outputs
    capsys.readouterr()
    assert tmain(["infer", *common, "--checkpoint-dir", str(tmp_path / "none"),
                  "--out", str(out)]) == 0
    assert "no checkpoint found" in capsys.readouterr().err


def _dims(name):
    if name == "golden":
        return json.loads((DATA / "golden" / "golden.json").read_text())["dims"]
    return [64, 16, 10]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", ["digits", "golden"])
def test_infer_matches_jax(tmp_path, name, writer):
    """Train 5 epochs in one package with a checkpoint; both packages'
    `infer` then write prediction files that tools/compare_output.py
    finds equal (raw logits, each vertex's line sum within 1e-4)."""
    cfgf = tmp_path / "layers.config"
    cfgf.write_text("\n".join(map(str, _dims(name))))
    common = ["--data-dir", str(DATA / name), "--config", str(cfgf)]
    ck = str(tmp_path / "ck")
    train = ["train", *common, "--epochs", "5", "--eval-every", "0", "--checkpoint-dir", ck,
             "--checkpoint-every", "5"]
    assert (jmain(train) if writer == "jax" else tmain(train + ["--device", "cpu"])) == 0
    infer = ["infer", *common, "--checkpoint-dir", ck]
    assert jmain(infer + ["--out", str(tmp_path / "j.txt")]) == 0
    assert tmain(infer + ["--out", str(tmp_path / "t.txt"), "--device", "cpu"]) == 0
    a, b = np.loadtxt(tmp_path / "j.txt"), np.loadtxt(tmp_path / "t.txt")
    assert a.shape == b.shape == (b.shape[0], _dims(name)[-1]) and np.abs(a).max() > 0.1
    assert compare(str(tmp_path / "j.txt"), str(tmp_path / "t.txt")) == 0


def test_digits_accuracy_band(tmp_path):
    """tests/test_real_dataset.py's band for the 2-layer GCN 64-16-10 on
    the UCI digits kNN graph, 100 epochs, through the command line."""
    cfgf = tmp_path / "layers.config"
    cfgf.write_text("64\n16\n10\n")
    assert tmain(["train", "--data-dir", str(DATA / "digits"), "--config", str(cfgf),
                  "--epochs", "100", "--eval-every", "0", "--device", "cpu",
                  "--output", str(tmp_path / "rep.json")]) == 0
    rep = json.loads((tmp_path / "rep.json").read_text())
    assert rep["final_accuracy"] >= 0.96 and rep["test_accuracy"] >= 0.90, rep


@pytest.mark.parametrize("argv,item", [
    (["train", "--profile"], None),
    (["train", "--feat-shards", "3"], "divisible"),
], ids=["profile", "feat-shards"])
def test_unported_exits_naming_its_item(capsys, tmp_path, argv, item):
    """`--profile` and `--feat-shards`, refused until they were ported, now
    run: the profile's brackets (JAX's, for the same config) land in the
    report, and a --feat-shards that does not divide a width (the default
    32-64-8 by 3) exits 2 with one error line before any rank starts.
    (`bench`, refused until it was ported, runs: test_bench_prints_one_json_line.)"""
    if argv[0] == "train":
        argv = argv + [*SYNTH, "--epochs", "2", "--device", "cpu", "--output",
                       str(tmp_path / "rep.json")]
    rc = tmain(argv)
    err = capsys.readouterr().err.strip().splitlines()
    if item is None:
        assert rc == 0
        stages = json.loads((tmp_path / "rep.json").read_text())["stage_times"]
        assert sum("stage forward_ms" in line for line in err) == 1
        assert jmain(argv[:-4] + ["--output", str(tmp_path / "jrep.json")]) == 0
        want = json.loads((tmp_path / "jrep.json").read_text())["stage_times"]
        assert set(stages) == set(want) and {"forward_ms", "dense_l1_ms"} <= set(stages)
        return
    assert rc == 2
    refusals = [line for line in err if line.startswith("dorylus_tpu_torch:")]
    assert len(refusals) == 1 and refusals == err[-1:] and item in err[-1]
    assert len(err) == 1 or argv[0] == "train"  # train logs the dataset it loaded first


@pytest.mark.parametrize("cmd", ["train", "infer", "bench"])
def test_no_card_exits_nonzero(capsys, tmp_path, cmd):
    """Without --device the commands mean the card; without one they exit
    2 with one line before reading any data (bench: before building its
    graph; it has no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the command runs on it")
    argv = {"train": ["train", *SYNTH], "bench": ["bench"],
            "infer": ["infer", "--data-dir", str(tmp_path), "--config", "cora",
                      "--checkpoint-dir", str(tmp_path), "--out", str(tmp_path / "p.txt")]}[cmd]
    assert tmain(argv) == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "--device cpu" in err[0]
    assert tmain(argv + ["--platform", "tpu"]) == 2


def test_bench_prints_one_json_line(capsys, monkeypatch):
    """`bench --device cpu` prints one JSON line in bench.py's shape and
    nothing else on stdout (the engines log to stderr); a small graph here
    (V 2,000, degree 8, 1 iteration)."""
    from dorylus_tpu_torch import bench

    monkeypatch.setitem(bench.SCALES, "cpu", dict(v=2000, deg=8, iters=1))
    assert tmain(["bench", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    res = json.loads(out[0])
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "extras"}
    assert res["metric"] == "spmm_aggregation_edges_per_s_per_chip" and res["value"] > 0
    ex = res["extras"]
    assert (ex["platform"], ex["num_vertices"], ex["num_edges"]) == ("cpu", 2000, 16000)
    assert ex["gcn_reddit_config_epoch_bf16_ms"] > 0 and res["vs_baseline"] > 0


def test_tpu_only_flags_are_ignored(capsys):
    assert tmain(["train", *SYNTH, "--epochs", "2", "--eval-every", "0", "--platform", "cpu",
                  "--compile-cache", "off", "--epochs-per-call", "5", "--edge-chunk",
                  "1000"]) == 0
    err = capsys.readouterr().err
    for flag in ("--compile-cache", "--edge-chunk"):
        assert err.count(f"{flag} ignored") == 1, flag
    assert "--epochs-per-call" not in err  # honoured, not ignored
    assert "--platform cpu taken as --device cpu" in err


def test_epochs_per_call_gives_jax_records(capsys, tmp_path):
    """--epochs-per-call 3 with eval every 2 epochs and checkpoints every 4:
    the port's per-epoch records are JAX's (GCN losses atol 1e-4, the
    evaluated epochs, their accuracies), its group lines log the epochs
    JAX's log, and both write the same checkpoint steps."""
    argv = ["train", *SYNTH, "--epochs", "8", "--eval-every", "2", "--kernel", "hyb",
            "--epochs-per-call", "3", "--checkpoint-every", "4"]
    reps = {}
    for who, main in (("j", jmain), ("t", tmain)):
        extra = ["--device", "cpu"] if who == "t" else []
        assert main(argv + ["--output", str(tmp_path / f"{who}.json"), "--checkpoint-dir",
                            str(tmp_path / who)] + extra) == 0
        reps[who] = json.loads((tmp_path / f"{who}.json").read_text())["epochs"]
        logged = re.findall(r"\] Epoch (\d+):", capsys.readouterr().err)
        assert logged == ["0", "2", "4", "6", "7"], (who, logged)
    j, t = reps["j"], reps["t"]
    assert [e["epoch"] for e in t] == [e["epoch"] for e in j] == list(range(8))
    np.testing.assert_allclose([e["loss"] for e in t], [e["loss"] for e in j], rtol=0, atol=1e-4)
    assert [e["accuracy"] is None for e in t] == [e["accuracy"] is None for e in j]
    np.testing.assert_allclose([e["accuracy"] for e in t if e["accuracy"] is not None],
                               [e["accuracy"] for e in j if e["accuracy"] is not None],
                               rtol=0, atol=1e-6)
    # groups [0-2], [3], [4-6], [7] (cut at the checkpoint epochs 3 and 7):
    # one time per group
    times = [e["time_ms"] for e in t]
    assert times[0] == times[1] == times[2] and times[4] == times[5] == times[6]
    names = [sorted(p.name for p in (tmp_path / w).iterdir()) for w in ("j", "t")]
    assert names[0] == names[1] == ["LATEST", "ckpt_00000004.npz", "ckpt_00000008.npz"]
