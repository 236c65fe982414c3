"""The reference-config runs (dorylus_tpu_torch/tools/reference_configs.py)
against the run scripts of benchmarks/ and the JAX package's command line:

  * for each of the six run scripts, the `train` argument list the tool builds
    equals the one the bash script hands `python -m dorylus_tpu.cli`, read
    by running the script with a `python` on PATH that prints its
    arguments: with the script's defaults, and with every env knob the
    script reads set (SCALE, EPOCHS, SHARDS, DATA, TARGET_ACC) and the
    other knobs and an extra flag passed as the script's own arguments;
  * at a tiny SCALE (about 2,000 vertices, 2 epochs, `--device cpu`), the
    record's losses against `dorylus_tpu.cli.main(["train", ...])` run
    with the same flags on the CPU, for amazon-gcn, amazon-gat,
    reddit-large-gcn and friendster-gcn (Reddit's command lines are held
    to JAX's in tests/test_torch_port_cli.py). Tolerances are PERF.md §2's:
    GCN atol 1e-3 with bf16 gather, GAT rtol 5e-3;
  * the record's keys, and the command line of the tool itself;
  * `--scale` refused for the scripts that read no SCALE (Reddit's).
"""

import json
import os
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dorylus_tpu.cli import main as jmain
from dorylus_tpu.common.config import LayerConfig
from dorylus_tpu_torch.tools import reference_configs as rc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
KNOBS = {"SCALE": "0.01", "EPOCHS": "3", "SHARDS": "2", "DATA": "/data/set",
         "TARGET_ACC": "0.9"}


def script_argv(tmp_path, script: str, env: dict, args=()) -> list:
    """What benchmarks/<script> hands `python -m dorylus_tpu.cli`: the
    script runs with a `python` first on PATH that prints the arguments of
    `-m ...` and runs every other call (the script's `python -c`)."""
    shim = tmp_path / "bin" / "python"
    shim.parent.mkdir(exist_ok=True)
    shim.write_text("#!/bin/sh\n"
                    'if [ "$1" = "-m" ]; then shift 2; printf "%s\\0" "$@"; exit 0; fi\n'
                    f'exec "{sys.executable}" "$@"\n')
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    full = {k: v for k, v in os.environ.items() if k not in KNOBS}
    full.update(env, PATH=f"{shim.parent}:{os.environ['PATH']}")
    out = subprocess.run(["bash", str(ROOT / "benchmarks" / script), *args], env=full,
                         capture_output=True, timeout=60, check=True)
    return out.stdout.decode().split("\0")[:-1]


@pytest.mark.parametrize("name", sorted(rc.CONFIGS))
def test_argv_is_the_run_scripts(tmp_path, name):
    c = rc.CONFIGS[name]
    assert script_argv(tmp_path, c.script, {}) == rc.argv(name)
    # every knob set: the script's own through its env, the rest (and one
    # more flag) as the script's arguments, where the tool puts them too
    env = {k: v for k, v in KNOBS.items() if k in c.env}
    args = []
    if "DATA" not in c.env:
        args += ["--data-dir", KNOBS["DATA"]]
    if "TARGET_ACC" not in c.env:
        args += ["--target-acc", KNOBS["TARGET_ACC"]]
    args += ["--kernel", "hyb"]
    want = rc.argv(name, scale=float(KNOBS["SCALE"]) if "SCALE" in c.env else None,
                   epochs=int(KNOBS["EPOCHS"]), shards=int(KNOBS["SHARDS"]),
                   data_dir=KNOBS["DATA"], target_acc=float(KNOBS["TARGET_ACC"]),
                   extra=("--kernel", "hyb"))
    assert script_argv(tmp_path, c.script, env, args) == want
    # the default SCALE builds the script's graph (seed 8888 in both CLIs)
    assert want[want.index("--synth-vertices") + 1] == str(
        int(c.paper_vertices * (0.01 if "SCALE" in c.env else c.scale)))


@pytest.mark.parametrize("name", ["amazon-gcn", "amazon-gat", "reddit-large-gcn",
                                  "friendster-gcn"])
def test_tiny_scale_matches_the_jax_cli(tmp_path, name):
    c = rc.CONFIGS[name]
    scale = 2000 / c.paper_vertices
    rec = rc.run(name, scale=scale, epochs=2, device="cpu")
    argv = rc.argv(name, scale=scale, epochs=2)
    at = argv.index("--output") + 1
    argv[at] = str(tmp_path / "jax.json")
    assert jmain(argv) == 0
    jrep = json.loads((tmp_path / "jax.json").read_text())
    jl = [e["loss"] for e in jrep["epochs"]]
    assert len(rec["losses"]) == 2 and rec["vertices"] == int(c.paper_vertices * scale)
    if c.model == "gcn":
        np.testing.assert_allclose(rec["losses"], jl, rtol=0, atol=1e-3)
    else:
        np.testing.assert_allclose(rec["losses"], jl, rtol=5e-3, atol=0)
    assert rec["kernel"] == jrep["notes"]["kernel"]
    assert rec["layer_dims"] == list(LayerConfig.preset(c.config).dims)


def test_record_and_command_line(tmp_path, capsys):
    out = tmp_path / "rec.json"
    assert rc.main(["friendster-gcn", "--scale", str(600 / 65608366), "--epochs", "2",
                    "--device", "cpu", "--out", str(out), "--", "--eval-every", "2"]) == 0
    printed = json.loads(capsys.readouterr().out)
    rec = json.loads(out.read_text())
    assert printed == rec
    assert set(rec) == {"config", "model", "vertices", "edges", "layer_dims", "kernel", "argv",
                        "device", "setup_s", "first_epoch_s", "warm_epoch_ms", "epoch_ms",
                        "losses", "val_acc_tail", "final_accuracy", "test_accuracy",
                        "hbm_peak_bytes", "hbm_limit_bytes", "host_peak_rss_gb", "card"}
    assert (rec["config"], rec["model"], rec["layer_dims"]) == ("friendster", "gcn",
                                                                [32, 48, 51])
    assert set(rec["setup_s"]) == {"graph", "reorder", "engine"}
    assert all(v >= 0 for v in rec["setup_s"].values())
    assert rec["argv"][-4:] == ["--eval-every", "2", "--device", "cpu"]
    assert rec["argv"][rec["argv"].index("--output") + 1] == "friendster-gcn-report.json"
    assert rec["hbm_peak_bytes"] is None and rec["card"] == {"name": None, "power_limit": None}
    assert all(np.isfinite(rec["losses"])) and len(rec["epoch_ms"]) == 2
    assert not (Path.cwd() / "friendster-gcn-report.json").exists()
    # a refusal of the command line: exit 2, one line
    assert rc.main(["amazon-gcn", "--scale", "0.0001", "--device", "cpu", "--",
                    "--feat-shards", "7"]) == 2
    assert "exited 2" in capsys.readouterr().err


def test_sharded_run_record():
    """SHARDS=2: two gloo ranks on the CPU; rank 0's report carries the
    parent's set-up seconds (with the partition's) and the graph."""
    rec = rc.run("friendster-gcn", scale=600 / 65608366, epochs=2, shards=2, device="cpu")
    assert set(rec["setup_s"]) == {"graph", "reorder", "partition", "engine"}
    assert rec["argv"][rec["argv"].index("--shards") + 1] == "2"
    assert rec["vertices"] == int(65608366 * (600 / 65608366)) and len(rec["losses"]) == 2
    one = rc.run("friendster-gcn", scale=600 / 65608366, epochs=2, device="cpu")
    np.testing.assert_allclose(rec["losses"], one["losses"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", [n for n, c in sorted(rc.CONFIGS.items())
                                  if "SCALE" not in c.env])
def test_scale_refused_where_the_script_reads_none(name, capsys):
    """Reddit's scripts read no SCALE, so the tool takes no --scale for them
    (an option the script lacks); their other knobs stay."""
    with pytest.raises(ValueError, match="reads no SCALE"):
        rc.argv(name, scale=0.5)
    assert rc.main([name, "--scale", "0.5", "--device", "cpu"]) == 2
    assert "reads no SCALE" in capsys.readouterr().err
    assert rc.argv(name, epochs=3)[rc.argv(name).index("--epochs") + 1] == "3"
