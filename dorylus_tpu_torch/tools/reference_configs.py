"""The reference-config runs: the six run scripts of `benchmarks/run-*` as data,
run through the port's command line in this process.

    python -m dorylus_tpu_torch.tools.reference_configs amazon-gcn \\
        [--scale S] [--epochs N] [--shards N] [--data-dir D] [--target-acc A] \\
        [--device cpu] [--out FILE] [-- extra cli flags]

Each run script is a bash script that hands `python -m dorylus_tpu.cli train`
a fixed command line: the dataset and layer config, the model, the
learning rate, `--synth-vertices` (the paper's vertex count times the
script's `SCALE`), `--synth-degree` (the half-degree: the generator
doubles for undirectedness), `--agg-bf16 --reorder degree-asc` and its
report file. Its env knobs are this tool's flags: `SCALE` (`--scale`),
`EPOCHS`, `SHARDS`, `DATA` (`--data-dir`), `TARGET_ACC` (`--target-acc`;
only reddit-large's script has it, the others take it as an extra flag of
the command line) and the script's own arguments (after `--`). Reddit's
scripts read no `SCALE`, and the tool refuses `--scale` for them. The
default `SCALE` of each config is its script's, so the two packages'
default runs build the same graph (seed 8888). `argv(...)` is the list
the script would hand the command line; `run(...)` hands it to the port's
`cli.main` (the card unless `--device cpu`), with the report file in a
temporary directory, and returns one record in the shape of
`benchmarks/results/amazon_config_gcn_r5.json`: the graph, the kernel
`auto` picked, the set-up seconds (graph, reorder, the engine's plans),
the first epoch's seconds and the warm epoch ms, the losses and the val
accuracy's tail, the card's peak memory (the report's notes["hbm"]), the
host's peak RSS, and the card's name and power limit. `--out` writes the
record to a file as well.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RefConfig:
    """One run script of `benchmarks/`: its command line's fixed parts and its
    env knobs' defaults."""

    script: str              # benchmarks/<script>
    dataset: str
    config: str
    model: str
    synth_degree: int
    paper_vertices: int      # the vertex count the script scales
    scale: float             # the script's default SCALE (Reddit: none, 1)
    epochs: int              # the script's default EPOCHS
    learning_rate: Optional[float] = None
    report: str = ""         # the script's --output file
    # the env knobs the script reads (DATA and TARGET_ACC where it does
    # not: the command line's flags, passed as the script's own arguments;
    # SCALE where it does not: refused)
    env: tuple = ("SCALE", "EPOCHS", "SHARDS", "DATA")

    @property
    def vertices(self) -> int:
        return int(self.paper_vertices * self.scale)


CONFIGS = {
    "reddit-gcn": RefConfig("run-reddit-gcn", "reddit", "reddit", "gcn", 25, 232965, 1.0, 100,
                            report="reddit-gcn-report.json",
                            env=("EPOCHS", "SHARDS", "DATA")),
    "reddit-gat": RefConfig("run-reddit-gat", "reddit", "reddit", "gat", 25, 232965, 1.0, 100,
                            learning_rate=0.005, report="reddit-gat-report.json",
                            env=("EPOCHS", "SHARDS")),
    "reddit-large-gcn": RefConfig("run-reddit-large-gcn", "reddit-large", "reddit-large", "gcn",
                                  22, 2449029, 0.2, 10, report="reddit-large-gcn-report.json",
                                  env=("SCALE", "EPOCHS", "SHARDS", "DATA", "TARGET_ACC")),
    "amazon-gcn": RefConfig("run-amazon-gcn", "amazon", "amazon", "gcn", 12, 9430088, 0.12, 10,
                            report="amazon-gcn-report.json"),
    "amazon-gat": RefConfig("run-amazon-gat", "amazon", "amazon", "gat", 12, 9430088, 0.12, 10,
                            learning_rate=0.005, report="amazon-gat-report.json"),
    "friendster-gcn": RefConfig("run-friendster-gcn", "friendster", "friendster", "gcn", 14,
                                65608366, 0.02, 10, report="friendster-gcn-report.json"),
}


def argv(name: str, scale: Optional[float] = None, epochs: Optional[int] = None,
         shards: int = 1, data_dir: Optional[str] = None,
         target_acc: Optional[float] = None, extra: tuple = ()) -> list:
    """The `train` command line run script `name` hands the CLI, with its env
    knobs set as given (None: the script's default). ValueError for a
    `scale` where the script reads no SCALE."""
    c = CONFIGS[name]
    if scale is not None:
        if "SCALE" not in c.env:
            raise ValueError(f"{name}: its script {c.script} reads no SCALE")
        c = dataclasses.replace(c, scale=scale)
    out = ["train", "--dataset", c.dataset, "--config", c.config, "--model", c.model,
           "--epochs", str(c.epochs if epochs is None else epochs), "--shards", str(shards)]
    if c.learning_rate is not None:
        out += ["--learning-rate", str(c.learning_rate)]
    out += ["--synth-vertices", str(c.vertices), "--synth-degree", str(c.synth_degree),
            "--agg-bf16", "--reorder", "degree-asc", "--output", c.report]
    if data_dir:
        out += ["--data-dir", data_dir]
    if target_acc is not None:
        out += ["--target-acc", str(target_acc)]
    return out + list(extra)


def card() -> dict:
    """The card's name and power limit as nvidia-smi prints them, or Nones
    where there is no card or no nvidia-smi."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        name, limit = smi.stdout.strip().splitlines()[0].split(", ")
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"name": None, "power_limit": None}


def record(name: str, report: dict, cmd: list, device: str) -> dict:
    """The record of one run from the CLI's report (its JSON); the host's
    peak RSS is this process's (a sharded run's ranks are not in it)."""
    from dorylus_tpu_torch.tools.scale_pipeline import rss_gb

    c = CONFIGS[name]
    epochs = report["epochs"]
    notes = report["notes"]
    accs = [e["accuracy"] for e in epochs if e["accuracy"] is not None]
    hbm = notes.get("hbm")
    return {
        "config": c.config, "model": c.model, **notes["graph"],
        "kernel": notes.get("kernel"), "argv": cmd, "device": device,
        "setup_s": notes["setup_s"],
        "first_epoch_s": epochs[0]["time_ms"] / 1e3 if epochs else None,
        "warm_epoch_ms": (sum(e["time_ms"] for e in epochs[1:]) / (len(epochs) - 1)
                          if len(epochs) > 1 else None),
        "epoch_ms": [e["time_ms"] for e in epochs],
        "losses": [e["loss"] for e in epochs],
        "val_acc_tail": accs[-1] if accs else report["final_accuracy"],
        "final_accuracy": report["final_accuracy"],
        "test_accuracy": report["test_accuracy"],
        "hbm_peak_bytes": None if hbm is None else hbm["peak_bytes_in_use"],
        "hbm_limit_bytes": None if hbm is None else hbm["bytes_limit"],
        "host_peak_rss_gb": rss_gb(),
        "card": card() if device != "cpu" else {"name": None, "power_limit": None},
    }


def run(name: str, scale: Optional[float] = None, epochs: Optional[int] = None,
        shards: int = 1, data_dir: Optional[str] = None,
        target_acc: Optional[float] = None, device: Optional[str] = None,
        extra: tuple = ()) -> dict:
    """Run script `name`'s command line through the port's `cli.main` in this
    process; its record. device None is the card (the CLI's default)."""
    from dorylus_tpu_torch import cli

    cmd = argv(name, scale, epochs, shards, data_dir, target_acc, extra)
    with tempfile.TemporaryDirectory(prefix="dorylus_refcfg_") as tmp:
        at = cmd.index("--output") + 1
        cmd_run = cmd[:at] + [str(Path(tmp) / cmd[at])] + cmd[at + 1:]
        if device is not None:
            cmd_run += ["--device", device]
        with contextlib.redirect_stdout(sys.stderr):  # stdout holds the record alone
            rc = cli.main(cmd_run)
        if rc != 0:
            raise RuntimeError(f"{name}: the command line exited {rc}")
        report = json.loads((Path(tmp) / cmd[at]).read_text())
    return record(name, report, cmd_run[:at] + [cmd[at]] + cmd_run[at + 1:],
                  report["notes"].get("device", device or "cuda"))


def main(args: Optional[list] = None) -> int:
    args = list(sys.argv[1:] if args is None else args)
    extra = []
    if "--" in args:
        at = args.index("--")
        args, extra = args[:at], args[at + 1:]
    ap = argparse.ArgumentParser(prog="reference_configs",
                                 description="run a script of benchmarks/ through the "
                                             "port's command line")
    ap.add_argument("name", choices=sorted(CONFIGS))
    ap.add_argument("--scale", type=float, default=None,
                    help="the script's SCALE (default: its own)")
    ap.add_argument("--epochs", type=int, default=None, help="the script's EPOCHS")
    ap.add_argument("--shards", type=int, default=1, help="the script's SHARDS")
    ap.add_argument("--data-dir", default=None, help="the script's DATA")
    ap.add_argument("--target-acc", type=float, default=None,
                    help="the script's TARGET_ACC (reddit-large-gcn)")
    ap.add_argument("--device", default=None, help="cpu, or the card by default")
    ap.add_argument("--out", default=None, help="write the record to this file too")
    a = ap.parse_args(args)
    try:
        rec = run(a.name, a.scale, a.epochs, a.shards, a.data_dir, a.target_acc, a.device,
                  tuple(extra))
    except (RuntimeError, ValueError) as e:
        print(f"reference_configs: {e}", file=sys.stderr)
        return 2
    text = json.dumps(rec, indent=1)
    print(text, flush=True)
    if a.out:
        Path(a.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
