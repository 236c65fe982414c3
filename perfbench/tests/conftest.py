"""Shared helpers of the benchmark's tests: a tiny cell written into a
temporary checkout, with the real cell's limits, that the harness runs on
the CPU (the program's plain passes) or on the card.

Run with `python -m pytest perfbench/tests`; tests marked `gpu` skip
without a card."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench.spec import Cell  # noqa: E402


def write_cell(root: Path, model: str, agg: str = "float32", v: int = 600,
               edges: int = 6000, dims=(24, 16, 5), limits_of: str | None = None,
               max_in_degree: int = 100) -> Cell:
    """A checkout under `root` holding BENCHMARK.json and a copy of
    perfbench/ with one more cell, `tiny.t`: the Reddit configuration as
    `model`, cut to `v` vertices, `edges` edges and `dims`, gathering in
    `agg`, on the hyb kernel (what the cells run), held to the limits of
    `limits_of` (the full cell's by default)."""
    here = root / "perfbench"
    if not here.exists():
        shutil.copytree(REPO / "perfbench", here,
                        ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "perfbench/configs/gcn-reddit.json").read_text())
    if model == "gat":
        cfg.update(learning_rate=0.005)  # the Dorylus GAT's rate
    cfg.update(name="tiny", model=model, num_vertices=v, dims=list(dims), kernel="hyb", agg_dtype=agg)
    (here / "configs" / "tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((REPO / "perfbench/traffic/full.json").read_text())
    tr.update(edges=edges, max_in_degree=max_in_degree, epochs_per_run=2)
    (here / "traffic" / "tiny.json").write_text(json.dumps(tr))
    limits = limits_of or "gcn-reddit.full"
    shutil.copy(REPO / f"perfbench/limits/{limits}.json", here / "limits" / "tiny.t.json")
    bench["configs"].append(dict(bench["configs"][0], name="tiny",
                                 file="perfbench/configs/tiny.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="tiny.t", config="tiny",
                                   traffic="tiny"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Cell("tiny.t", root, here)


@pytest.fixture
def tiny_cell(tmp_path):
    return lambda *a, **kw: write_cell(tmp_path, *a, **kw)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)
