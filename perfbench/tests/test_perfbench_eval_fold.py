"""The reader of eval_fold: nothing where the program has no such counters,
the share of folded evaluations where it has them, and a traced run of a
tiny cell on the CPU whose result line carries it, equal to what the
program's counters say of that run."""

import json

import pytest
import torch

from conftest import write_cell
from dorylus_tpu_torch.common import metrics as program
from perfbench.harness import Context, run_cell
from perfbench.spec import Cell

FOLDED, FORWARDS = "engine.evals_folded", "engine.eval_forwards"


def read():
    return Cell("gcn-reddit.full").metric_reader("eval_fold")(Context({}, {}, {}, 0, None))


def test_eval_fold_reads_nothing_without_the_counters():
    program.reset()
    try:
        assert read() is None
        program.count(FOLDED, 3)  # one counter alone is no share
        assert read() is None
    finally:
        program.reset()


@pytest.mark.parametrize("folded, forwards, share", [(48, 2, 96.0), (0, 5, 0.0), (7, 0, 100.0)])
def test_eval_fold_is_the_share_of_folded_evals(folded, forwards, share):
    program.reset()
    try:
        program.count(FOLDED, folded)
        program.count(FORWARDS, forwards)
        assert read() == pytest.approx(share)
    finally:
        program.reset()


def test_a_traced_cpu_run_prints_eval_fold(tmp_path):
    """Three checked run(1) steps (each an eval forward, its two final
    evals folded), then run(2) calls (one eval folded, one forward, both
    final evals folded): the line's share is the counters'."""
    write_cell(tmp_path, "gcn")
    path = tmp_path / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    for m in bench["per_layer"]:
        if m["name"] == "eval_fold":
            m["workloads"].append("tiny.t")
    path.write_text(json.dumps(bench))
    program.reset()
    try:
        cell = Cell("tiny.t", tmp_path, tmp_path / "perfbench")
        out = run_cell(cell, 2**31 + 11, 0.2, True, torch.device("cpu"), 0.0)
        c = program.counters()
    finally:
        program.reset()
    runs = c[FORWARDS] - 3  # one eval forward a run(2), one a checked step
    assert runs >= 1 and c[FOLDED] == 6 + 3 * runs
    got = out["metrics"]["eval_fold"]
    assert got["unit"] == "%"
    assert got["value"] == pytest.approx(100.0 * c[FOLDED] / (c[FOLDED] + c[FORWARDS]))
