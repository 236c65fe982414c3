"""The plain reference against the port on the CPU, on a graph of a few
thousand edges: the checked steps the harness reads from the program
(through Engine.run) against `reference.gnn.train` from the same inputs,
and the comparison's verdict on a near-tie whose argmax flips."""

import pytest
import torch

from perfbench import check
from perfbench.harness import build_engine, first_steps, reference_steps
from perfbench.inputs import make_inputs
from perfbench.spec import Cell

CPU = torch.device("cpu")
# The port's plain CPU passes and the reference round alike (bf16 tables,
# values and products, f32 sums) and differ in the order of their f32 sums;
# GAT's unnormalised sums of up to 100 rows magnify that order in the loss.
TOLERANCE = {"loss_gap": 1e-4, "grad_gap": 1e-5, "delta_gap": 1e-4, "eval_gap": 2e-3}


@pytest.mark.parametrize("agg", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_reference_matches_port(tiny_cell, model, agg):
    cell = tiny_cell(model, agg)
    inp = make_inputs(cell.config, cell.traffic, 2**31 + 17, CPU)
    eng = build_engine(cell.config, cell.traffic, inp, CPU)
    prog, _ = first_steps(eng, 3)
    values = check.readings(prog, reference_steps(cell, inp, CPU))
    assert all(values[k] <= TOLERANCE[k] for k in TOLERANCE), values
    assert len(prog["losses"]) == 3 and prog["losses"][2] < prog["losses"][0]


def test_one_argmax_flip_on_a_near_tie_is_correct():
    """The two sides agree but for one validation row whose top two logits
    tie to 1e-6: their argmax counts differ by one vertex, which an
    accuracy comparison calls a gap of 1 / rows; the logits comparison
    reads a rounding-sized gap, within every cell's limits."""
    gen = torch.Generator().manual_seed(3)
    ref_logits = torch.randn((23_296, 41), generator=gen)
    ref_logits[0, 3], ref_logits[0, 7] = 9.0, 9.0 - 1e-6
    prog_logits = ref_logits.clone()
    prog_logits[0, 7] = 9.0 + 1e-6
    labels = torch.full((23_296,), 3)
    assert int((ref_logits.argmax(1) == labels).sum()) - int(
        (prog_logits.argmax(1) == labels).sum()) == 1
    leaves = {"w0": torch.randn((602, 128), generator=gen), "w1": torch.randn((128, 41), generator=gen)}
    ref = {"losses": [3.7, 3.6, 3.5], "grad1": leaves, "deltas": [leaves] * 3,
           "evals": [ref_logits] * 3}
    prog = dict(ref, evals=[prog_logits] * 3)
    values = check.readings(prog, ref)
    assert values["eval_gap"] < 1e-8
    for name in ("gcn-reddit.full", "gcn-reddit.sparse"):
        assert check.judge(values, Cell(name).limits)[0]
