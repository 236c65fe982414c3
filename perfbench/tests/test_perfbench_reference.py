"""The plain reference against the port on the CPU, on a graph of a few
thousand edges: the checked epochs the harness reads from the program
(through Engine.run) against the reference's step from each state the
program started an epoch from, the one-step reference against its own
trajectory, and the comparison's verdict on a near-tie whose argmax flips."""

import pytest
import torch

from perfbench import check
from perfbench.harness import (adam_args, build_engine, checked_epochs, first_steps, problem,
                               reference_train, run_of)
from perfbench.inputs import make_inputs
from perfbench.reference.gnn import follow
from perfbench.spec import Cell

CPU = torch.device("cpu")
# The port's plain CPU passes and the reference round alike (bf16 tables,
# values and products, f32 sums) and differ in the order of their f32 sums;
# GAT's unnormalised sums of up to 100 rows magnify that order in the loss.
TOLERANCE = {"loss_gap": 1e-4, "grad_gap": 1e-5, "delta_gap": 1e-4, "eval_gap": 2e-3,
             "fold_gap": 1e-6}


def program_and_reference(cell, seed):
    inp = make_inputs(cell.config, cell.traffic, seed, CPU)
    prog, _ = first_steps(build_engine(cell.config, cell.traffic, inp, CPU), 3)
    prob = problem(cell, inp, CPU)
    return prog, prob, inp


@pytest.mark.parametrize("agg", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_reference_matches_port(tiny_cell, model, agg):
    """Three run(1) epochs and a group of two, whose first epoch's eval is
    the val stats the group hands back for it."""
    cell = tiny_cell(model, agg)
    prog, prob, _ = program_and_reference(cell, 2**31 + 17)
    ref = follow(prob, prog["states"], **adam_args(cell))
    steps, values = check.step_readings(prog, ref), check.readings(prog, ref)
    assert all(values[k] <= TOLERANCE[k] for k in TOLERANCE), values
    assert checked_epochs(3) == [False, False, False, True, False]
    assert [e is None for e in prog["evals"]] == checked_epochs(3)
    assert [s is not None for s in prog["val_stats"]] == checked_epochs(3)
    assert [("fold_gap" in s, "eval_gap" in s) for s in steps] == [(f, not f) for f in checked_epochs(3)]
    assert len(prog["states"]) == 6 and prog["losses"][4] < prog["losses"][0]


def equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_step_one_reads_as_the_trajectory(tiny_cell, model):
    """Step 1 starts from the seed's weights and zero moments on both
    sides, as the reference's own trajectory does: its loss, gradient and
    changes are the trajectory's bit for bit, so loss_gap, grad_gap and
    delta_gap read as the trajectory check read them; its eval is the
    reference's forward on the program's p_1 (the trajectory's was on its
    own p_1, which differs from the program's by rounding)."""
    cell = tiny_cell(model, "bfloat16")
    prog, prob, inp = program_and_reference(cell, 2**31 + 23)
    traj = reference_train(cell, prob, inp)
    ref = follow(prob, prog["states"], **adam_args(cell))
    assert all(equal(prog["states"][0][p], traj["states"][0][p]) for p in check.PARTS)
    assert ref["losses"][0] == traj["losses"][0]
    assert equal(ref["grad1"], traj["grad1"])
    assert all(equal(ref["after"][0][p], traj["states"][1][p]) for p in check.PARTS)
    step1 = check.step_readings(prog, ref)[0]
    change = check.step_change(prog["states"][0], prog["states"][1])
    traj_change = check.step_change(traj["states"][0], traj["states"][1])
    keep = check.kept_leaves(traj["grad1"])
    assert step1["loss_gap"] == abs(prog["losses"][0] - traj["losses"][0]) / abs(traj["losses"][0])
    assert step1["delta_gap"] == max(check.worst_leaf(change[p], traj_change[p], keep)
                                     for p in check.PARTS)
    assert check.readings(prog, ref)["grad_gap"] == check.worst_leaf(
        prog["grad1"], traj["grad1"], list(traj["grad1"]))
    p1 = prog["states"][1]["params"]
    assert step1["eval_gap"] == check.logits_gap(prog["evals"][0], prob.evaluate(p1))
    assert step1["eval_gap"] <= TOLERANCE["eval_gap"]


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_one_step_from_the_trajectorys_state_is_its_step(tiny_cell, model):
    """The reference's step t from the state its own trajectory started
    step t from gives that step's loss, parameters, moments and eval bit
    for bit."""
    cell = tiny_cell(model, "bfloat16")
    inp = make_inputs(cell.config, cell.traffic, 2**31 + 29, CPU)
    prob = problem(cell, inp, CPU)
    traj = reference_train(cell, prob, inp)
    ref = follow(prob, traj["states"], **adam_args(cell))
    assert ref["losses"] == traj["losses"] and equal(ref["grad1"], traj["grad1"])
    for got, want in zip(ref["after"], traj["states"][1:], strict=True):
        assert all(equal(got[p], want[p]) for p in check.PARTS)
    assert all(torch.equal(a, b) for a, b in zip(ref["evals"], traj["evals"], strict=True))
    values = check.readings(run_of(cell, prob, traj), ref)
    assert values["loss_gap"] == values["grad_gap"] == values["delta_gap"] == 0.0
    assert values["eval_gap"] == values["fold_gap"] == 0.0


def val_stats(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    p_true = torch.softmax(logits.double(), -1).gather(1, labels[:, None])[:, 0]
    return torch.stack([(logits.argmax(1) == labels).sum().double(), -p_true.log().sum(),
                        torch.tensor(float(len(labels)), dtype=torch.float64)])


def test_one_argmax_flip_on_a_near_tie_is_correct():
    """The two sides agree but for one validation row whose top two logits
    tie to 1e-6: their argmax counts differ by one vertex, which an
    accuracy comparison calls a gap of 1 / rows; the logits comparison,
    and the val stats' loss sum and rows, read a rounding-sized gap, within
    every cell's limits."""
    gen = torch.Generator().manual_seed(3)
    ref_logits = torch.randn((23_296, 41), generator=gen)
    ref_logits[0, 3], ref_logits[0, 7] = 9.0, 9.0 - 1e-6
    prog_logits = ref_logits.clone()
    prog_logits[0, 7] = 9.0 + 1e-6
    labels = torch.full((23_296,), 3)
    ref_stats, prog_stats = val_stats(ref_logits, labels), val_stats(prog_logits, labels)
    assert ref_stats[0] - prog_stats[0] == 1
    leaves = {"w0": torch.randn((602, 128), generator=gen), "w1": torch.randn((128, 41), generator=gen)}
    states = [{p: {k: (1 + i) * t for k, t in leaves.items()} for p in check.PARTS}
              for i in range(4)]
    ref = {"losses": [3.7, 3.6, 3.5], "grad1": leaves, "after": states[1:],
           "evals": [ref_logits] * 3, "val_stats": [ref_stats] * 3}
    prog = {"losses": ref["losses"], "grad1": leaves, "states": states,
            "evals": [prog_logits, None, prog_logits], "val_stats": [None, prog_stats, None]}
    values = check.readings(prog, ref)
    assert values["eval_gap"] < 1e-8 and values["fold_gap"] < 1e-9
    for name in ("gcn-reddit.full", "gcn-reddit.sparse"):
        assert check.judge(values, Cell(name).limits)[0]


def test_val_stats_gap_reads_the_loss_sum_and_the_rows():
    """The val stats' reading is the larger relative gap of the loss sum
    and the row count; the correct count is not read."""
    ref = torch.tensor([100.0, 2000.0, 400.0], dtype=torch.float64)
    assert check.stats_gap(torch.tensor([90.0, 2000.0, 400.0]), ref) == 0.0
    assert check.stats_gap(torch.tensor([100.0, 2010.0, 400.0]), ref) == pytest.approx(5e-3)
    assert check.stats_gap(torch.tensor([100.0, 2000.0, 200.0]), ref) == pytest.approx(0.5)
