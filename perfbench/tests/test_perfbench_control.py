"""The control, on the card: the plain reference put in the program's place
and computed a step below the configuration's precision (its float32
matmuls in TF32), each of its epochs against the float32 reference's step
from the same state, comes out not correct under each cell's limits, while
the program's checked epochs come out correct. At a size a test run holds:
the Reddit widths over 40,000 vertices and 2,000,000 edges. The cell-size
readings are in PERF.md; they were made by perfbench/calibrate.py."""

import pytest

from perfbench import check
from perfbench.harness import (adam_args, build_engine, first_steps, free, problem,
                               reference_train, run_of)
from perfbench.inputs import make_inputs
from perfbench.reference.gnn import follow

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("limits", ["gcn-reddit.full", "gcn-reddit.sparse"])
def test_control_fails_and_program_passes(tiny_cell, cuda, limits):
    cell = tiny_cell("gcn", "bfloat16", v=40_000, edges=2_000_000, dims=(602, 128, 41),
                     limits_of=limits, max_in_degree=3_700)
    for seed in (2**31 + 5, 2**31 + 6, 2**31 + 7):
        inp = make_inputs(cell.config, cell.traffic, seed, cuda)
        eng = build_engine(cell.config, cell.traffic, inp, cuda)
        prog, _ = first_steps(eng, 3)
        del eng
        free(cuda)
        prob = problem(cell, inp, cuda)
        control = run_of(cell, prob, reference_train(cell, prob, inp, tf32=True))
        for side, correct in ((prog, True), (control, False)):
            ref = follow(prob, side["states"], **adam_args(cell))
            assert check.judge(check.readings(side, ref), cell.limits)[0] is correct
