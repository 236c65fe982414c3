"""The control, on the card: the plain reference put in the program's place
and computed a step below the configuration's precision (its float32
matmuls in TF32), against the reference in float32, comes out not correct
under each cell's limits, while the program's checked steps come out
correct. At a size a test run holds: the Reddit widths over 40,000 vertices
and 2,000,000 edges. The cell-size readings are in PERF.md; they were made
by perfbench/calibrate.py."""

import pytest
import torch

from perfbench import check
from perfbench.harness import build_engine, first_steps, free, reference_steps
from perfbench.inputs import make_inputs

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
        ref = reference_steps(cell, inp, cuda)
        control = reference_steps(cell, inp, cuda, tf32=True)
        assert check.judge(check.readings(prog, ref), cell.limits)[0]
        assert not check.judge(check.readings(control, ref), cell.limits)[0]
