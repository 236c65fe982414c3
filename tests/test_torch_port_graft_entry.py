"""The port's entry points (dorylus_tpu_torch/graft_entry.py) against the
JAX package's (`__graft_entry__.py`), on the CPU:

  * `entry(device="cpu")`'s forward on the JAX `entry()`'s params (carried
    across with interop.params_from_numpy) equals the JAX forward on the
    same graph: the Reddit-config GCN on the hybrid-ELL op with static
    norms, f32, 1e-5 relative to max|ref|;
  * `dryrun_multichip(2, "cpu")` and `(4, "cpu")` print every `dryrun ok`
    line the JAX dry run prints at that n (gloo ranks), the tensor-parallel
    rows at 4.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dorylus_tpu_torch.graft_entry import dryrun_multichip, entry
from dorylus_tpu_torch.interop import params_from_numpy

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import __graft_entry__ as jentry  # noqa: E402

torch.set_num_threads(1)


def test_entry_matches_jax():
    jfwd, (jparams, jbatch) = jentry.entry()
    want = np.asarray(jax.jit(jfwd)(jparams, jbatch))
    fn, (params, batch) = entry(device="cpu")
    assert set(params) == set(jparams)
    for k in params:  # the same initial weights (exact_reference=False)
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(jparams[k]))
    got = fn(params_from_numpy({k: np.asarray(a) for k, a in jparams.items()}, "cpu"),
             batch).detach().numpy()
    assert got.shape == want.shape == (4096, 41)
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())


def jax_lines(n: int) -> list:
    """The lines JAX's dryrun_multichip(n) prints (__graft_entry__.py)."""
    lines = [f"dryrun ok: model={m} kernel={k} n={n}" for m in ("gcn", "gat")
             for k in ("xla", "degree", "hyb")]
    if n >= 4:
        lines += [f"dryrun ok: model={m} kernel=hyb tp=2x{n // 2}" for m in ("gcn", "gat")]
    return lines


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_prints_every_line(n, capsys):
    lines = dryrun_multichip(n, "cpu")
    printed = [l for l in capsys.readouterr().out.splitlines() if l.startswith("dryrun ok")]
    assert lines == printed == jax_lines(n)


def test_entry_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: device=None runs there")
    with pytest.raises(RuntimeError):
        entry()
    with pytest.raises(RuntimeError):
        dryrun_multichip(2)
