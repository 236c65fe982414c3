"""dorylus_tpu_torch Engine against dorylus_tpu's Engine and the golden
trajectory (CPU), its refusals, and the port's independence from jax.

Tolerances: 5-epoch train loss against JAX atol 1e-4 with f32 aggregation
(only summation orders differ) and 1e-3 with bf16 gather tables (~1e-3
relative per pass); val accuracy equal up to one vertex per epoch; the
golden trajectory within tests/test_golden.py's bounds.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dorylus_tpu.common.config import LayerConfig, TrainConfig
from dorylus_tpu.graph.dataio import load_dataset
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu_torch.engine.engine import Engine as TEngine

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN_DIR = Path(__file__).parent / "data" / "golden"


@pytest.mark.parametrize("agg_dtype", ["float32", "bfloat16"])
def test_engine_trajectory_matches_jax(agg_dtype):
    from dorylus_tpu.engine.engine import Engine as JEngine

    g = synthetic_graph(400, 6, 24, 5, seed=31)
    layers = LayerConfig([24, 12, 5])
    cfg = TrainConfig(epochs=5, eval_every=1, kernel="hyb", reuse="off",
                      agg_dtype=agg_dtype, compile_cache="off")
    jrep = JEngine(g, layers, cfg).run()
    trep = TEngine(g, layers, cfg, device="cpu").run()
    assert len(trep.epochs) == len(jrep.epochs) == 5
    jl = [e.loss for e in jrep.epochs]
    tl = [e.loss for e in trep.epochs]
    n_val = int(g.masks()[1].sum())
    if agg_dtype == "float32":
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    else:  # bf16 gather tables: ~1e-3 relative on each aggregation
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-3)
    for je, te in zip(jrep.epochs, trep.epochs):
        assert abs(je.accuracy - te.accuracy) <= 1.0 / n_val + 1e-9
    assert abs(jrep.final_accuracy - trep.final_accuracy) <= 1.0 / n_val + 1e-9
    assert trep.notes["kernel"] == "hyb" and trep.notes["device"] == "cpu"


def test_engine_sgd_decay_eval_cadence_match_jax():
    from dorylus_tpu.engine.engine import Engine as JEngine

    g = synthetic_graph(300, 5, 16, 4, seed=33)
    layers = LayerConfig([16, 8, 4])
    cfg = TrainConfig(epochs=5, eval_every=2, kernel="hyb", reuse="off",
                      adam=False, learning_rate=0.5, lr_decay_every=2,
                      compile_cache="off")
    jrep = JEngine(g, layers, cfg).run()
    trep = TEngine(g, layers, cfg, device="cpu").run()
    np.testing.assert_allclose([e.loss for e in trep.epochs],
                               [e.loss for e in jrep.epochs], rtol=0, atol=1e-4)
    # eval on epochs 0, 2 and the last one only
    assert [e.accuracy is not None for e in trep.epochs] == \
        [True, False, True, False, True]


def test_engine_hits_golden_trajectory():
    spec = json.loads((GOLDEN_DIR / "golden.json").read_text())
    g = load_dataset(GOLDEN_DIR, feature_dim=spec["dims"][0])
    cfg = TrainConfig(epochs=spec["epochs"], learning_rate=spec["lr"],
                      eval_every=1, kernel="hyb")
    report = TEngine(g, LayerConfig(spec["dims"]), cfg, device="cpu").run()
    losses = [e.loss for e in report.epochs]
    accs = [e.accuracy for e in report.epochs]
    np.testing.assert_allclose(losses, spec["train_loss"], rtol=0, atol=0.02)
    assert np.max(np.abs(np.array(accs) - np.array(spec["val_acc"]))) <= 0.055
    assert abs(report.test_accuracy - spec["test_acc"]) <= 0.055


def test_engine_early_stop_and_predict():
    g = synthetic_graph(300, 6, 16, 4, seed=35)
    eng = TEngine(g, LayerConfig([16, 8, 4]),
                  TrainConfig(epochs=50, kernel="hyb", target_accuracy=0.5),
                  device="cpu")
    rep = eng.run()
    assert len(rep.epochs) < 50 and rep.notes["converge_state"] == "DONE"
    logits = eng.predict()
    probs = eng.predict(softmax=True)
    assert logits.shape == probs.shape == (300, 4)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("overrides", [
    {"model": "gat"},
    {"kernel": "xla"},
    {"kernel": "degree"},
    {"kernel": "auto"},  # resolves to xla below 8M edges
    {"reuse": "pairs"},
    {"staleness": 2},
    {"checkpoint_dir": "ckpts"},
    {"resume": True},
    {"feat_shards": 2},
], ids=lambda d: next(iter(d)) + "=" + str(next(iter(d.values()))))
def test_engine_raises_outside_the_slice(overrides):
    g = synthetic_graph(100, 4, 8, 3, seed=1)
    cfg = TrainConfig(**{"kernel": "hyb", **overrides})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TEngine(g, LayerConfig([8, 4, 3]), cfg, device="cpu")


_NO_JAX = r"""
import pkgutil, sys
for name in [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))]:
    del sys.modules[name]
sys.modules["jax"] = None  # any import of jax now raises ImportError
import importlib
import torch
torch.set_num_threads(1)
import dorylus_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dorylus_tpu_torch.__path__,
                                                "dorylus_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from dorylus_tpu import LayerConfig, TrainConfig
from dorylus_tpu.graph.graph import synthetic_graph
from dorylus_tpu_torch.engine.engine import Engine
g = synthetic_graph(200, 5, 12, 3, seed=3)
rep = Engine(g, LayerConfig([12, 6, 3]),
             TrainConfig(epochs=2, kernel="hyb", reuse="off"), device="cpu").run()
assert len(rep.epochs) == 2 and all(e.loss == e.loss for e in rep.epochs)
assert not any(m == "jax" or m.startswith("jax.") for m, v in sys.modules.items()
               if v is not None)
print("OK", len(names))
"""


def test_port_runs_without_jax():
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("OK"), res.stdout
    assert int(res.stdout.split()[1]) >= 12  # every module was imported


def test_port_source_never_imports_jax():
    for path in (REPO / "dorylus_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")), \
                f"{path}: {line}"
