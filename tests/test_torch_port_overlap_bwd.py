"""The backward's reverse halo exchange beside the rank's gradient work that
does not read it (parallel/halo.py `ReverseExchange`, `HaloJoinFn`; JAX's
`_planned_bwd` / `_ragged_bwd`, which XLA may schedule beside the layer's
other gradient work), on 2 and 4 gloo CPU ranks of a 2,000-vertex clustered
graph (every rank has pure rows) at DIMS [16, 8, 5]:

  (a) the recorded order of one loss and its gradient, on every rank and
      layer, for GCN and GAT on the fused plan, the degree pair and the
      edgewise split: the reverse exchange's start, the gradient work that
      does not read it (`_torch_ranks.BESIDE`: the interior op's backward,
      the self term, GAT's attention gradient), then its finish; the
      combined plan and tensor parallelism run every reverse exchange whole;
  (b) the overlapped engines bit for bit with both exchanges called whole
      at their finish (the same sums in the same order), within 1e-6 of the
      reverse exchange run whole in HaloRecvFn's backward (the order before
      it was split), within 1e-5 of the combined plan, and within
      tests/test_torch_port_sharded.py's `loss_close` of JAX's
      `ShardedEngine`;
  (c) the same at staleness 1 on the degree pair;
  (d) the NCCL transport with its streams stood in for and the epoch's
      capture stood in for by `_torch_ranks.Rerun`: a replay of the train
      graph's body forks and joins each reverse exchange around the
      gradient work beside it, with host reads refused; replayed = eager;
  (e) a backward that prunes the join (an unfinished reverse exchange) or
      HaloRecvFn's node (a finish with nothing started) is refused.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from dorylus_tpu.graph.graph import clustered_synthetic_graph as j_clustered
from dorylus_tpu_torch.graph.graph import clustered_synthetic_graph
from dorylus_tpu_torch.parallel.multihost import spawn_local
from test_torch_port_sharded import jax_sharded, loss_close

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs >=4 devices (virtual CPU mesh)")

DIMS = [16, 8, 5]
LAYERS = len(DIMS) - 1
LR = {"gcn": 0.01, "gat": 0.005}
KERNELS = ("hyb", "degree", "xla")
HOWS = ("two-step", "one-call", "reverse-whole", "combined")
ARGS, KW = (2000, 8, 16, 5), dict(seed=11, window=256, cut=0.1)
EPOCHS = 3
SPLIT, WHOLE = {"split": LAYERS, "whole": 0}, {"split": 0, "whole": LAYERS}


@pytest.fixture(scope="module")
def graph():
    return clustered_synthetic_graph(*ARGS, **KW)


def _cases(model, kernels=KERNELS, **extra):
    base = dict(model=model, learning_rate=LR[model], eval_every=1, reuse="off", **extra)
    return [(dict(base, kernel=k, overlap=how != "combined"), EPOCHS,
             "plain" if how == "combined" else how)
            for k in kernels for how in HOWS]


def _same(a, b):
    return a["losses"] == b["losses"] and all(
        np.array_equal(a["params"][k], b["params"][k]) for k in a["params"])


def _check(res, model, kernels, n):
    """(a) and (b) on every rank, for the four runs of each kernel."""
    for k, kernel in enumerate(kernels):
        for r in range(n):
            two, one, whole, comb = res[r][4 * k: 4 * k + 4]
            assert (two["kernel"], two["overlap"], comb["overlap"]) == (kernel, True, False)
            assert two["events"] == ranks.events_of(kernel, model, LAYERS), (
                kernel, r, two["events"])
            assert (two["reverse"], comb["reverse"]) == (SPLIT, WHOLE), (kernel, r)
            assert _same(two, one), (kernel, r)
            np.testing.assert_allclose(two["losses"], whole["losses"], rtol=1e-6)
            np.testing.assert_allclose(two["losses"], comb["losses"], rtol=1e-5)
            assert two["losses"] == res[0][4 * k]["losses"]


@pytest.mark.parametrize("n", [2, 4])
def test_reverse_exchange_runs_beside_the_gradient_work(graph, n):
    """(a), (b) for GCN and GAT in one launch; on 4 ranks also 2 graph x 2
    feat shards, whose reverse exchanges run whole."""
    cases = _cases("gcn") + _cases("gat")
    if n == 4:
        cases += [(dict(model=model, learning_rate=LR[model], eval_every=1, reuse="off",
                        kernel="hyb", feat_shards=2, num_shards=2), 1, "plain")
                  for model in ("gcn", "gat")]
    res = spawn_local(n, ranks.overlap_rank, (graph, DIMS, cases), backend="gloo",
                      device="cpu", timeout_s=300)
    runs = 4 * len(KERNELS)
    jgraph = j_clustered(*ARGS, **KW)
    for m, model in enumerate(("gcn", "gat")):
        _check([rows[m * runs:(m + 1) * runs] for rows in res], model, KERNELS, n)
        if n == 2:
            for k, kernel in enumerate(KERNELS):
                jl, _ = jax_sharded(jgraph, n, epochs=EPOCHS, model=model, kernel=kernel,
                                    overlap=True, learning_rate=LR[model], eval_every=1)
                loss_close(res[0][m * runs + 4 * k]["losses"], jl, model, False)
    if n == 4:
        assert all(c["reverse"] == WHOLE for r in range(n) for c in res[r][2 * runs:])


def test_stale_epochs_on_the_degree_pair(graph):
    cases = _cases("gcn", ("degree",), staleness=1) + _cases("gat", ("degree",), staleness=1)
    res = spawn_local(2, ranks.overlap_rank, (graph, DIMS, cases), backend="gloo",
                      device="cpu", timeout_s=300)
    jgraph = j_clustered(*ARGS, **KW)
    for m, model in enumerate(("gcn", "gat")):
        _check([rows[4 * m: 4 * m + 4] for rows in res], model, ("degree",), 2)
        jl, _ = jax_sharded(jgraph, 2, epochs=EPOCHS, model=model, kernel="degree",
                            overlap=True, learning_rate=LR[model], eval_every=1, staleness=1)
        loss_close(res[0][4 * m]["losses"], jl, model, False)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_nccl_capture_forks_and_joins_around_the_gradient_work(graph, model):
    res = spawn_local(2, ranks.nccl_standin_rank, (graph, DIMS, model, LR[model], True),
                      backend="gloo", device="cpu", timeout_s=240)
    for r in range(2):
        for kernel, out in res[r].items():
            want = ranks.events_of(kernel, model, LAYERS, fork=("fork", "collective"),
                                   join=("join",))
            assert out["events"] == want, (kernel, r, out["events"])
            assert out["replayed_events"] == want, (kernel, r, out["replayed_events"])
            assert out["graphed"] and out["graph_losses"] == out["eager_losses"], kernel
            assert out["graph_losses"] == res[0][kernel]["graph_losses"]


def test_pruned_or_unfinished_reverse_exchange_is_refused(graph):
    res = spawn_local(2, ranks.refusal_rank, (graph,), backend="gloo", device="cpu",
                      timeout_s=120)
    for r, out in enumerate(res):
        assert out["equal"], (r, out["max_abs"])
        assert "never started" in out["pruned_start"], out
        for key in ("forward_after", "reverse_after"):
            assert "while a reverse exchange is open" in out[key], (key, out)
