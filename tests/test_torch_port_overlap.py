"""The halo exchange beside each rank's interior work (parallel/halo.py
`Halo.start` / `finish`, parallel/multihost.py `all_to_all_rows_start` /
`all_to_all_rows_finish`), on 2 and 4 gloo CPU ranks:

  * the call order: a recording stand-in around the all-to-all's start and
    finish and around the interior op shows, on every rank and at every
    layer, the interior op issued between the exchange's start and its
    finish, for GCN and GAT on the fused plan (K8's pure range), the degree
    pair and the edgewise split; and each reverse exchange started before
    the layer's gradient work that does not read it (`_torch_ranks.BESIDE`)
    and finished after it;
  * the overlapped engines against the same plan with both exchanges
    called whole at their finish (bit for bit: the same sums in the same
    order), against the order before the split (the whole exchange first:
    bit for bit on the fused plan and GCN's degree pair, whose gradient
    sums keep their order; 1e-6 on the others, where h's gradient adds the
    exchange's share in another order), against the combined plan (rtol
    1e-5) and
    against JAX's `ShardedEngine` at tests/test_torch_port_sharded.py's
    `loss_close` tolerances, on a clustered graph whose ranks have pure rows
    and on a random one;
  * K8's two plain halves (`fused_pure_plain`, `fused_mixed_plain`) against
    one `fused_pass_plain`, and the two ranges' descriptor tables walked as
    the kernel runs them against the one table's walk, bit for bit, f32 and
    bf16 gather;
  * a second start on the busy pinned buffers is refused;
  * the NCCL transport with its streams stood in for (the fork before the
    collective, the join at the finish) and the epoch's capture stood in for
    by `_torch_ranks.Rerun`: the interior work between fork and join, in
    the forward and in the backward, no host read inside the replayed
    bodies, bit for bit with the eager ranks.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from dorylus_tpu.graph.graph import clustered_synthetic_graph as j_clustered
from dorylus_tpu.graph.graph import synthetic_graph as j_synthetic
from dorylus_tpu_torch.graph.graph import clustered_synthetic_graph, synthetic_graph
from dorylus_tpu_torch.graph.partition import partition_graph
from dorylus_tpu_torch.ops import gather_parts
from dorylus_tpu_torch.ops import hyb_sharded as hs
from dorylus_tpu_torch.parallel.multihost import spawn_local
from test_torch_port_sharded import jax_sharded, loss_close

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs >=4 devices (virtual CPU mesh)")

DIMS = [16, 8, 5]
LR = {"gcn": 0.01, "gat": 0.005}
KERNELS = ("hyb", "degree", "xla")
HOWS = ("two-step", "one-call", "serial", "combined")
LAYERS = len(DIMS) - 1
# one loss and its gradient on 2 layers, per (kernel, model): each forward
# exchange holds its layer's interior op, each reverse exchange its layer's
# gradient work that does not read it
EVENTS = {(k, m): ranks.events_of(k, m, LAYERS) for k in KERNELS for m in ("gcn", "gat")}
GRAPHS = {"clustered": (clustered_synthetic_graph, j_clustered,
                        (2000, 8, 16, 5), dict(seed=11, window=256, cut=0.1)),
          "random": (synthetic_graph, j_synthetic, (2000, 8, 16, 5), dict(seed=7))}


def _cases(model):
    base = dict(model=model, learning_rate=LR[model], eval_every=1, reuse="off")
    return [(dict(base, kernel=k, overlap=how != "combined"), 4,
             "plain" if how == "combined" else how)
            for k in KERNELS for how in HOWS]


def _same(a, b):
    return a["losses"] == b["losses"] and a["accuracies"] == b["accuracies"] and all(
        np.array_equal(a["params"][k], b["params"][k]) for k in a["params"])


@pytest.mark.parametrize("name,n,model", [("clustered", 2, "gcn"), ("clustered", 2, "gat"),
                                          ("clustered", 4, "gcn"), ("clustered", 4, "gat"),
                                          ("random", 2, "gcn")])
def test_interior_work_runs_inside_the_exchange(name, n, model):
    make, j_make, args, kw = GRAPHS[name]
    graph = make(*args, **kw)
    cases = _cases(model)
    res = spawn_local(n, ranks.overlap_rank, (graph, DIMS, cases), backend="gloo",
                      device="cpu", timeout_s=300)
    jgraph = j_make(*args, **kw)
    for k, kernel in enumerate(KERNELS):
        for r in range(n):
            two, one, serial, comb = res[r][4 * k: 4 * k + 4]
            assert (two["kernel"], two["overlap"], comb["overlap"]) == (kernel, True, False)
            assert two["events"] == EVENTS[kernel, model], (kernel, r, two["events"])
            assert _same(two, one), (kernel, r)
            if kernel == "hyb" or (kernel, model) == ("degree", "gcn"):
                assert _same(two, serial), r
            else:
                np.testing.assert_allclose(two["losses"], serial["losses"], rtol=1e-6)
            np.testing.assert_allclose(two["losses"], comb["losses"], rtol=1e-5)
            assert two["losses"] == res[0][4 * k]["losses"]
        if kernel == "hyb":
            pure = [res[r][4 * k]["n_pure"] for r in range(n)]
            if name == "clustered":
                assert all(p > 0 for p in pure), pure
        jl, jeng = jax_sharded(jgraph, n, epochs=4, model=model, kernel=kernel, overlap=True,
                               learning_rate=LR[model], eval_every=1)
        assert jeng.cfg.overlap
        loss_close(res[0][4 * k]["losses"], jl, model, False)


@pytest.mark.parametrize("mode", ["static", "mask"])
@pytest.mark.parametrize("gd", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_k8_halves_are_one_fused_pass(gd, mode):
    """The pure half then the mixed half equal one `fused_pass_plain` bit
    for bit, through the dispatchers and through `FusedFn` with the pure
    range made first (forward and gradients); the two ranges' descriptor
    tables, walked as the kernel runs them, equal the one table's walk."""
    g = clustered_synthetic_graph(2000, 8, 16, 5, seed=11, window=256, cut=0.1)
    sg = partition_graph(g, 4)
    rng = np.random.default_rng(3)
    for shard in sg.shards:
        op = hs.ShardedHybSpMM(shard, sg.n_shards, edges="fused",
                               static_vals=mode == "static", gather_dtype=gd, max_width=12,
                               lam_slots=256, device="cpu")
        assert op.n_pure > 0 and op.pure_edges > 0 and op.fwd["top"] is not None
        f = op.fwd
        assert set(f["pure"]["parts"].splits) == {gather_parts.LOCAL_ONLY}
        assert set(f["mixed"]["parts"].splits) == {op.vp}
        assert (len(f["pure"]["parts"].parts) + len(f["mixed"]["parts"].parts)
                == len(f["parts"].parts))
        h = torch.tensor(rng.normal(size=(op.vp, 24)).astype(np.float32))
        gh = torch.tensor(rng.normal(size=(op.table - op.vp, 24)).astype(np.float32))
        want = hs.fused_pass_plain(h, gh, f, op.n_pure, gd, mode)
        pure = hs.fused_pure_plain(h, f, op.n_pure, gd, mode)
        assert torch.equal(hs.fused_mixed_plain(pure, gh, f, op.n_pure, gd, mode), want)
        pure = hs.fused_pure_pass(h, f, op.n_pure, gd, mode)
        assert torch.equal(hs.fused_mixed_pass(pure, gh, f, op.n_pure, gd, mode), want)
        walks = [gather_parts.walk_plain(pt, 8, tables, op.vp, gd, mode)
                 for pt, tables in ((f["parts"], (h, gh)), (f["pure"]["parts"], (h,)),
                                    (f["mixed"]["parts"], (h, gh)))]
        assert torch.equal(walks[1] + walks[2], walks[0])
        # through the entry, the pure range made beforehand or inside
        dv = torch.tensor(rng.normal(size=op.vp).astype(np.float32))
        gout = torch.tensor(rng.normal(size=(op.vp, 24)).astype(np.float32))
        got = []
        for early in (True, False):
            hk, gk, dk = (t.clone().requires_grad_(True) for t in (h, gh, dv))
            pr = op.pure_range(hk, mode) if early else None
            out = (op.apply_static_fused(hk, gk, pr) if mode == "static"
                   else op.apply_dst_fused(hk, gk, dk, pr))
            out.backward(gout)
            got.append([out.detach(), hk.grad, gk.grad] + ([] if mode == "static" else [dk.grad]))
        assert torch.equal(got[0][0], want if mode == "static" else want * dv[:, None])
        assert all(torch.equal(a, b) for a, b in zip(*got))


def test_a_second_start_on_the_busy_pinned_buffers_is_refused():
    res = spawn_local(2, ranks.busy_tag_rank, (), backend="gloo", device="cpu",
                      timeout_s=120)
    for r, out in enumerate(res):
        assert "already holds the pinned buffers" in out["refused"]
        np.testing.assert_array_equal(out["first"], out["want"])
        np.testing.assert_array_equal(out["again"], out["want"])


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_nccl_transport_forks_and_joins_around_the_interior_work(model):
    graph = clustered_synthetic_graph(2000, 8, 16, 5, seed=11, window=256, cut=0.1)
    res = spawn_local(2, ranks.nccl_standin_rank, (graph, DIMS, model, LR[model]),
                      backend="gloo", device="cpu", timeout_s=240)
    for r in range(2):
        for kernel, out in res[r].items():
            want = ranks.events_of(kernel, model, LAYERS, fork=("fork", "collective"),
                                   join=("join",))
            assert out["events"] == want, (kernel, r, out["events"])
            assert out["graphed"] and out["graph_losses"] == out["eager_losses"], kernel
            assert out["graph_losses"] == res[0][kernel]["graph_losses"]
