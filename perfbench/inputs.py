"""A cell's inputs, made from the seed and handed to both the program and
the plain reference: the graph, the features, the labels, the original
vertex ids the split follows, and the initial weights.

The in-degrees follow the traffic's degree law and the out-degrees are
even, both the same for every seed (the same work in every run); the seed
deals the sources to the edges and draws the features, the labels, the ids
and the weights. Everything
large is drawn on the device in a few calls and copied to the host once:
the program takes a host-side `Graph`, the reference the host arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def pareto_degrees(v: int, d_min: float, d_max: float, tail: float) -> np.ndarray:
    """Real-valued in-degrees of a Pareto law of tail index `tail`
    truncated to [d_min, d_max], read at the quantiles (i + 0.5) / v:
    ascending, the largest just under d_max."""
    q = (np.arange(v, dtype=np.float64) + 0.5) / v
    keep = 1.0 - (d_min / d_max) ** tail
    return d_min / (1.0 - q * keep) ** (1.0 / tail)


def solve_d_min(v: int, edges: int, traffic: dict) -> float:
    """The law's lower end at which the v quantile degrees sum to `edges`
    (bisection)."""
    if traffic["degree_law"] != "truncated_pareto":
        raise ValueError(f"unknown degree law {traffic['degree_law']!r}")
    d_max, tail = float(traffic["max_in_degree"]), float(traffic["tail_index"])
    lo, hi = 1e-6, d_max
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if pareto_degrees(v, mid, d_max, tail).sum() < edges:
            lo = mid
        else:
            hi = mid
    return hi


def degree_sequence(v: int, edges: int, traffic: dict) -> np.ndarray:
    """(v,) int64 in-degrees, ascending, summing to `edges` exactly: the
    traffic's law at its solved d_min, floored, and the remainder given one
    each to the largest fractional parts."""
    real = pareto_degrees(v, solve_d_min(v, edges, traffic),
                          float(traffic["max_in_degree"]), float(traffic["tail_index"]))
    deg = np.floor(real).astype(np.int64)
    short = edges - int(deg.sum())
    if not 0 <= short <= v:
        raise ValueError(f"degree law cannot give {edges} edges over {v} vertices")
    deg[np.argsort(real - deg, kind="stable")[v - short:]] += 1
    return np.sort(deg)


@dataclass
class Inputs:
    """Host arrays of one cell's inputs, and the initial weights (f32 CPU
    tensors, the model's parameter names)."""

    num_vertices: int
    src: np.ndarray  # (E,) int32, grouped by dst
    dst: np.ndarray  # (E,) int32, ascending
    features: np.ndarray  # (V, F) float32
    labels: np.ndarray  # (V,) int32
    split_ids: np.ndarray  # (V,) int64, each vertex's original id
    weights: dict


def init_weights(model: str, dims: list, gen: torch.Generator,
                 device: torch.device) -> dict:
    """w{l} (in, out) Xavier-uniform; GAT's a{l} (out, 1) Kaiming-normal,
    as the Dorylus weight server draws them."""
    out = {}
    for l, (fin, fout) in enumerate(zip(dims, dims[1:])):
        s = (6.0 / (fin + fout)) ** 0.5
        out[f"w{l}"] = (torch.rand((fin, fout), generator=gen, device=device) * 2 - 1) * s
        if model == "gat":
            out[f"a{l}"] = torch.randn((fout, 1), generator=gen, device=device) * (2.0 / fout) ** 0.5
    return {k: t.cpu() for k, t in out.items()}


def sources(ids: torch.Tensor, dst: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Each edge's source: every vertex the source of E // V or E // V + 1
    edges (the same out-degrees for every seed, so every seed's transposed
    plans do the same work), dealt to the edges in the seed's random order;
    an edge dealt its own destination swaps sources with a random edge
    until none is."""
    e, v = dst.shape[0], ids.shape[0]
    owners = torch.repeat_interleave(ids, torch.full_like(ids, e // v) + (ids < e % v).int())
    src = owners[torch.randperm(e, generator=gen, device=dst.device)]
    loops = torch.nonzero(src == dst)[:, 0]
    while loops.numel():
        other = torch.randint(0, e, loops.shape, generator=gen, device=dst.device)
        src[loops], src[other] = src[other].clone(), src[loops].clone()
        loops = torch.nonzero(src == dst)[:, 0]
    return src


def make_inputs(config: dict, traffic: dict, seed: int, device: torch.device) -> Inputs:
    """The cell's inputs for `seed`, drawn on `device` and copied to the
    host; nothing of them stays on the device."""
    v = int(config["num_vertices"])
    dims = list(config["dims"])
    deg = degree_sequence(v, int(traffic["edges"]), traffic)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ids = torch.arange(v, device=device, dtype=torch.int32)
    dst = torch.repeat_interleave(ids, torch.from_numpy(deg).to(device))
    src = sources(ids, dst, gen)
    features = torch.randn((v, dims[0]), generator=gen, device=device)
    labels = torch.randint(0, dims[-1], (v,), generator=gen, device=device, dtype=torch.int32)
    split_ids = torch.randperm(v, generator=gen, device=device)
    weights = init_weights(config["model"], dims, gen, device)
    host = [t.cpu().numpy() for t in (src, dst, features, labels, split_ids)]
    del src, dst, features, labels, split_ids
    return Inputs(v, *host, weights=weights)
