"""The yardstick's counts: the operations and bytes the algorithm needs, from
the configuration's widths and the graph's V and E, never from what the
program launches; and the table of peaks they are held against.

Peaks: one NVIDIA H100 SXM, NVIDIA's published dense rates at its 700 W
limit: 67 TFLOP/s float32 outside the tensor cores, 495 TF32, 989 bf16,
3.35 TB/s of HBM. A bound is the larger of operations over the dtype's peak
and bytes over the HBM rate, counting each input byte read once and each
output byte written once.

Per epoch: each layer's aggregation forward, its backward where a gradient
flows through it, each layer's matmul forward, its weight gradient and, past
the first layer, its input gradient; and the eval forward. A `run(k)` call
of the engine adds two more eval forwards after its epochs, the final
validation and test accuracies (`window_ops`).
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "tf32": 4, "bfloat16": 2}
INDEX_BYTES = 4  # int32 indices and row offsets


@dataclass(frozen=True)
class Op:
    name: str
    kind: str  # "aggregate" or "matmul"
    flops: float
    bytes: float
    dtype: str = "float32"

    def bound_s(self) -> float:
        return max(self.flops / PEAK_FLOPS[self.dtype], self.bytes / PEAK_BYTES_PER_S)


def aggregation(name: str, edges: int, v_src: int, v_out: int, width: int,
                table_dtype: str, val_dtype: str | None) -> Op:
    """out[v] = sum over v's in-edges of (val *) table[u]: per edge one
    index (and one value, where weighted), the table's rows and the row
    offsets once, a float32 output row per vertex; a multiply-add per edge
    and feature where weighted, an add where not."""
    weighted = val_dtype is not None
    nbytes = (edges * INDEX_BYTES + (edges * ITEMSIZE[val_dtype] if weighted else 0)
              + (v_out + 1) * INDEX_BYTES + v_src * width * ITEMSIZE[table_dtype]
              + v_out * width * 4)
    return Op(name, "aggregate", (2 if weighted else 1) * edges * width, nbytes)


def matmul(name: str, m: int, k: int, n: int, dtype: str = "float32") -> Op:
    """(m, k) @ (k, n)."""
    return Op(name, "matmul", 2.0 * m * k * n, (m * k + k * n + m * n) * ITEMSIZE[dtype], dtype)


def agg_width(config: dict, fin: int, fout: int) -> int:
    """The width a layer aggregates at: GAT its output; GCN the narrower,
    transforming first where the layer shrinks."""
    if config["model"] == "gat":
        return fout
    return fout if config.get("optimize_order", True) and fin > fout else fin


def _agg(config: dict, edges: int, name: str, width: int) -> Op:
    v = int(config["num_vertices"])
    val = None if config["model"] == "gat" else config["agg_dtype"]
    return aggregation(name, edges, v, v, width, config["agg_dtype"], val)


def forward_ops(config: dict, edges: int, tag: str = "fwd") -> list[Op]:
    v, dims = int(config["num_vertices"]), config["dims"]
    ops = []
    for l, (fin, fout) in enumerate(zip(dims, dims[1:])):
        ops.append(_agg(config, edges, f"{tag}.agg{l}", agg_width(config, fin, fout)))
        ops.append(matmul(f"{tag}.mm{l}", v, fin, fout))
    return ops


def backward_ops(config: dict, edges: int) -> list[Op]:
    v, dims = int(config["num_vertices"]), config["dims"]
    ops = []
    for l, (fin, fout) in enumerate(zip(dims, dims[1:])):
        width = agg_width(config, fin, fout)
        # an aggregation of the layer's input itself (GCN, widening first
        # layer) has no gradient to pass back
        if config["model"] == "gat" or width == fout or l > 0:
            ops.append(_agg(config, edges, f"bwd.agg{l}", width))
        ops.append(matmul(f"bwd.dw{l}", fin, v, fout))
        if l > 0:
            ops.append(matmul(f"bwd.dh{l}", v, fout, fin))
    return ops


def evals_per_run(k: int, every: int) -> int:
    """Epochs of a run(k) that evaluate: every `every`-th and the last."""
    if not every:
        return 0
    return sum(1 for ep in range(k) if ep % every == 0 or ep == k - 1)


def window_ops(config: dict, traffic: dict, epochs: int, runs: int) -> list[tuple[Op, int]]:
    """(op, count) over a window of `runs` run(k) calls, `epochs` in all:
    each epoch's forward and backward, its evals, and each run's two final
    eval forwards."""
    edges, k = int(traffic["edges"]), int(traffic["epochs_per_run"])
    evals = runs * (evals_per_run(k, int(traffic["eval_every"])) + 2)
    train = forward_ops(config, edges) + backward_ops(config, edges)
    return [(op, epochs) for op in train] + [(op, evals) for op in forward_ops(config, edges, "eval")]


def bound_s(counted: list[tuple[Op, int]], kind: str | None = None) -> float:
    """The least seconds the chip could take over the counted ops (of one
    kind, or all)."""
    return sum(op.bound_s() * n for op, n in counted if kind is None or op.kind == kind)
