"""Configuration dataclasses (the port's own copy of
dorylus_tpu/common/config.py: the same fields, defaults and `resolve_kernel`,
pinned by tests/test_torch_port_copies.py; the comments speak for the port).

Mirrors the reference's flag surface: the graph server's ~25 boost
program_options flags (reference: src/graph-server/engine/utils.cpp:313-452),
the weight server's positional argv (src/weight-server/main.cpp:9-43), and the
per-dataset layer-dim config files (run/*.config, e.g. reddit = 602 128 41).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

# Train/val/test split by global vertex index, identical to the reference
# (src/common/utils.hpp:60-62).
TRAIN_PORTION = 0.66
VAL_PORTION = 0.10
TEST_PORTION = 0.24


@dataclass
class LayerConfig:
    """Layer dimensions, one entry per tensor dim along the network.

    Equivalent to the reference's `<dataset>.config` files read by
    readLayerConfigFile (engine/utils.cpp:460): e.g. reddit.config is
    [602, 128, 41] = features -> hidden -> classes for a 2-layer model.
    """

    dims: List[int]

    @property
    def num_layers(self) -> int:
        return len(self.dims) - 1

    @property
    def feature_dim(self) -> int:
        return self.dims[0]

    @property
    def num_classes(self) -> int:
        return self.dims[-1]

    @classmethod
    def from_file(cls, path: str | Path) -> "LayerConfig":
        dims = [int(line) for line in Path(path).read_text().split() if line.strip()]
        return cls(dims=dims)

    # Reference dataset configs (run/*.config).
    PRESETS = {
        "cora": [1433, 16, 7],
        "reddit": [602, 128, 41],
        "amazon": [300, 64, 25],
        "reddit-large": [301, 128, 50],
        "friendster": [32, 48, 51],
    }

    @classmethod
    def preset(cls, name: str) -> "LayerConfig":
        return cls(dims=list(cls.PRESETS[name]))


@dataclass
class TrainConfig:
    """Training hyperparameters + run control.

    Defaults follow the reference run scripts (run/run-onnode:226 lr=0.01,
    benchmarks/run-reddit-gcn epochs; AdamOptimizer.hpp β/ε).
    """

    model: str = "gcn"  # "gcn" | "gat"
    epochs: int = 100
    learning_rate: float = 0.01
    # LR decay hook (weightserver.cpp:296-305: x0.7 each 20 epochs,
    # disabled by default — same default here: 0 = off).
    lr_decay_every: int = 0
    lr_decay_factor: float = 0.7
    adam: bool = True
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-7  # reference AdamOptimizer.hpp:22 EPSILON
    weight_decay: float = 0.0

    # Early stopping against a target accuracy, mirroring the weight server's
    # converge state machine (weightserver.cpp:270-294).
    target_accuracy: Optional[float] = None
    # Accuracy threshold ratio at which the async engine switches to sync in
    # the reference (weightserver.hpp switch_threshold); kept as config.
    switch_threshold: float = 0.9

    # Evaluate every N epochs (reference evaluates when eval flag set per chunk).
    eval_every: int = 1

    # Pipeline/async knobs (reference --pipeline / --staleness). staleness
    # S > 0 takes each epoch's gradients at weights up to S epochs old (both
    # engines, engine/engine.py StaleWindow); None or 0 is synchronous.
    pipeline: bool = True
    staleness: Optional[int] = None

    # Parallelism
    num_shards: int = 1  # vertex shards over the mesh 'graph' axis
    # Feature/tensor parallelism (still to port). 1 = off.
    feat_shards: int = 1
    # Halo/compute overlap ("auto" | True | False): "auto" resolves per
    # kernel in ShardedEngine from the card's table
    # (parallel/train_step.py AUTO_OVERLAP): hyb the FUSED overlap plan
    # (ops/hyb_sharded.py edges="fused": pure buckets gather local rows,
    # mixed buckets the local and the ghost rows), degree the (interior,
    # boundary) pair, xla the edgewise split. Booleans force on/off.
    overlap: object = "auto"
    # Halo wire format ("auto" | "padded" | "ragged"): padded ships max_h
    # rows per (shard, peer) pair; ragged ships each pair's EXACT count
    # (all_to_all_single with per-pair split sizes), the reference's exact
    # per-destination scatter (gcn_ops.cpp:204-260), into the same padded
    # ghost layout. auto = ragged. See parallel/halo.py.
    halo: str = "auto"

    # Epochs per compiled call of the JAX engines; the port runs one epoch
    # per Python iteration and ignores it.
    epochs_per_call: int = 0

    # Numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # flip to bfloat16 for speed at scale
    # Gather aggregation tables in bfloat16 (f32 accumulation): half the
    # gathered bytes; relative error ~1e-3 on the aggregated output.
    agg_dtype: str = "float32"  # "float32" | "bfloat16"

    # Aggregation kernel knobs
    kernel: str = "auto"  # "auto" (hyb past 8M edges, else xla)
    #                       | "xla" (the edgewise CSR kernels)
    #                       | "degree" (degree-padded blocks, ops/degree_spmm)
    #                       | "hyb" (hybrid ELL + chunked top, ops/hyb_spmm)
    edge_chunk: int = 0  # SpMM edge-chunk size; 0 = unchunked
    optimize_order: bool = True  # transform-before-aggregate when it shrinks F
    # Pair reuse ("auto" | "off" | "pairs"): mine common neighbor pairs
    # into appended gather-table rows (graph/reuse.py), an EXACT rewrite
    # for both models (GCN rank-1 norms, GAT dst-only attention). "pairs"
    # forces it; the port's "auto" resolves to off. hyb kernel only.
    reuse: str = "auto"
    reuse_passes: int = 1  # hierarchy depth (pairs-of-pairs beyond 1)
    # Pair budget per mining pass: -1 = auto (when the BASE table sits
    # below the gather cliff, cap pairs so appended rows cannot push it
    # over — the measured Reddit-scale failure mode; unlimited when the
    # table is already past the cliff, the regime where reuse wins),
    # 0 = unlimited, >0 = explicit cap (mine_reuse keeps the
    # highest-count pairs).
    reuse_max_pairs: int = -1

    # The JAX package's XLA compile cache; kept for field parity, unused.
    compile_cache: Optional[str] = None

    # Checkpointing (an improvement over the reference, which has none).
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # 0 = disabled
    resume: bool = False

    seed: int = 8888  # reference weightserver.cpp:572 fixed RNG seed

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TrainConfig":
        return cls(**json.loads(text))


AUTO_KERNEL_EDGES = 1 << 23  # 8M


def resolve_kernel(kernel: str, num_edges: int, threshold: int = AUTO_KERNEL_EDGES) -> str:
    """Resolve kernel="auto": a slot-grid kernel ("hyb") past `threshold`
    edges, the edgewise path ("xla") at and below it (per shard in
    ShardedEngine).

    The threshold is JAX's 8M, kept by the card's readings
    (tools/switch_points.py, two runs pooled, NVIDIA H100 80GB HBM3, 700.00
    W; the defaults: f32 gather, Reddit's widths 602-128-41). hyb's warm
    epoch beats xla's by more than the spread for both models from 7.9M
    edges up (Reddit, 11.6M: GCN 7.220 against 8.008 ms, GAT 7.564 against
    9.117; 27M: 28.24 / 29.23, 29.93 / 32.59), so nothing moves the switch
    up. Below 8M hyb never wins both the epoch and the run: at 4M and under
    GAT's epochs tie (5.190 / 5.217 ms at 4M), and at 7.9M, where hyb wins
    (GCN 6.129 / 6.552 ms), its plans cost 1.46 s more set-up (3.41 against
    1.95 s), so a default run of 100 epochs ends later on hyb (4.04 against
    2.63 s). So nothing moves it down."""
    if kernel != "auto":
        return kernel
    if num_edges <= threshold:
        return "xla"
    return "hyb"


@dataclass
class RunConfig:
    """Top-level run descriptor: dataset + model + training."""

    dataset: str = "cora"
    data_dir: Optional[str] = None
    layers: LayerConfig = field(default_factory=lambda: LayerConfig.preset("cora"))
    train: TrainConfig = field(default_factory=TrainConfig)
    output_file: Optional[str] = None  # mirrors tmpdir/output_<node>
