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

    # Pipeline/async knobs (reference --pipeline / --staleness). The engines
    # are synchronous; bounded staleness is still to port.
    pipeline: bool = True
    staleness: Optional[int] = None

    # Parallelism
    num_shards: int = 1  # vertex shards over the mesh 'graph' axis
    # Feature/tensor parallelism (still to port). 1 = off.
    feat_shards: int = 1
    # Halo/compute overlap ("auto" | True | False): "auto" resolves per
    # kernel in ShardedEngine: hyb gets the FUSED overlap plan
    # (ops/hyb_sharded.py edges="fused": pure buckets gather local rows,
    # mixed buckets the local and the ghost rows); the edgewise path
    # runs the combined plan. Booleans force on/off.
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


def resolve_kernel(kernel: str, num_edges: int) -> str:
    """Resolve kernel="auto": a slot-grid kernel ("hyb") past 8M edges,
    the edgewise path ("xla") below: the JAX package's rule, kept so both
    packages run the same path on the same graph (the switch point is
    still to be re-measured on the H100)."""
    if kernel != "auto":
        return kernel
    if num_edges <= AUTO_KERNEL_EDGES:
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
