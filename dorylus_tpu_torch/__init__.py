"""dorylus_tpu_torch — the PyTorch/CUDA port of dorylus_tpu for NVIDIA Hopper.

The JAX package `dorylus_tpu` stays the reference; this package mirrors its
layout and names so each module's counterpart is easy to find:

    common/    config, logging, metrics (own copies of the host-side modules)
    graph/     Graph and the synthetic graphs, reordering, the pair miner,
               the vertex partitioner, the dataset files (own copies,
               numpy only)
    native.py  ctypes bindings of native/libgraphcore.so (own copy)
    models/    GraphBatch, GCN and GAT (nn.Modules; weights in the JAX
               (in, out) layout), the reference initializers
    ops/       activations/loss, the hybrid-ELL and degree plan builders
               (numpy), the aggregation ops (HybSpMM, DegreeSpMM, ReuseSpMM,
               EdgeSpMM, ShardedHybSpMM, ShardedDegreeSpMM, ShardedReuseSpMM)
               and their hand-written CUDA kernels (ops/csrc/)
    optim/     Adam with the reference math, SGD, LR decay
    engine/    batch building, the converge monitor, checkpoints, the
               epoch loop both engines share (with bounded staleness) and
               the single-device engine
    parallel/  one process per shard over torch.distributed: launch and
               env init (multihost), the halo exchange (halo) and the
               sharded engine (train_step)
    tools/     probe_prims: the card's primitive rates (shared-memory row
               loads, read-modify-write, per-row cp.async copies, indexed
               shuffles), the counterparts of tools/probe_pallas_prims.py
    interop.py numpy <-> torch carriers for params and Adam state
    cli.py     the command line: train, infer, prepare-data, partition

The port imports torch and never jax, and nothing of `dorylus_tpu`: what it
needs of that package's host-side code it keeps as its own copy, pinned to
the original by tests/test_torch_port_copies.py.
"""

__version__ = "0.1.0"

from dorylus_tpu_torch.common.config import LayerConfig, TrainConfig  # noqa: F401
