"""dorylus_tpu_torch — the PyTorch/CUDA port of dorylus_tpu for NVIDIA Hopper.

The JAX package `dorylus_tpu` stays the reference; this package mirrors its
layout and names so each module's counterpart is easy to find:

    models/    GraphBatch, GCN (nn.Module; weights in the JAX (in, out) layout)
    ops/       activations/loss, the hybrid-ELL plan builder (numpy), and
               HybSpMM with its hand-written CUDA kernel (ops/csrc/)
    optim/     Adam with the reference math, SGD, LR decay
    engine/    batch building and the single-device epoch driver
    interop.py numpy <-> torch carriers for params and Adam state

The port imports torch and never jax. Host-side modules of `dorylus_tpu`
whose imports are jax-free are imported as they are (common/config,
common/metrics, common/logging, graph/{graph,reorder,dataio}, native); `models/init.py` and
`engine/convergence.py` are loaded by file path through `_shared.load`,
because their package `__init__`s pull in jax.
"""

__version__ = "0.1.0"

from dorylus_tpu.common.config import LayerConfig, TrainConfig  # noqa: F401
