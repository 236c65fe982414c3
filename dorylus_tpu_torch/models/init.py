"""(The port's own copy of dorylus_tpu/models/init.py, pinned to the
original by tests/test_torch_port_copies.py.)

Weight initializers with bit-level parity to the reference weight server.

The reference initializes weights with libstdc++'s
std::default_random_engine(8888) (= minstd_rand0) feeding
uniform_real_distribution (xavier, weightserver.cpp:567-585) or
normal_distribution via Marsaglia polar (kaiming, weightserver.cpp:592-612).
We reimplement those exact generators in numpy so accuracy curves are
apples-to-apples with the reference; jax-native initializers are also
provided for general use.
"""

from __future__ import annotations

import numpy as np

_MINSTD_M = 2147483647  # 2^31 - 1
_MINSTD_A = 16807


class MinStd0:
    """libstdc++ std::default_random_engine = minstd_rand0."""

    def __init__(self, seed: int = 8888):
        self.x = seed % _MINSTD_M
        if self.x == 0:
            self.x = 1

    def next(self) -> int:
        self.x = (self.x * _MINSTD_A) % _MINSTD_M
        return self.x

    def canonical(self) -> float:
        # libstdc++ generate_canonical<float>: one draw, range = max-min+1.
        return (self.next() - 1) / float(_MINSTD_M - 1)

    def uniform(self, a: float, b: float) -> float:
        return self.canonical() * (b - a) + a

    def normal_pair(self) -> tuple[float, float]:
        # libstdc++ normal_distribution: Marsaglia polar method.
        while True:
            u = self.uniform(-1.0, 1.0)
            v = self.uniform(-1.0, 1.0)
            s = u * u + v * v
            # libstdc++ rejects s > 1 or s == 0 (accepts s == 1).
            if 0.0 < s <= 1.0:
                break
        if s == 1.0:
            return 0.0, 0.0
        f = np.sqrt(-2.0 * np.log(s) / s)
        return u * f, v * f


def xavier_reference(dim1: int, dim2: int, seed: int = 8888) -> np.ndarray:
    """uniform(-1,1) * sqrt(6/(dim1+dim2)), row-major fill, fresh engine per
    tensor — exactly WeightServer::xavierInitializer (weightserver.cpp:567-585)."""
    rng = MinStd0(seed)
    data = np.empty(dim1 * dim2, dtype=np.float32)
    for i in range(dim1 * dim2):
        data[i] = rng.uniform(-1.0, 1.0)
    data *= np.sqrt(6.0 / (dim1 + dim2))
    return data.reshape(dim1, dim2)


def kaiming_reference(dim1: int, dim2: int, seed: int = 8888) -> np.ndarray:
    """normal(0,1) * sqrt(2/dim1) — WeightServer::kaimingInitializer
    (weightserver.cpp:592-612). normal_distribution caches the second value
    of each polar pair, which we reproduce."""
    rng = MinStd0(seed)
    n = dim1 * dim2
    data = np.empty(n, dtype=np.float32)
    i = 0
    while i < n:
        a, b = rng.normal_pair()
        # libstdc++ returns the *second* polar value first, caching the first.
        data[i] = b
        i += 1
        if i < n:
            data[i] = a
            i += 1
    data *= np.sqrt(2.0 / dim1)
    return data.reshape(dim1, dim2)


def xavier_fast(dim1: int, dim2: int, seed: int = 8888) -> np.ndarray:
    """Numpy-vectorized xavier with the same distribution (not bit-identical);
    used for large dims where the scalar loop is slow."""
    rng = np.random.default_rng(seed)
    scale = np.sqrt(6.0 / (dim1 + dim2))
    return rng.uniform(-scale, scale, size=(dim1, dim2)).astype(np.float32)


def xavier(dim1: int, dim2: int, seed: int = 8888, exact: bool | None = None) -> np.ndarray:
    if exact is None:
        exact = dim1 * dim2 <= 1 << 20
    return xavier_reference(dim1, dim2, seed) if exact else xavier_fast(dim1, dim2, seed)
