"""One process per shard over torch.distributed (port of dorylus_tpu/parallel)."""

from dorylus_tpu_torch.parallel.multihost import init_from_env, spawn_local  # noqa: F401
from dorylus_tpu_torch.parallel.train_step import ShardedEngine  # noqa: F401
