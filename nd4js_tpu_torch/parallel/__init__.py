"""Data parallelism over the batch axis with ``torch.distributed``, the
counterpart of ``nd4js_tpu/parallel``."""
from .mesh import init_group, make_mesh, batch_sharded, shard_batch

__all__ = ["make_mesh", "batch_sharded", "shard_batch", "init_group"]
