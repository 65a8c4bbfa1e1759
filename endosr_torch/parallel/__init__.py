"""Data parallelism and spatial (H) sharding of the port (counterpart of
``endosr.parallel``)."""

from endosr_torch.parallel.mesh import (
    get_mesh,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = ["make_mesh", "get_mesh", "shard_batch", "replicate"]
