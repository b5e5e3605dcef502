"""Parallelism of the port: batch data parallelism over devices, and
serving that overlaps host I/O with the card's work."""

from .mesh import batch_sharding, device_put_batch, make_mesh, shard_batch
from .throughput import chunk_batch, stream_map, stream_map_chunked, vmap_pairs

__all__ = ["make_mesh", "batch_sharding", "shard_batch", "device_put_batch",
           "stream_map", "stream_map_chunked", "vmap_pairs", "chunk_batch"]
