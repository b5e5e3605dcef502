"""Serving of the port: overlap host I/O with the card's work."""

from .throughput import stream_map, stream_map_chunked

__all__ = ["stream_map", "stream_map_chunked"]
