"""Batched alignment and device meshes (data and tensor parallelism)."""
from .batch import (batched_align, make_batched_align, make_chunked_batched_align,
                    monte_carlo_guesses)
from .distributed import make_dp_tp_align, make_sharded_align
from .mesh import default_mesh, make_mesh, pad_batch, shard_batch

__all__ = [
    "make_mesh", "default_mesh", "shard_batch", "pad_batch",
    "batched_align", "make_batched_align", "make_chunked_batched_align",
    "monte_carlo_guesses",
    "make_sharded_align", "make_dp_tp_align",
]
