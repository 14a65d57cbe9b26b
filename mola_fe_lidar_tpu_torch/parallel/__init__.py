"""Batched alignment (the nearby-keyframe and loop-closure batches)."""
from .batch import (batched_align, make_batched_align, make_chunked_batched_align,
                    monte_carlo_guesses)

__all__ = ["batched_align", "make_batched_align", "make_chunked_batched_align",
           "monte_carlo_guesses"]
