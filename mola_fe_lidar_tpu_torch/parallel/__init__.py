"""Batched alignment (the nearby-keyframe and loop-closure batches)."""
