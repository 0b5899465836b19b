"""Segment (scatter) ops with static segment counts — the XLA
replacement for torch_scatter / torch_runstats.scatter (reference hot path:
message reduction at e3_layers/nn/message_passing.py:109, pooling at
e3_layers/nn/output.py:69).

All graph batches here are padded to static capacities with one dummy
trailing segment, so every scatter lowers to an XLA segment-sum with
compile-time ``num_segments`` — no dynamic shapes, no host syncs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def segment_sum(data: jnp.ndarray, segment_ids: jnp.ndarray, num_segments: int):
    return jax.ops.segment_sum(
        data, segment_ids, num_segments=num_segments, indices_are_sorted=False
    )


def segment_mean(
    data: jnp.ndarray, segment_ids: jnp.ndarray, num_segments: int, eps: float = 1e-9
):
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_sum(jnp.ones(data.shape[:1], data.dtype), segment_ids, num_segments)
    return total / jnp.maximum(count, eps)[(...,) + (None,) * (data.ndim - 1)]


def scatter(src: jnp.ndarray, index: jnp.ndarray, dim_size: int, reduce: str = "sum"):
    """torch_scatter-style API over the first axis."""
    if reduce == "sum":
        return segment_sum(src, index, dim_size)
    if reduce == "mean":
        return segment_mean(src, index, dim_size)
    raise ValueError(f"unsupported reduce {reduce!r}")
