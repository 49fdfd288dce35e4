"""Centre-of-mass (zero-CoM subspace) projections, masked and batched.

Replacement for the reference's ``remove_mean`` which loops over
graphs in Python (ref diffusion_x_h.py:5-14). Here graphs live in padded
``[..., N, D]`` tensors with a boolean/float node mask, so the projection is
one masked reduction — no loops, fully vmappable/shardable.
"""

from __future__ import annotations

import jax.numpy as jnp


def masked_mean(x: jnp.ndarray, mask: jnp.ndarray | None, axis: int = -2):
    """Mean of ``x`` over ``axis`` counting only masked-in entries.

    Args:
      x: ``[..., N, D]`` array.
      mask: ``[..., N]`` boolean/float node mask, or None for all-valid.
      axis: node axis (default -2).

    Returns:
      ``[..., 1, D]`` mean over valid nodes (keepdims).
    """
    if mask is None:
        return jnp.mean(x, axis=axis, keepdims=True)
    m = jnp.expand_dims(mask.astype(x.dtype), -1)
    total = jnp.sum(x * m, axis=axis, keepdims=True)
    count = jnp.sum(m, axis=axis, keepdims=True)
    return total / jnp.maximum(count, 1.0)


def remove_mean(x: jnp.ndarray, mask: jnp.ndarray | None = None, axis: int = -2):
    """Project ``x`` onto the zero-CoM subspace per graph.

    Matches the semantics of ref diffusion_x_h.py:5-14 (subtract the per-graph
    mean over nodes) but batched over leading axes and masked: padded nodes
    contribute nothing to the mean and are zeroed in the output so padding
    stays inert downstream.
    """
    centred = x - masked_mean(x, mask, axis=axis)
    if mask is not None:
        centred = centred * jnp.expand_dims(mask.astype(x.dtype), -1)
    return centred
