"""Edge/topology construction for padded fixed-shape graphs.

The reference builds fully-connected ``edge_index`` lists with O(N^2) Python
loops (ref parts/train_per_iretation.py:308-313, make_dataset.py:131-136).
Here we never materialise an edge list: small/medium graphs use a dense
``[N, N]`` pair mask consumed by dense masked message passing; large cells
use fixed-degree K-nearest-neighbour index tensors (static shapes, masked).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from diffusion_model.ops.angles import pairwise_sq_dist


def dense_pair_mask(node_mask: jnp.ndarray) -> jnp.ndarray:
    """``[..., N, N]`` mask: both endpoints valid and i != j.

    This is the dense encoding of the reference's fully-connected edge set
    over real atoms (all ordered pairs i != j).
    """
    m = node_mask.astype(jnp.float32)
    pair = m[..., :, None] * m[..., None, :]
    n = node_mask.shape[-1]
    eye = jnp.eye(n, dtype=pair.dtype)
    return pair * (1.0 - eye)


def knn_edges(pos: jnp.ndarray, node_mask: jnp.ndarray, k: int):
    """Fixed-degree neighbour lists for large cells.

    Args:
      pos: ``[..., N, 3]`` positions.
      node_mask: ``[..., N]`` validity mask.
      k: neighbours per node (static).

    Returns:
      (idx ``[..., N, K]`` int32 neighbour indices,
       mask ``[..., N, K]`` float32 edge validity). Self and padded nodes are
      excluded; nodes with fewer than K valid neighbours get masked slots.
    """
    n = pos.shape[-2]
    d2 = pairwise_sq_dist(pos)
    m = node_mask.astype(jnp.float32)
    pair_ok = m[..., :, None] * m[..., None, :]
    eye = jnp.eye(n, dtype=jnp.float32)
    invalid = (1.0 - pair_ok) + eye
    big = jnp.asarray(jnp.finfo(d2.dtype).max, d2.dtype)
    d2_masked = jnp.where(invalid > 0, big, d2)
    # top-k smallest distances
    neg = -d2_masked
    _, idx = jax.lax.top_k(neg, k)
    gathered_invalid = jnp.take_along_axis(invalid, idx, axis=-1)
    edge_mask = (gathered_invalid == 0).astype(jnp.float32)
    edge_mask = edge_mask * m[..., :, None]
    return idx.astype(jnp.int32), edge_mask
