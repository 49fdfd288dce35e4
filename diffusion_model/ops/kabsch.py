"""Batched Kabsch alignment and RMSD on device.

Replacement for the reference's ``kabsch_torch``/``kabsch_numpy``
(ref evaluate_rmsd_for_pos_generate.py:11-92): optimal rotation + translation
between two point sets with the right-handed determinant fix, computed with
``jnp.linalg.svd`` so it batches/vmaps and runs on device. Supports padded
point sets via a node mask.
"""

from __future__ import annotations

import jax.numpy as jnp

from diffusion_model.ops.com import masked_mean


def kabsch(p: jnp.ndarray, q: jnp.ndarray, mask: jnp.ndarray | None = None):
    """Optimal rigid alignment of ``p`` onto ``q``.

    Args:
      p, q: ``[..., N, 3]`` point sets.
      mask: optional ``[..., N]`` validity mask.

    Returns:
      (rotation ``[..., 3, 3]``, translation ``[..., 1, 3]``, aligned_p):
      ``aligned_p = p_centred @ R^T + q_mean`` minimises ||aligned_p - q||.
    """
    p_mean = masked_mean(p, mask)
    q_mean = masked_mean(q, mask)
    p_c = p - p_mean
    q_c = q - q_mean
    if mask is not None:
        m = jnp.expand_dims(mask.astype(p.dtype), -1)
        p_c = p_c * m
        q_c = q_c * m

    # Covariance H = P^T Q, SVD, det-sign fix for a proper rotation.
    h = jnp.swapaxes(p_c, -1, -2) @ q_c
    u, _, vt = jnp.linalg.svd(h, full_matrices=False)
    v = jnp.swapaxes(vt, -1, -2)
    ut = jnp.swapaxes(u, -1, -2)
    d = jnp.sign(jnp.linalg.det(v @ ut))
    # Flip the last singular direction where the determinant is negative.
    flip = jnp.stack(
        [jnp.ones_like(d), jnp.ones_like(d), d], axis=-1
    )[..., None, :]
    r = (v * flip) @ ut
    aligned = p_c @ jnp.swapaxes(r, -1, -2) + q_mean
    return r, q_mean, aligned


def kabsch_rmsd(p: jnp.ndarray, q: jnp.ndarray, mask: jnp.ndarray | None = None):
    """RMSD between ``p`` and ``q`` after optimal rigid alignment.

    Matches ref evaluate_rmsd_for_pos_generate.py:41-51 (sqrt of mean squared
    residual over points); masked variant averages over valid points only.
    """
    _, _, aligned = kabsch(p, q, mask)
    sq = jnp.sum((aligned - q) ** 2, axis=-1)
    if mask is not None:
        m = mask.astype(p.dtype)
        return jnp.sqrt(jnp.sum(sq * m, axis=-1) / jnp.maximum(jnp.sum(m, axis=-1), 1.0))
    return jnp.sqrt(jnp.mean(sq, axis=-1))
