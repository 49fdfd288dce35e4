"""RDF comparison evaluator (original vs generated structure lists).

Rebuild of evaluate_RDF.py: the RDF itself runs on device, vmapped over the
structure batch (ref evaluate_RDF.py:48-60 -> ops.rdf); the four similarity
metrics (cosine, euclidean, MSE, Wasserstein; ref :13-37,62-83) are computed
per pair, Wasserstein on host via scipy like the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from scipy.stats import wasserstein_distance

from diffusion_model.ops.rdf import rdf_from_exo


def rdf_metrics(rdf_a: np.ndarray, rdf_b: np.ndarray) -> dict:
    a = np.asarray(rdf_a, np.float64)
    b = np.asarray(rdf_b, np.float64)
    # guard the cosine for all-zero curves (structure with no atoms inside
    # r_max of exO) — the reference's cos_similarity would return NaN there
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return {
        "cos": float(np.dot(a, b) / denom) if denom > 0 else 0.0,
        "euclidean": float(np.linalg.norm(a - b)),
        "mse": float(np.mean((a - b) ** 2)),
        "wasserstein": float(wasserstein_distance(a, b)),
    }


def evaluate_rdf_lists(original_pos, original_mask, generated_pos,
                       generated_mask, sigma: float = 5.0, r_max: float = 5.0,
                       dr: float = 0.01) -> list:
    """Batched RDF comparison.

    Args:
      original_pos / generated_pos: ``[G, N, 3]`` padded position stacks.
      original_mask / generated_mask: ``[G, N]`` masks.

    Returns:
      list of per-pair metric dicts (plus the curves), mirroring the
      reference's per-graph similarity lists (ref evaluate_RDF.py:85-124).
    """
    rdf_fn = jax.jit(
        jax.vmap(
            lambda p, m: rdf_from_exo(p, m, sigma=sigma, r_max=r_max, dr=dr)
        )
    )
    rdf_orig = np.asarray(rdf_fn(jnp.asarray(original_pos),
                                 jnp.asarray(original_mask)))
    rdf_gen = np.asarray(rdf_fn(jnp.asarray(generated_pos),
                                jnp.asarray(generated_mask)))
    out = []
    for i in range(rdf_orig.shape[0]):
        m = rdf_metrics(rdf_orig[i], rdf_gen[i])
        m["rdf_original"] = rdf_orig[i]
        m["rdf_generated"] = rdf_gen[i]
        out.append(m)
    return out
