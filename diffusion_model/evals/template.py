"""Template matching: spectrum-MSE nearest references scored by a local
structural descriptor.

Rebuild of template_matching.py (ref template_matching.py:26-70): for each
target, find the best-3 reference structures by spectrum MSE, then score
structural similarity by cosine similarity of a rotation-invariant local
descriptor of the exO environment.

Two descriptors are available:
  * ``descriptor="soap"`` — a native implementation of the SOAP power
    spectrum itself (evals/soap.py) with the reference's settings
    (ref template_matching.py:41: r_cut=8, n_max=15, l_max=10, sigma=0.1),
    so similarity scores are comparable to the reference's dscribe output.
  * ``descriptor="histogram"`` — a cheaper rotation-invariant analogue
    computed on device: per species-pair Gaussian-smeared radial
    distribution concatenated with a bond-angle histogram at exO.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def local_descriptor(pos: jnp.ndarray, species: jnp.ndarray,
                     mask: jnp.ndarray | None = None, r_cut: float = 8.0,
                     n_radial: int = 32, n_angular: int = 18,
                     sigma: float = 0.3) -> jnp.ndarray:
    """Rotation-invariant descriptor of the node-0 (exO) environment.

    Args:
      pos: ``[N, 3]``; species: ``[N, 2]`` one-hot (O, Si); mask: ``[N]``.

    Returns:
      ``[2 * n_radial + n_angular]`` vector: radial Gaussian-smeared
      densities per neighbour species, plus the angle histogram over
      neighbour pairs within 2.5 A.
    """
    n = pos.shape[0]
    m = jnp.ones((n,)) if mask is None else mask.astype(jnp.float32)
    rel = pos[1:] - pos[0]
    d = jnp.linalg.norm(rel, axis=-1)
    valid = m[1:] * m[0] * (d < r_cut)

    centers = jnp.linspace(0.0, r_cut, n_radial)
    # [N-1, n_radial] Gaussian smears, weighted by species channel
    g = jnp.exp(-0.5 * ((d[:, None] - centers[None, :]) / sigma) ** 2)
    g = g * valid[:, None]
    rad_o = jnp.sum(g * species[1:, 0:1], axis=0)
    rad_si = jnp.sum(g * species[1:, 1:2], axis=0)

    # angle histogram over near-neighbour pairs at exO
    near = valid * (d < 2.5)
    unit = rel / jnp.maximum(d[:, None], 1e-9)
    cosang = unit @ unit.T
    pair_w = near[:, None] * near[None, :]
    pair_w = pair_w * (1.0 - jnp.eye(rel.shape[0]))
    ang = jnp.degrees(jnp.arccos(jnp.clip(cosang, -1.0, 1.0)))
    edges_lo = jnp.linspace(0.0, 180.0, n_angular + 1)[:-1]
    width = 180.0 / n_angular
    in_bin = ((ang[..., None] >= edges_lo) &
              (ang[..., None] < edges_lo + width))
    hist = jnp.sum(in_bin * pair_w[..., None], axis=(0, 1))

    return jnp.concatenate([rad_o, rad_si, hist])


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def template_match(target_graphs: list, reference_graphs: list,
                   best_k: int = 3, descriptor: str = "histogram") -> dict:
    """For each target graph dict, the best-k reference matches by spectrum
    MSE, each scored with descriptor cosine similarity
    (ref template_matching.py:42-68; self-matches by id excluded).

    ``descriptor``: "histogram" (fast on-device analogue) or "soap" (the
    reference's actual SOAP power spectrum, evals/soap.py).

    Returns {target_id: [{ref_id: [mse, similarity]}, ...]}.
    """
    if descriptor == "soap":
        from diffusion_model.evals.soap import soap_descriptor

        def desc_fn(pos, species):
            return soap_descriptor(np.asarray(pos), np.asarray(species))
    elif descriptor == "histogram":
        _jit = jax.jit(local_descriptor, static_argnames=())

        def desc_fn(pos, species):
            return _jit(jnp.asarray(pos), jnp.asarray(species))
    else:
        raise ValueError(f"unknown descriptor: {descriptor!r}")
    ref_desc = {
        g["id"]: np.asarray(desc_fn(g["pos"], g["species"]))
        for g in reference_graphs
    }
    results: dict = {}
    for tg in target_graphs:
        t_spec = np.asarray(tg["spectrum"][0])
        t_desc = np.asarray(desc_fn(tg["pos"], tg["species"]))
        scored = []
        for rg in reference_graphs:
            if rg["id"] == tg["id"]:
                continue
            mse = float(np.mean((t_spec - np.asarray(rg["spectrum"][0])) ** 2))
            scored.append((mse, rg["id"]))
        scored.sort(key=lambda x: x[0])
        best = []
        for mse, rid in scored[:best_k]:
            best.append({rid: [mse, _cos(t_desc, ref_desc[rid])]})
        results[tg["id"]] = best
    return results
