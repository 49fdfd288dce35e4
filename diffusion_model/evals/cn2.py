"""CN2 (two-coordinated oxygen) angle / bond-length evaluation.

Rebuild of CN2_evaluate.py and evaluate_Si-O-Si.py:
  * Si-exO-Si angles and bond lengths on device (ops.angles),
  * per-condition group means over ``gen_num_per_spectrum`` samples
    (ref CN2_evaluate.py:190-198),
  * the hand-rolled linear-regression r2score (ref CN2_evaluate.py:23-37),
  * the amorphous Si-O-Si filter: keep graphs whose exO has exactly two Si
    neighbours within 2 A (ref evaluate_Si-O-Si.py:23-41).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from diffusion_model.ops.angles import cn2_angle_deg, cn2_bond_lengths


def cn2_statistics(pos) -> dict:
    """Angles/bond lengths for a ``[G, >=3, 3]`` stack of CN2 graphs
    (node 0 = exO, nodes 1..2 = the two Si)."""
    pos = jnp.asarray(pos)
    angles = np.asarray(jax.jit(cn2_angle_deg)(pos))
    l1, l2 = jax.jit(cn2_bond_lengths)(pos)
    return {
        "angle_deg": angles,
        "bond1": np.asarray(l1),
        "bond2": np.asarray(l2),
    }


def per_graph_group_means(values: np.ndarray, group: int) -> np.ndarray:
    """Mean over consecutive groups of ``group`` samples (the reference's
    5-samples-per-condition averaging, ref CN2_evaluate.py:190-198); NaN
    groups dropped like the reference."""
    values = np.asarray(values, np.float64)
    n = (len(values) // group) * group
    means = values[:n].reshape(-1, group).mean(axis=1)
    return means[~np.isnan(means)]


def aligned_group_means(a, b, group: int, invalid=None):
    """Per-condition group means of two paired per-sample arrays, with
    symmetric invalidation so both outputs stay aligned.

    Any sample where either array is non-finite (or ``invalid`` is True)
    is NaN-filled in BOTH arrays before ``per_graph_group_means`` — its
    group then drops from both outputs identically, preserving the pairing
    that per-array NaN-dropping would break.
    """
    a = np.asarray(a, np.float64).copy()
    b = np.asarray(b, np.float64).copy()
    bad = ~np.isfinite(a) | ~np.isfinite(b)
    if invalid is not None:
        bad |= np.asarray(invalid, bool)
    a[bad] = np.nan
    b[bad] = np.nan
    ga = per_graph_group_means(a, group)
    gb = per_graph_group_means(b, group)
    n = min(len(ga), len(gb))
    return ga[:n], gb[:n]


def r2score(a, b) -> float:
    """The reference's hand-rolled regression R^2 (ref CN2_evaluate.py:23-37):
    fit y = slope*x + intercept by least squares, score residuals against
    the variance of y."""
    x = np.asarray(a, np.float64)
    y = np.asarray(b, np.float64)
    n = len(x)
    if n == 0:
        # empty input (e.g. a run with no valid CN2 conditions): the score
        # is undefined — return NaN explicitly instead of warning on 0/0
        return float("nan")
    mean_x = x.sum() / n
    t_xx = np.sum((x - mean_x) ** 2)
    t_yy = np.sum((y - y.sum() / n) ** 2)
    if t_xx == 0.0 or t_yy == 0.0:
        # degenerate (constant) inputs: slope / variance ratio undefined
        return float("nan")
    t_xy = np.sum((x - mean_x) * (y - y.sum() / n))
    slope = t_xy / t_xx
    intercept = y.sum() / n - slope * x.sum() / n
    resid = y - (intercept + slope * x)
    return float(1 - np.sum(resid**2) / t_yy)


def _cn2_sample_geometry(results: dict):
    """Per-sample CN2 geometry, shell-agnostic: original angle/bonds from
    rows 1,2 (data/synthetic.py make_graph puts the Si there on 1- AND
    2-shell data), generated angle/bonds from the two Si located by
    species argmax over the real rows. A sample that is not a CN2
    condition (3 or 5 real atoms), is rejected, or whose generated
    composition is not exactly two non-exO Si is marked invalid. Round
    2's fixed-row readout silently measured exO-Si-O geometry on 2-shell
    data (the 0.67 "flagship angle gap" artifact); ref
    CN2_evaluate.py:176-286 for the metric itself.

    Returns dict of per-sample arrays: angle_o/angle_g [deg],
    bond1_o/bond2_o/bond1_g/bond2_g [A], invalid [bool].
    """
    mask = np.asarray(results["mask"])
    accepted = np.asarray(results["accepted"]).astype(bool)
    gen_pos = np.asarray(results["generated_pos"])
    gen_species = np.asarray(results["generated_species"])
    orig_pos = np.asarray(results["original_pos"])
    n_real = mask.sum(-1).astype(int)

    def angle(center, a, b):
        u, v = a - center, b - center
        c = np.dot(u, v) / max(np.linalg.norm(u) * np.linalg.norm(v),
                               1e-12)
        return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))

    n = len(mask)
    out = {k: np.full(n, np.nan) for k in
           ("angle_o", "angle_g", "bond1_o", "bond2_o", "bond1_g",
            "bond2_g")}
    invalid = np.ones(n, bool)
    for i in range(n):
        if n_real[i] not in (3, 5) or not accepted[i]:
            continue
        k = n_real[i]
        out["angle_o"][i] = angle(orig_pos[i, 0], orig_pos[i, 1],
                                  orig_pos[i, 2])
        out["bond1_o"][i] = np.linalg.norm(orig_pos[i, 1] - orig_pos[i, 0])
        out["bond2_o"][i] = np.linalg.norm(orig_pos[i, 2] - orig_pos[i, 0])
        sp = gen_species[i, :k].argmax(-1)  # 0=O, 1=Si
        si_rows = np.nonzero(sp == 1)[0]
        if len(si_rows) != 2 or 0 in si_rows:
            continue
        out["angle_g"][i] = angle(gen_pos[i, 0], gen_pos[i, si_rows[0]],
                                  gen_pos[i, si_rows[1]])
        out["bond1_g"][i] = np.linalg.norm(
            gen_pos[i, si_rows[0]] - gen_pos[i, 0])
        out["bond2_g"][i] = np.linalg.norm(
            gen_pos[i, si_rows[1]] - gen_pos[i, 0])
        invalid[i] = False
    out["invalid"] = invalid
    return out


def conditional_angle_parity(results: dict, group: int, geo: dict = None):
    """Aligned per-condition group means of (original, generated)
    Si-exO-Si angles for the CN2 conditions of an ``api.generate`` result
    (see ``_cn2_sample_geometry`` for the shell-agnostic readout).
    Pass a precomputed ``geo`` to share the per-sample extraction with
    other readouts (it is the dominant cost on large result sets)."""
    if geo is None:
        geo = _cn2_sample_geometry(results)
    return aligned_group_means(geo["angle_o"], geo["angle_g"], group,
                               invalid=geo["invalid"])


def conditional_bond_parity(results: dict, group: int, geo: dict = None):
    """Aligned per-condition group means of the two Si-exO bond lengths
    (both bonds concatenated, reference style ref CN2_evaluate.py)."""
    if geo is None:
        geo = _cn2_sample_geometry(results)
    bonds_o = np.concatenate([geo["bond1_o"], geo["bond2_o"]])
    bonds_g = np.concatenate([geo["bond1_g"], geo["bond2_g"]])
    invalid = np.concatenate([geo["invalid"], geo["invalid"]])
    return aligned_group_means(bonds_o, bonds_g, group, invalid=invalid)


def filter_si_o_si(pos: np.ndarray, species: np.ndarray, mask: np.ndarray,
                   cutoff: float = 2.0):
    """Indices of graphs whose exO (node 0) has exactly two Si neighbours
    within ``cutoff`` (ref evaluate_Si-O-Si.py:23-41), plus the [G,3,3]
    stack (exO + its two Si) for cn2_statistics."""
    keep, triplets = [], []
    for g in range(pos.shape[0]):
        m = mask[g] > 0
        p = pos[g][m]
        sp = species[g][m]
        d = np.linalg.norm(p[1:] - p[0], axis=-1)
        is_si = sp[1:, 1] > 0.5
        near_si = np.nonzero((d < cutoff) & is_si)[0] + 1
        if len(near_si) == 2:
            keep.append(g)
            triplets.append(np.stack([p[0], p[near_si[0]], p[near_si[1]]]))
    if not triplets:
        return [], np.zeros((0, 3, 3), np.float32)
    return keep, np.stack(triplets).astype(np.float32)
