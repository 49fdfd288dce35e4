"""RMSD-based structure evaluation.

Covers the reference's three RMSD flavours:
  * batched Kabsch RMSD with sorting (ref parts/def_for_main.py:73-90) —
    on device, one vmapped SVD over the whole structure set;
  * RMSD + O-density atom-type evaluation (ref parts/def_for_main.py:92-117);
  * permutation-exhaustive minimum RMSD for small graphs
    (ref evaluate_rmsd.py:97-107, <=10 atoms, exO fixed at index 0);
  * Hungarian+Kabsch alignment for larger graphs: Kabsch on the 5 nearest
    atoms to exO, then global assignment (ref create_xyz.py:82-196).
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
from scipy.optimize import linear_sum_assignment

from diffusion_model.ops.kabsch import kabsch, kabsch_rmsd


def evaluate_by_rmsd(original_pos, generated_pos, mask, ids=None) -> list:
    """Sorted [(id, rmsd), ...] over the structure set, ascending
    (ref parts/def_for_main.py:73-90)."""
    rmsd = np.asarray(
        jax.jit(kabsch_rmsd)(
            jnp.asarray(generated_pos), jnp.asarray(original_pos),
            jnp.asarray(mask),
        )
    )
    ids = ids if ids is not None else list(range(len(rmsd)))
    pairs = sorted(zip(ids, rmsd.tolist()), key=lambda x: x[1])
    return pairs


def evaluate_by_rmsd_and_atom_type(original_pos, original_species,
                                   generated_pos, generated_species,
                                   mask, ids=None) -> list:
    """Sorted [(id, rmsd, (o_density_orig, o_density_gen)), ...]
    (ref parts/def_for_main.py:92-117; O = onehot [1,0])."""
    rmsd = np.asarray(
        jax.jit(kabsch_rmsd)(
            jnp.asarray(generated_pos), jnp.asarray(original_pos),
            jnp.asarray(mask),
        )
    )
    m = np.asarray(mask)
    o_orig = (np.asarray(original_species)[..., 0] * m).sum(-1) / m.sum(-1)
    o_gen = (np.asarray(generated_species)[..., 0] * m).sum(-1) / m.sum(-1)
    ids = ids if ids is not None else list(range(len(rmsd)))
    rows = list(zip(ids, rmsd.tolist(), zip(o_orig.tolist(), o_gen.tolist())))
    return sorted(rows, key=lambda x: x[1])


def permutation_min_rmsd(original_pos: np.ndarray,
                         generated_pos: np.ndarray,
                         max_atoms: int = 10):
    """Minimum RMSD over all (N-1)! permutations of the non-exO atoms,
    positions re-expressed relative to atom 0 (ref evaluate_rmsd.py:93-107).

    Returns (min_rmsd, best_order, aligned_generated_pos) or None when the
    graph exceeds ``max_atoms`` (the reference skips those, ref :85).
    """
    n = original_pos.shape[0]
    if n > max_atoms:
        return None
    o = np.asarray(original_pos) - np.asarray(original_pos)[0]
    g = np.asarray(generated_pos) - np.asarray(generated_pos)[0]
    best = (np.inf, None, None)
    orders = np.asarray(
        [[0] + list(p) for p in itertools.permutations(range(1, n))],
        np.int32,
    )
    perms_g = jnp.asarray(g)[jnp.asarray(orders)]          # [P, N, 3]
    o_b = jnp.broadcast_to(jnp.asarray(o), perms_g.shape)
    rmsds = np.asarray(jax.jit(kabsch_rmsd)(perms_g, o_b))
    k = int(np.argmin(rmsds))
    order = orders[k].tolist()
    _, _, aligned = kabsch(perms_g[k], jnp.asarray(o))
    best = (float(rmsds[k]), order, np.asarray(aligned))
    return best


def _nearest_to_exo(pos: np.ndarray, k: int = 5) -> list:
    d = np.linalg.norm(pos[1:] - pos[0], axis=-1)
    return (np.argsort(d)[: k - 1] + 1).tolist()


def hungarian_align(original_pos: np.ndarray, generated_pos: np.ndarray):
    """Align large graphs: exhaustive perms of the 4 nearest-to-exO atoms
    choose the rotation, then global Hungarian matching
    (ref create_xyz.py:156-196).

    Returns (rmsd, row_ind, col_ind, aligned_generated_pos).
    """
    o = np.asarray(original_pos) - np.asarray(original_pos)[0]
    g = np.asarray(generated_pos) - np.asarray(generated_pos)[0]
    o_near = np.concatenate([[o[0]], o[_nearest_to_exo(o, 5)]])
    g_near_idx = _nearest_to_exo(g, 5)
    best_rmsd, best_rot = np.inf, np.eye(3)
    for perm in itertools.permutations(range(4)):
        g_near = np.concatenate(
            [[g[0]], g[[g_near_idx[p] for p in perm]]]
        )
        rot, _, aligned = kabsch(jnp.asarray(g_near), jnp.asarray(o_near))
        r = float(kabsch_rmsd(jnp.asarray(g_near), jnp.asarray(o_near)))
        if r < best_rmsd:
            best_rmsd, best_rot = r, np.asarray(rot)
    aligned_g = g @ best_rot.T
    cost = np.linalg.norm(o[:, None, :] - aligned_g[None, :, :], axis=-1)
    row_ind, col_ind = linear_sum_assignment(cost)
    final_rmsd = float(
        kabsch_rmsd(jnp.asarray(aligned_g[col_ind]), jnp.asarray(o[row_ind]))
    )
    return final_rmsd, row_ind, col_ind, aligned_g
