"""Padded fixed-shape graph batches — the framework's core data structure.

The reference stores graphs as PyG ``Data`` objects with variable node counts
and loops over them in Python (ref parts/train_per_iretation.py:52,
diffusion_x_h.py:10-13). Here a batch is a pytree of rectangular arrays with
a node mask, so every op is one fused XLA computation and shapes are static
under jit:

  pos      [B, N, 3]   coordinates
  species  [B, N, A]   one-hot species (O=[1,0], Si=[0,1];
                       ref make_dataset.py:112-118)
  spectrum [B, N, S]   per-node conditioning spectra (row 0 = exO carries the
                       real EELS curve, ref make_dataset.py:125-128)
  exo      [B, N, 1]   excited-atom indicator (node 0; ref make_dataset.py:129)
  mask     [B, N]      1 for real atoms, 0 for padding
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from diffusion_model.ops.edges import dense_pair_mask


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GraphBatch:
    pos: jnp.ndarray
    species: jnp.ndarray
    spectrum: jnp.ndarray
    exo: jnp.ndarray
    mask: jnp.ndarray

    @property
    def batch_size(self) -> int:
        return self.pos.shape[0]

    @property
    def n_max(self) -> int:
        return self.pos.shape[1]

    def pair_mask(self) -> jnp.ndarray:
        return dense_pair_mask(self.mask)

    def num_nodes(self) -> jnp.ndarray:
        """Total real atoms in the batch (ref train loop's num_nodes)."""
        return jnp.sum(self.mask)

    def __len__(self) -> int:
        return self.batch_size


def pad_graph(
    pos: np.ndarray,
    species: np.ndarray,
    spectrum: np.ndarray,
    exo: np.ndarray,
    n_max: int,
):
    """Pad one graph's arrays to ``n_max`` nodes, returning (arrays, mask)."""
    n = pos.shape[0]
    if n > n_max:
        raise ValueError(f"graph has {n} atoms > n_max={n_max}")

    def pad(a):
        out = np.zeros((n_max,) + a.shape[1:], dtype=np.float32)
        out[:n] = a
        return out

    mask = np.zeros((n_max,), np.float32)
    mask[:n] = 1.0
    return pad(pos), pad(species), pad(spectrum), pad(exo), mask


def collate(graphs: Sequence[dict], n_max: int) -> GraphBatch:
    """Stack a list of graph dicts (numpy arrays keyed pos/species/spectrum/
    exo) into a padded GraphBatch."""
    pos, sp, spec, exo, mask = [], [], [], [], []
    for g in graphs:
        p, s, sc, e, m = pad_graph(
            np.asarray(g["pos"], np.float32),
            np.asarray(g["species"], np.float32),
            np.asarray(g["spectrum"], np.float32),
            np.asarray(g["exo"], np.float32),
            n_max,
        )
        pos.append(p)
        sp.append(s)
        spec.append(sc)
        exo.append(e)
        mask.append(m)
    return GraphBatch(
        pos=jnp.asarray(np.stack(pos)),
        species=jnp.asarray(np.stack(sp)),
        spectrum=jnp.asarray(np.stack(spec)),
        exo=jnp.asarray(np.stack(exo)),
        mask=jnp.asarray(np.stack(mask)),
    )
