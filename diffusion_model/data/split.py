"""Seeded dataset splitting and batching.

Mirrors ``SetUpData.split`` semantics (ref split_to_train_and_test.py:98-108):
seeded random 80/10/10 split with lengths ``int(0.8n)``, ``int(0.1n)``,
remainder — deterministic given the seed.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import jax.numpy as jnp
import numpy as np

from diffusion_model.data.batch import GraphBatch, collate


def split_dataset(dataset: Sequence, seed: int, train_ratio: float = 0.8,
                  val_ratio: float = 0.1):
    n = len(dataset)
    n_train = int(n * train_ratio)
    n_val = int(n * val_ratio)
    perm = np.random.default_rng(seed).permutation(n)
    pick = lambda idx: [dataset[i] for i in idx]
    return (
        pick(perm[:n_train]),
        pick(perm[n_train : n_train + n_val]),
        pick(perm[n_train + n_val :]),
    )


def device_batch_iterator(data: GraphBatch, batch_size: int,
                          seed: int | None = None,
                          drop_remainder: bool = False
                          ) -> Iterator[GraphBatch]:
    """Shuffled padded batches gathered ON DEVICE from a pre-collated
    dataset (``collate(graphs, n_max)`` once, then index per epoch).

    Byte-identical semantics to ``batch_iterator`` (same seeded
    permutation, same cycled-filler + zeroed-mask final batch), but the
    per-epoch host work is one tiny int32 index transfer instead of
    re-collating and re-uploading every batch. The dataset stays resident
    in device memory and each epoch gathers from it, which keeps
    host<->device traffic minimal (SURVEY §2.7).
    """
    g = int(data.mask.shape[0])
    idx = np.arange(g)
    if seed is not None:
        np.random.default_rng(seed).shuffle(idx)
    n_batches = len(idx) // batch_size
    remainder = len(idx) - n_batches * batch_size
    valid = np.ones(len(idx), np.float32)
    if remainder and not drop_remainder:
        filler = np.resize(idx, batch_size - remainder)  # cycles if tiny
        idx = np.concatenate([idx, filler])
        valid = np.concatenate(
            [valid, np.zeros(batch_size - remainder, np.float32)]
        )
    elif remainder:
        idx = idx[: n_batches * batch_size]
        valid = valid[: n_batches * batch_size]
    idx_dev = jnp.asarray(idx, jnp.int32)
    valid_dev = jnp.asarray(valid)
    for start in range(0, len(idx), batch_size):
        sl = idx_dev[start : start + batch_size]
        v = valid_dev[start : start + batch_size]
        yield GraphBatch(
            pos=jnp.take(data.pos, sl, axis=0),
            species=jnp.take(data.species, sl, axis=0),
            spectrum=jnp.take(data.spectrum, sl, axis=0),
            exo=jnp.take(data.exo, sl, axis=0),
            mask=jnp.take(data.mask, sl, axis=0) * v[:, None],
        )


def batch_iterator(graphs: Sequence[dict], batch_size: int, n_max: int,
                   seed: int | None = None, drop_remainder: bool = False
                   ) -> Iterator[GraphBatch]:
    """Shuffled padded batches with static shapes.

    The final short batch is padded up to ``batch_size`` by repeating
    entries **with their node masks zeroed**, so padded rows contribute
    nothing to losses/metrics (each graph is weighted exactly once per
    epoch, as in the reference) while jit sees one batch shape.
    """
    idx = np.arange(len(graphs))
    if seed is not None:
        np.random.default_rng(seed).shuffle(idx)
    for start in range(0, len(idx), batch_size):
        chunk = idx[start : start + batch_size]
        n_real = len(chunk)
        if n_real < batch_size:
            if drop_remainder:
                return
            filler = np.resize(idx, batch_size - n_real)  # cycles if tiny
            chunk = np.concatenate([chunk, filler])
        batch = collate([graphs[i] for i in chunk], n_max)
        if n_real < batch_size:
            mask = np.array(batch.mask)  # writable copy
            mask[n_real:] = 0.0
            batch = dataclasses.replace(batch, mask=jnp.asarray(mask))
        yield batch
