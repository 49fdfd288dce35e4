"""Coordination-number predictor: spectrum -> atom count regression.

Equivalent of the reference's standalone CN model (ref CN.py:79-96): a ReLU
MLP spectrum(200) -> hidden -> 1 regressing the number of atoms in the local
environment from the EELS spectrum.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from diffusion_model.nn.dense import dense, init_dense


@dataclasses.dataclass(frozen=True)
class CNPredictor:
    hidden_dims: Sequence[int] = (100, 100, 50, 25)

    def init(self, key, spectrum) -> dict:
        p, in_dim = {}, spectrum.shape[-1]
        for i, f in enumerate(self.hidden_dims):
            p[f"dense{i}"] = init_dense(key, f"dense{i}", in_dim, f)
            in_dim = f
        p["dense_out"] = init_dense(key, "dense_out", in_dim, 1)
        return {"params": p}

    def apply(self, variables, spectrum: jnp.ndarray) -> jnp.ndarray:
        p = variables["params"]
        y = spectrum
        for i in range(len(self.hidden_dims)):
            y = jax.nn.relu(dense(p[f"dense{i}"], y))
        return dense(p["dense_out"], y)
