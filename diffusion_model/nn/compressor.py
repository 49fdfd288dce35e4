"""EELS spectrum compressor MLP.

Equivalent of the reference ``SpectrumCompressor`` (ref DataPreprocessor.py:
4-22): Linear/ReLU stack 200 -> hidden_dims -> 32 applied per node. Batched
over arbitrary leading axes; spectra live as ``[..., S]``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

from diffusion_model.nn.dense import dense, init_dense


@dataclasses.dataclass(frozen=True)
class SpectrumCompressor:
    hidden_dims: Sequence[int] = (150, 100, 50)
    out_dim: int = 32
    compute_dtype: jnp.dtype = jnp.float32

    def init_params(self, key, in_dim: int) -> dict:
        p = {}
        for i, f in enumerate(self.hidden_dims):
            p[f"dense{i}"] = init_dense(key, f"dense{i}", in_dim, f)
            in_dim = f
        p["dense_out"] = init_dense(key, "dense_out", in_dim, self.out_dim)
        return p

    def init(self, key, spectrum) -> dict:
        return {"params": self.init_params(key, spectrum.shape[-1])}

    def apply(self, variables, spectrum: jnp.ndarray) -> jnp.ndarray:
        return self.forward(variables["params"], spectrum)

    def forward(self, p, spectrum: jnp.ndarray) -> jnp.ndarray:
        dt = self.compute_dtype
        y = spectrum
        for i in range(len(self.hidden_dims)):
            y = jax.nn.relu(dense(p[f"dense{i}"], y, dt))
        return dense(p["dense_out"], y, dt).astype(spectrum.dtype)
