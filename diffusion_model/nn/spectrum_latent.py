"""Spectrum -> latent conditioning path (Encoder/Decoder extension point).

The reference gates this behind ``Encoder_Decoder.spectrum_to_latent``
(ref main.py:97-98,155-166) but the implementing module
(``spectrum_to_latent/``) was never committed and is unrecoverable
(SURVEY.md §7 hard-part 6). This module supplies the documented extension
point plus a working default: a plain MLP autoencoder whose encoder replaces
each graph's spectrum with its latent on node 0 and zeros elsewhere —
exactly the dataset transformation ref main.py:155-166 performs.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from diffusion_model.nn.dense import dense, init_dense


def _mlp_init(key, prefix, in_dim, hidden_dims, out_dim):
    p = {}
    for i, f in enumerate(hidden_dims):
        p[f"{prefix}{i}"] = init_dense(key, f"{prefix}{i}", in_dim, f)
        in_dim = f
    p[f"{prefix}_out"] = init_dense(key, f"{prefix}_out", in_dim, out_dim)
    return {"params": p}


def _mlp_apply(variables, prefix, n_hidden, y):
    p = variables["params"]
    for i in range(n_hidden):
        y = jax.nn.relu(dense(p[f"{prefix}{i}"], y))
    return dense(p[f"{prefix}_out"], y)


@dataclasses.dataclass(frozen=True)
class SpectrumEncoder:
    latent_dim: int = 32
    hidden_dims: Sequence[int] = (128, 64)

    def init(self, key, spectrum) -> dict:
        return _mlp_init(key, "enc", spectrum.shape[-1], self.hidden_dims,
                         self.latent_dim)

    def apply(self, variables, spectrum: jnp.ndarray) -> jnp.ndarray:
        return _mlp_apply(variables, "enc", len(self.hidden_dims), spectrum)


@dataclasses.dataclass(frozen=True)
class SpectrumDecoder:
    spectrum_dim: int = 200
    hidden_dims: Sequence[int] = (64, 128)

    def init(self, key, latent) -> dict:
        return _mlp_init(key, "dec", latent.shape[-1], self.hidden_dims,
                         self.spectrum_dim)

    def apply(self, variables, latent: jnp.ndarray) -> jnp.ndarray:
        return _mlp_apply(variables, "dec", len(self.hidden_dims), latent)


def pretrain_autoencoder(spectra: np.ndarray, latent_dim: int = 32,
                         steps: int = 500, lr: float = 1e-3, seed: int = 0):
    """Train encoder+decoder on a [num, S] spectrum matrix; returns
    (encoder, enc_params, decoder, dec_params, final_mse)."""
    x = jnp.asarray(spectra, jnp.float32)
    enc = SpectrumEncoder(latent_dim=latent_dim)
    dec = SpectrumDecoder(spectrum_dim=x.shape[-1])
    k1, k2 = jax.random.split(jax.random.key(seed))
    enc_p = enc.init(k1, x[:1])
    dec_p = dec.init(k2, jnp.zeros((1, latent_dim)))
    params = {"enc": enc_p, "dec": dec_p}
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            z = enc.apply(p["enc"], x)
            rec = dec.apply(p["dec"], z)
            return jnp.mean((rec - x) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    loss = jnp.inf
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state)
    return enc, params["enc"], dec, params["dec"], float(loss)


def encode_dataset(graphs: list, encoder: SpectrumEncoder, enc_params) -> list:
    """Replace each graph's spectrum with its latent: latent on node 0,
    zeros on other nodes (ref main.py:155-166)."""
    out = []
    enc_fn = jax.jit(lambda s: encoder.apply(enc_params, s))
    for g in graphs:
        g = dict(g)
        spec = np.asarray(g["spectrum"], np.float32)
        latent = np.asarray(enc_fn(jnp.asarray(spec[0:1])))[0]
        n = spec.shape[0]
        new = np.zeros((n, latent.shape[0]), np.float32)
        new[0] = latent
        g["spectrum"] = new
        out.append(g)
    return out
