"""The full conditional denoiser: feature assembly + EGNN -> (eps_x, eps_h).

This is the jittable heart of the framework, reproducing the feature layout
and epsilon extraction spread across the reference's training/sampling loops
(ref parts/train_per_iretation.py:136-163 and :343-369):

    h_in  = [species_t(A) | compressed_spectrum(32) or spectrum(S) | exO | t/T]
    h', x' = EGNN(h_in, pos_t)
    eps_x = remove_mean(x' - pos_t)   (per graph, masked)
    eps_h = h'[..., :A]

Everything is padded/masked; no dynamic shapes.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from diffusion_model.config import Config
from diffusion_model.nn.compressor import SpectrumCompressor
from diffusion_model.nn.dense import subkey
from diffusion_model.nn.egnn import EquivariantGNN
from diffusion_model.ops.com import remove_mean


@dataclasses.dataclass(frozen=True)
class DiffusionDenoiser:
    cfg: Config

    @property
    def compute_dtype(self):
        return jnp.bfloat16 if self.cfg.compute_dtype == "bfloat16" \
            else jnp.float32

    @property
    def compressor(self) -> SpectrumCompressor:
        cfg = self.cfg
        return SpectrumCompressor(
            hidden_dims=tuple(cfg.compressor_hidden_dim),
            out_dim=cfg.compressed_spectrum_size,
            compute_dtype=self.compute_dtype,
        )

    @property
    def egnn(self) -> EquivariantGNN:
        cfg = self.cfg
        return EquivariantGNN(
            L=cfg.L,
            m_hidden=cfg.m_hidden_size,
            m_out=cfg.m_size,
            x_hidden=cfg.x_hidden_size,
            h_hidden=cfg.h_hidden_size,
            h_out=cfg.h_size,
            compat_scalar_norm=cfg.compat_scalar_norm,
            compute_dtype=self.compute_dtype,
            zero_init_x=cfg.zero_init_x,
            h_init_scale=cfg.h_init_scale,
            h_residual=cfg.h_residual,
            virtual_node=cfg.virtual_node,
            edge_rbf=cfg.edge_rbf,
            edge_rbf_rmax=cfg.edge_rbf_rmax,
            remat_egcl=cfg.remat_egcl,
        )

    def init(self, key, species_t, pos_t, spectrum, exo, t_norm, node_mask,
             edges) -> dict:
        """``{"params": tree}`` for inputs of these shapes (see
        :meth:`apply` for the arguments)."""
        cfg = self.cfg
        p = {}
        hdim = species_t.shape[-1] + t_norm.shape[-1]
        if cfg.conditional:
            if cfg.to_compress_spectrum:
                p["spectrum_compressor"] = self.compressor.init_params(
                    subkey(key, "spectrum_compressor"), spectrum.shape[-1])
                hdim += cfg.compressed_spectrum_size
            else:
                hdim += spectrum.shape[-1]
        if cfg.give_exO:
            hdim += exo.shape[-1]
        if cfg.global_radius_feature:
            p["radius_feature_gate"] = jnp.zeros((1,), jnp.float32)
            hdim += 1
        egnn = self.egnn
        egnn.layer._check(node_mask)
        p["egnn"] = egnn.init_params(subkey(key, "egnn"), hdim)
        return {"params": p}

    def apply(self, variables, species_t, pos_t, spectrum, exo, t_norm,
              node_mask, edges):
        """Predict the joint noise.

        Args:
          variables: ``{"params": tree}`` from :meth:`init`.
          species_t: ``[B, N, A]`` noisy species channel (already scaled by
            ``onehot_scaling_factor`` where the caller wants that).
          pos_t: ``[B, N, 3]`` noisy positions.
          spectrum: ``[B, N, S]`` per-node conditioning spectra.
          exo: ``[B, N, 1]`` excited-atom indicator.
          t_norm: ``[B, N, 1]`` diffusion time t/T.
          node_mask: ``[B, N]``.
          edges: dense pair mask ``[B, N, N]`` or fixed-degree neighbour
            tuple ``(idx, edge_mask)`` — see nn/egnn.py.

        Returns:
          (eps_x ``[B, N, 3]`` CoM-free masked, eps_h ``[B, N, A]`` masked).
        """
        cfg = self.cfg
        p = variables["params"]

        feats = [species_t]
        if cfg.conditional:
            if cfg.to_compress_spectrum:
                feats.append(self.compressor.forward(
                    p["spectrum_compressor"], spectrum))
            else:
                feats.append(spectrum)
        if cfg.give_exO:
            feats.append(exo)
        if cfg.global_radius_feature:
            # E(3)-invariant global-envelope signal: log1p of each node's
            # distance to the masked CoM. Local (kNN) message passing
            # cannot see the global density envelope of a large cell;
            # this scalar restores that information at O(N) cost
            # (see config.global_radius_feature).
            m3 = node_mask[..., None].astype(pos_t.dtype)
            count = jnp.maximum(
                jnp.sum(node_mask, axis=-1, keepdims=True), 1.0
            )[..., None]
            com = jnp.sum(pos_t * m3, axis=1, keepdims=True) / count
            d2 = jnp.sum((pos_t - com) ** 2, axis=-1, keepdims=True)
            # safe-sqrt: padded rows hit d2=|com|^2 != 0 only via masked
            # inputs; clamp anyway so the origin node's gradient is finite
            r = jnp.sqrt(jnp.maximum(d2, 1e-12))
            # Zero-init learnable gate: unlike the other (noise-like)
            # features this one varies SMOOTHLY across space, so neighbor
            # sums add coherently (~K not ~sqrt(K) growth per layer) and
            # at random init a 512-atom kNN-32 stack diverges from epoch 0
            # (measured: instant NaN at 512, 5x init-loss at 128). Gating
            # it to zero makes the untrained net exactly the no-flag net;
            # the gate and the first-layer column train jointly.
            gate = p["radius_feature_gate"].astype(pos_t.dtype)
            feats.append(jnp.log1p(r) * m3 * gate)
        feats.append(t_norm)
        h_in = jnp.concatenate(feats, axis=-1)

        egnn = self.egnn
        egnn.layer._check(node_mask)
        h_out, x_out = egnn.forward(p["egnn"], h_in, pos_t, edges,
                                    node_mask=node_mask)

        mask3 = node_mask[..., None].astype(pos_t.dtype)
        eps_x = remove_mean((x_out - pos_t) * mask3, node_mask)
        eps_h = h_out[..., : cfg.atom_type_size] * mask3
        return eps_x, eps_h
