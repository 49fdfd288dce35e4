"""Forward-noising of training batches and the epsilon-prediction loss.

Rebuild of the reference's ``diffuse_as_batch`` + loss block
(ref parts/train_per_iretation.py:36-92 and :161-181). The reference loops
over graphs in Python to draw per-graph timesteps and noise; here one
vectorised draw covers the whole padded batch.

Loss semantics preserved exactly:
  * per-graph timestep t ~ U{1..T}                       (ref :43,56)
  * positions noised CoM-free, species one-hot noised plainly (ref :59-67)
  * prediction = [eps_x | eps_h] with eps_x mean-removed per graph
    (ref :161-166)
  * MSE with reduction='sum' over all real nodes, divided by the number of
    graphs for the gradient (ref :168-169); reported per node (ref :181).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from diffusion_model.config import Config
from diffusion_model.data.batch import GraphBatch
from diffusion_model.diffusion.process import Schedule, diffuse_zero_to_t


def diffuse_batch(schedule: Schedule, cfg: Config, key, batch: GraphBatch):
    """Draw per-graph timesteps and noise the batch to them.

    Returns:
      (pos_t, h_t, t [B] int32, eps_pos, eps_h)
    """
    b = batch.batch_size
    k_t, k_pos, k_h = jax.random.split(key, 3)
    t = jax.random.randint(k_t, (b,), 1, cfg.num_diffusion_timestep + 1)
    if cfg.t_bias_frac > 0.0:
        # importance-sample the structure-formation band: per-t loss
        # profiling (docs/quality/size512net_per_t_profile.json) localises
        # the large-cell chemical-order deficit at mid noise levels, so an
        # opt-in fraction of each batch redraws t uniformly from
        # [t_bias_lo, t_bias_hi]. Default 0.0 = the reference's plain
        # uniform draw (ref parts/train_per_iretation.py:43,56).
        if not 1 <= cfg.t_bias_lo <= cfg.t_bias_hi \
                <= cfg.num_diffusion_timestep:
            # out-of-range band values would be silently clamped to
            # alphas[T] by gather clipping while t_norm = t/T > 1 reaches
            # the denoiser — inconsistent (noise level, time) pairs
            raise ValueError(
                f"t_bias band [{cfg.t_bias_lo}, {cfg.t_bias_hi}] must lie "
                f"within [1, num_diffusion_timestep="
                f"{cfg.num_diffusion_timestep}]"
            )
        # Key hygiene: split(k_t) children are threefry(k_t, 0..3) — the
        # SAME counter words randint(k_t, (b,)) already emitted as t[0..1],
        # i.e. the selection key would literally equal the first t draw's
        # bits. Deriving via fold_in with constants beyond any batch size
        # keeps the streams disjoint while leaving the frac=0 path (and
        # its reference-exact t draw) bit-identical.
        k_sel = jax.random.fold_in(k_t, 0x7FFFFFFE)
        k_band = jax.random.fold_in(k_t, 0x7FFFFFFD)
        t_band = jax.random.randint(
            k_band, (b,), cfg.t_bias_lo, cfg.t_bias_hi + 1
        )
        sel = jax.random.bernoulli(k_sel, cfg.t_bias_frac, (b,))
        t = jnp.where(sel, t_band, t)
    pos_t, eps_pos = diffuse_zero_to_t(
        schedule, k_pos, batch.pos, t, mode="pos", mask=batch.mask
    )
    if cfg.diffuse_species:
        h_t, eps_h = diffuse_zero_to_t(
            schedule, k_h, batch.species, t, mode="h", mask=batch.mask
        )
    else:
        # position-only variant: clean species features, no h target
        # (ref train.py:247-283 trains on the position noise alone)
        h_t = batch.species
        eps_h = jnp.zeros_like(batch.species)
    return pos_t, h_t, t, eps_pos, eps_h


def t_band_weights(cfg: Config, t):
    """Per-graph loss weights for the t-band weighting lever.

    ``w(t) = t_loss_weight`` inside ``[t_bias_lo, t_bias_hi]``, 1 outside,
    divided by the ANALYTIC expected weight under the uniform t draw so
    the loss scale is batch-size independent (a batch-mean normalisation
    would cancel the weighting entirely at batch_size=1, e.g. on the ring
    path). Returns None when the lever is off (reference-exact loss).
    """
    if cfg.t_loss_weight == 1.0:
        return None
    if not 1 <= cfg.t_bias_lo <= cfg.t_bias_hi <= cfg.num_diffusion_timestep:
        raise ValueError(
            f"t-band [{cfg.t_bias_lo}, {cfg.t_bias_hi}] must lie within "
            f"[1, num_diffusion_timestep={cfg.num_diffusion_timestep}]"
        )
    if cfg.t_loss_weight <= 0.0:
        raise ValueError(f"t_loss_weight={cfg.t_loss_weight} must be > 0")
    in_band = (t >= cfg.t_bias_lo) & (t <= cfg.t_bias_hi)
    w = jnp.where(in_band, cfg.t_loss_weight, 1.0)
    p_band = (cfg.t_bias_hi - cfg.t_bias_lo + 1) / cfg.num_diffusion_timestep
    return w / (1.0 + (cfg.t_loss_weight - 1.0) * p_band)


def epsilon_loss(eps_x_pred, eps_h_pred, eps_x, eps_h, mask,
                 include_h: bool = True, weights=None):
    """Sum-MSE over [eps_x | eps_h] with the reference's normalisations.

    ``weights``: optional ``[B]`` per-graph loss weights (t_band_weights) —
    applied to the GRADIENT loss only; the reported ``sum_sq`` metric stays
    the raw unweighted error so loss curves remain comparable across arms.

    Returns:
      (loss_for_grad = (weighted) sum / num_graphs,
       sum_sq        = raw summed squared error,
       num_nodes     = real atoms in the batch)
    """
    m3 = mask[..., None]
    per_graph = jnp.sum(((eps_x_pred - eps_x) ** 2) * m3, axis=(1, 2))
    if include_h:
        per_graph = per_graph + jnp.sum(
            ((eps_h_pred - eps_h) ** 2) * m3, axis=(1, 2)
        )
    sq = jnp.sum(per_graph)
    # count only graphs with at least one real node (batch padding rows
    # have all-zero masks and must not dilute the per-graph normalisation)
    num_graphs = jnp.maximum(
        jnp.sum(jnp.any(mask > 0, axis=-1).astype(sq.dtype)), 1.0
    )
    num_nodes = jnp.sum(mask)
    loss_sq = (
        jnp.sum(per_graph * weights.astype(per_graph.dtype))
        if weights is not None else sq
    )
    return loss_sq / num_graphs, sq, num_nodes
