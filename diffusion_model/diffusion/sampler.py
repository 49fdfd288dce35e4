"""Reverse-diffusion sampler as a single ``lax.scan`` — zero host sync.

Rebuild of the reference ``generate`` (ref parts/train_per_iretation.py:
264-444), which drives 1000 sequential EGNN calls per sample from Python.
Here the T -> 1 loop is one scanned, jitted program; samples-per-condition
and the condition batch are just leading axes; the special t=0 step
(ref :391-428) is the scan epilogue, and the Python NaN-retry loop
(ref :376-389) becomes a vectorised accept mask + batched host-level retry.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from diffusion_model.config import Config
from diffusion_model.data.batch import GraphBatch
from diffusion_model.diffusion.process import (
    Schedule,
    final_denoise_step,
    reverse_diffuse_one_step,
    head_out_to_eps,
    x_param_is_x0,
)
from diffusion_model.ops.com import remove_mean


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SampleResult:
    pos: jnp.ndarray        # [B, N, 3] final coordinates
    species: jnp.ndarray    # [B, N, A] one-hot argmax species
    h: jnp.ndarray          # [B, N, A] raw final species channel
    finite: jnp.ndarray     # [B] bool: no NaN/Inf produced
    accepted: jnp.ndarray   # [B] bool: finite and coords <= 1000 A (ref :434)
    trajectory: Optional[Any] = None  # (pos, h) stacked every snapshot step


def tile_batch(cond: GraphBatch, n: int) -> GraphBatch:
    """Repeat each condition ``n`` times (gen_num_per_spectrum samples)."""
    return jax.tree.map(lambda a: jnp.repeat(a, n, axis=0), cond)


def snr_grid(alphas: jnp.ndarray, steps: int) -> jnp.ndarray:
    """``steps+1`` schedule indices equispaced in log-SNR.

    gamma(t) = log(sigma_t^2 / alpha_t^2) is monotone in t; picking grid
    points at equal gamma increments concentrates reverse steps where the
    schedule actually transitions. On the reference polynomial schedule
    this is close to uniform; on a trained GammaNetwork that squeezes its
    signal band into a sub-interval of t it reallocates the budget there.
    Endpoints are pinned to 0 and T and the index sequence is forced
    strictly monotone where possible (flat-gamma plateaus may still pick
    the same index twice — those steps degenerate to alpha_ts = 1, i.e.
    an exact no-op in the posterior math).
    """
    # Compute gamma without saturating either tail in float32: the naive
    # log((1-a2)/a2) form needs a2 clipped to ~[1e-7, 1-1e-7], which
    # flattens the deep-noise tail of learned schedules (alpha < 3e-4) —
    # the grid then fuses that whole region into one step whose
    # alpha_t/alpha_s ratio underflows and the posterior mean z/alpha_ts
    # explodes. log1p keeps the alpha~1 end exact and log(a2) itself is
    # finite down to a2 ~ 1e-38.
    a2 = alphas.astype(jnp.float32) ** 2
    gamma = (jnp.log1p(-jnp.minimum(a2, 1.0 - 1e-7))
             - jnp.log(jnp.maximum(a2, 1e-38)))
    levels = jnp.linspace(gamma[0], gamma[-1], steps + 1)
    idx = jnp.searchsorted(gamma, levels).astype(jnp.int32)
    t_max = alphas.shape[0] - 1
    idx = idx.at[0].set(0).at[-1].set(t_max)
    # strictly increasing where the level spacing allows it
    idx = jnp.maximum(idx, jnp.arange(steps + 1, dtype=jnp.int32))
    idx = jnp.minimum(
        idx, t_max - steps + jnp.arange(steps + 1, dtype=jnp.int32)
    )
    return jax.lax.cummax(idx)


def sample(
    denoise_fn: Callable,
    schedule: Schedule,
    cfg: Config,
    key: jax.Array,
    cond: GraphBatch,
    return_trajectory: bool = False,
):
    """Generate structures for a batch of conditions.

    Args:
      denoise_fn: ``(species_ch, pos, spectrum, exo, t_norm, mask, pair_mask)
        -> (eps_x, eps_h)`` — typically a partial of
        ``DiffusionDenoiser.apply`` over trained params.
      cond: conditioning batch; ``pos``/``species`` fields are ignored,
        ``spectrum``/``exo``/``mask`` drive generation.

    Returns:
      SampleResult.
    """
    T = cfg.num_diffusion_timestep
    steps = cfg.sample_steps or T
    if steps > T:
        # More reverse steps than schedule entries cannot be strided over
        # the T+1 table: the snr_grid monotonicity clamp would wrap leading
        # indices negative (a silently corrupt schedule) and the uniform
        # grid merely degenerates to repeated indices.
        raise ValueError(
            f"sample_steps={steps} exceeds num_diffusion_timestep={T}"
        )
    if steps != T:
        # strided ancestral sampling: subsample the schedule table; the
        # reverse-step posterior math is exact between any two entries
        if cfg.sample_grid == "snr":
            idx = snr_grid(schedule.alphas, steps)
        else:
            idx = jnp.round(jnp.linspace(0.0, T, steps + 1)).astype(
                jnp.int32)
        schedule = Schedule(alphas=schedule.alphas[idx])
        t_norm_table = idx.astype(jnp.float32) / T
    else:
        t_norm_table = jnp.arange(T + 1, dtype=jnp.float32) / T
    scale = cfg.onehot_scaling_factor
    mask = cond.mask
    # dense pair mask only when the dense topology is in use — with kNN
    # neighbour lists the [B, N, N] tensor would defeat the point at 1024+,
    # and the ring path (cfg.ring_sample) materialises pair blocks on the
    # fly across the mesh, so building [B, N, N] here would defeat THAT
    pair_mask = (None if (cfg.neighbor_k or cfg.ring_sample)
                 else cond.pair_mask())
    b, n = mask.shape
    a_dim = cfg.atom_type_size

    key, k_pos, k_h = jax.random.split(key, 3)
    m3 = mask[..., None]
    # N(0,1) init, positions CoM-removed (ref :301-305)
    pos0 = remove_mean(jax.random.normal(k_pos, (b, n, 3)), mask)
    if cfg.diffuse_species:
        h0 = jax.random.normal(k_h, (b, n, a_dim)) * m3
    else:
        # position-only variant: species fixed to the condition's
        # (ref test.py:206-321 samples positions with known species)
        h0 = cond.species

    x0_mode = x_param_is_x0(cfg)

    def denoise(pos, h, t_idx):
        t_norm = jnp.full((b, n, 1), t_norm_table[t_idx], pos.dtype) * m3
        if cfg.neighbor_k and not cfg.ring_sample:
            from diffusion_model.ops.edges import knn_edges

            edges = knn_edges(pos, mask, cfg.neighbor_k)
        else:
            edges = pair_mask  # None on the ring path (ignored there)
        eps_x, eps_h = denoise_fn(
            scale * h, pos, cond.spectrum, cond.exo, t_norm, mask, edges
        )
        if cfg.guidance_scale > 0:
            # classifier-free guidance: (1+w) * cond - w * uncond
            # (requires training with cond_dropout_prob > 0)
            ex_u, eh_u = denoise_fn(
                scale * h, pos, jnp.zeros_like(cond.spectrum), cond.exo,
                t_norm, mask, edges,
            )
            w = cfg.guidance_scale
            eps_x = (1.0 + w) * eps_x - w * ex_u
            eps_h = (1.0 + w) * eps_h - w * eh_u
        if x0_mode:
            # x0/v-parameterised coordinate head: the network output is
            # read as a clean-structure displacement (x0) or velocity
            # (v); every consumer below runs on epsilon. Converting
            # AFTER the CFG combination is exact: both conversions are
            # affine in the output with a z-term independent of it, so
            # the z-terms of the cond/uncond branches cancel in the
            # (1+w)c - w u combination. With a strided schedule
            # ``t_idx`` indexes the SUBSAMPLED alpha table, which is
            # exactly the noise level this z_t carries.
            eps_x = head_out_to_eps(cfg, schedule, t_idx, pos, eps_x)
        return eps_x, eps_h

    def step(carry, t):
        pos, h, k = carry
        k, k1, k2 = jax.random.split(k, 3)
        eps_x, eps_h = denoise(pos, h, t)
        new_pos = reverse_diffuse_one_step(
            schedule, k1, pos, eps_x, t, mode="pos", mask=mask,
            deterministic=cfg.deterministic_sampling,
            noise_scale=cfg.sample_noise_scale,
        )
        if cfg.diffuse_species:
            # The reference applies the reverse step to the scaled species
            # channel graph.h[:, :A] = scale * graph.x (ref :373).
            new_h = reverse_diffuse_one_step(
                schedule, k2, scale * h, eps_h, t, mode="h", mask=mask,
                deterministic=cfg.deterministic_sampling,
                noise_scale=cfg.sample_noise_scale,
            )
        else:
            new_h = h
        # trajectory records the PRE-step state, as the reference snapshots
        # at the top of the loop (incl. the pure-noise t=T frame, ref
        # :331-337); frame k is the state entering step ts[k]
        out = (pos, h) if return_trajectory else None
        return (new_pos, new_h, k), out

    ts = jnp.arange(steps, 0, -1)
    (pos, h, key), traj = jax.lax.scan(step, (pos0, h0, key), ts)

    # Explicit t=0 denoise (ref :391-426). Index 0 of the (possibly
    # strided) table is always schedule entry 0, t_norm 0.0.
    eps_x, eps_h = denoise(pos, h, 0)
    key, k1, k2 = jax.random.split(key, 3)
    pos = final_denoise_step(schedule, k1, pos, eps_x, mode="pos", mask=mask,
                             deterministic=cfg.deterministic_sampling,
                             noise_scale=cfg.sample_noise_scale)
    if cfg.diffuse_species:
        h = final_denoise_step(schedule, k2, scale * h, eps_h, mode="h",
                               mask=mask,
                               deterministic=cfg.deterministic_sampling,
                               noise_scale=cfg.sample_noise_scale)
        species = jax.nn.one_hot(
            jnp.argmax(h, axis=-1), a_dim, dtype=pos.dtype
        )
        species = species * m3
    else:
        species = cond.species

    flat = lambda z: z.reshape(b, -1)
    finite = (
        jnp.all(jnp.isfinite(flat(pos)), axis=-1)
        & jnp.all(jnp.isfinite(flat(h)), axis=-1)
    )
    # Reference rejects coords > 1000 A, signed comparison (ref :434).
    accepted = finite & ~jnp.any(flat(pos) > 1000.0, axis=-1)

    if return_trajectory and traj is not None:
        every = cfg.snapshot_every
        traj = jax.tree.map(lambda z: z[::every], traj)

    return SampleResult(
        pos=pos, species=species, h=h, finite=finite, accepted=accepted,
        trajectory=traj if return_trajectory else None,
    )


def sample_with_retry(
    denoise_fn: Callable,
    schedule: Schedule,
    cfg: Config,
    key: jax.Array,
    cond: GraphBatch,
    jitted_sample: Callable | None = None,
):
    """Sampling with the reference's NaN-retry semantics, vectorised.

    The reference retries a sample on NaN up to 10 times then aborts
    (ref :376-389). Here the whole batch is sampled at once; entries that
    produced non-finite values are re-drawn with fresh keys, keeping
    successes, for at most ``cfg.max_nan_retries`` rounds.
    """
    if jitted_sample is None:
        jitted_sample = partial(sample, denoise_fn, schedule, cfg)
    result = jitted_sample(key, cond)
    for _ in range(cfg.max_nan_retries):
        # the reference regenerates until every condition has an *accepted*
        # sample (NaN and >1000 A rejects alike, ref :299,431-436)
        if bool(jnp.all(result.accepted)):
            break
        key, sub = jax.random.split(key)
        retry = jitted_sample(sub, cond)
        take = (~result.accepted) & retry.accepted

        def merge(old, new, axis=0):
            shape = [1] * old.ndim
            shape[axis] = -1
            return jnp.where(take.reshape(shape), new, old)

        trajectory = result.trajectory
        if trajectory is not None and retry.trajectory is not None:
            # trajectories are [snapshots, B, ...] — batch axis 1
            trajectory = jax.tree.map(
                lambda o, n: merge(o, n, axis=1), trajectory,
                retry.trajectory,
            )
        result = SampleResult(
            pos=merge(result.pos, retry.pos),
            species=merge(result.species, retry.species),
            h=merge(result.h, retry.h),
            finite=jnp.where(take, retry.finite, result.finite),
            accepted=result.accepted | retry.accepted,
            trajectory=trajectory,
        )
    return result
