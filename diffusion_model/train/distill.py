"""Progressive distillation of the reverse chain into a few-step student.

The reference can only trade quality for speed by truncating its 1000-step
Python sampling loop (ref parts/train_per_iretation.py:335-389); the strided
sampler (diffusion/sampler.py, ``cfg.sample_steps``) already does that
losslessly down to ~100 steps. Progressive distillation (Salimans & Ho,
"Progressive Distillation for Fast Sampling of Diffusion Models", ICLR 2022)
goes further: a student with half the steps is trained so that ONE of its
deterministic reverse steps lands where TWO teacher steps land, then the
student becomes the next teacher — halving repeatedly (1000 -> 500 -> 250
-> 125 for T=1000).

Adaptation notes (this framework, not the paper, defines the step form):
  * The shipped deterministic step is linear in (z, eps):
        z_{t-1} = A z_t + B eps_hat(z_t, t),
    with A = alpha_s/alpha_t and B = -sigma2_ts / (alpha_ts sigma_t)
    (diffusion/process.py calculate_mu, ref diffusion_x_h.py:61-73). The
    one-step eps that lands where the teacher's two steps land is therefore
        eps_target = (z_teacher(2 steps) - A_S z_t) / B_S,
    and the student is regressed onto it with a plain eps-MSE — the same
    w(t)=1 weighting the teacher itself was trained with. (Matching in
    z-space instead diverges: A and B scale like alpha_s/alpha_t, which
    explodes at the low-alpha end of the schedule, so the z-space loss is
    dominated by the last few steps by factors of ~1e6+. The paper's
    v-prediction serves the same stabilising role; eps-space with dyadic
    grids that exclude the t=0 corner is sufficient here because B_S is
    bounded away from zero on every grid the recursion visits.)
  * Positions live on the zero-CoM subspace; A/B scaling preserves it, so
    no extra projection is needed beyond the denoiser's own remove_mean.
  * Both channels of the joint (x, h) process are distilled when
    ``cfg.diffuse_species`` (ref parts/train_per_iretation.py:372-373).
  * Grids are dyadic subsets of the original 0..T table, so a K-step
    student is sampled by the existing strided sampler —
    ``cfg.replace(sample_steps=K, deterministic_sampling=True)`` produces
    exactly the grid the student was trained on whenever K divides T.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Iterable

import jax
import jax.numpy as jnp
import optax

from diffusion_model.config import Config
from diffusion_model.data.batch import GraphBatch
from diffusion_model.diffusion.process import Schedule, diffuse_zero_to_t


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PhaseSchedule:
    """One distillation phase's grid: alpha table + original t/T values."""

    alphas: jnp.ndarray   # [K+1]
    t_norm: jnp.ndarray   # [K+1] — grid point k's t/T on the ORIGINAL scale

    @property
    def num_steps(self) -> int:
        return self.alphas.shape[0] - 1

    def halve(self) -> "PhaseSchedule":
        if self.num_steps % 2:
            raise ValueError(f"cannot halve odd step count {self.num_steps}")
        return PhaseSchedule(alphas=self.alphas[::2], t_norm=self.t_norm[::2])


def full_phase(schedule: Schedule) -> PhaseSchedule:
    t = schedule.num_timesteps
    return PhaseSchedule(
        alphas=schedule.alphas,
        t_norm=jnp.arange(t + 1, dtype=jnp.float32) / t,
    )


def step_coeffs(alphas: jnp.ndarray, t):
    """(A, B) of the deterministic reverse step t -> t-1 on grid ``alphas``.

    Matches ``reverse_diffuse_one_step(..., deterministic=True)``:
    z_{t-1} = A z_t + B eps.
    """
    alpha_t = alphas[t]
    alpha_s = alphas[t - 1]
    sq_sigma_t = 1.0 - alpha_t**2
    alpha_ts = alpha_t / alpha_s
    # Near-flat learned-schedule segments make this a catastrophic
    # cancellation that can round negative (same clamp as
    # diffusion/process.py reverse_diffuse_one_step).
    sq_sigma_ts = jnp.maximum(
        sq_sigma_t - alpha_ts**2 * (1.0 - alpha_s**2), 0.0
    )
    a = 1.0 / alpha_ts
    b = -sq_sigma_ts / (alpha_ts * jnp.sqrt(sq_sigma_t))
    return a, b


def _per_graph(coef, z):
    return coef.reshape(coef.shape + (1,) * (z.ndim - coef.ndim)).astype(
        z.dtype
    )


def _make_denoise(cfg: Config, apply_fn: Callable, cond: GraphBatch, edges):
    """Denoiser closure mirroring the sampler's feature assembly
    (diffusion/sampler.py denoise): per-graph t_norm broadcast over nodes,
    species channel scaled by ``onehot_scaling_factor``."""
    scale = cfg.onehot_scaling_factor
    mask = cond.mask
    m3 = mask[..., None]

    def denoise(params, pos, h, t_norm_g):
        t_norm = t_norm_g[:, None, None] * jnp.ones_like(m3) * m3
        if cfg.neighbor_k:
            from diffusion_model.ops.edges import knn_edges

            e = knn_edges(pos, mask, cfg.neighbor_k)
        else:
            e = edges
        return apply_fn(
            params, scale * h, pos, cond.spectrum, cond.exo, t_norm, mask, e
        )

    return denoise


def distill_loss(student_params, teacher_params, apply_fn, cfg: Config,
                 teacher_phase: PhaseSchedule, student_phase: PhaseSchedule,
                 key, batch: GraphBatch, target_clip: float = 20.0):
    """Two-for-one eps-matching loss for one batch.

    Draw a per-graph student step j ~ U{1..K}, noise the clean batch to grid
    point j (== teacher point 2j), run the teacher two deterministic steps,
    solve for the one-step eps that reproduces the teacher's landing point,
    and regress the student's eps prediction onto it.
    """
    if cfg.x_parameterization != "eps":
        # the two-for-one target algebra below reads raw network outputs
        # as epsilon; wiring the x0 conversion through the teacher/student
        # grids is untested — refuse loudly rather than distill garbage
        raise NotImplementedError(
            "progressive distillation supports x_parameterization='eps' "
            f"only (got {cfg.x_parameterization!r})"
        )
    b, _ = batch.mask.shape
    m3 = batch.mask[..., None]
    k_j, k_pos, k_h = jax.random.split(key, 3)
    kk = student_phase.num_steps
    j = jax.random.randint(k_j, (b,), 1, kk + 1)

    s_sched = Schedule(alphas=student_phase.alphas)
    pos_t, _ = diffuse_zero_to_t(s_sched, k_pos, batch.pos, j, mode="pos",
                                 mask=batch.mask)
    if cfg.diffuse_species:
        h_t, _ = diffuse_zero_to_t(s_sched, k_h, batch.species, j, mode="h",
                                   mask=batch.mask)
    else:
        h_t = batch.species

    edges = None if cfg.neighbor_k else batch.pair_mask()
    denoise = _make_denoise(cfg, apply_fn, batch, edges)

    # The sampler applies the reverse step to the SCALED species channel and
    # stores the result back unscaled (diffusion/sampler.py:128-131, ref
    # :373 stores reverse(scale*x) into graph.x), so the state transition in
    # h-units is h' = (A scale) h + B eps_h.
    scale = cfg.onehot_scaling_factor

    def teacher_step(pos, h, t_idx):
        eps_x, eps_h = denoise(teacher_params, pos, h,
                               teacher_phase.t_norm[t_idx])
        a, bb = step_coeffs(teacher_phase.alphas, t_idx)
        new_pos = (_per_graph(a, pos) * pos
                   + _per_graph(bb, eps_x) * eps_x) * m3
        if cfg.diffuse_species:
            new_h = (_per_graph(a * scale, h) * h
                     + _per_graph(bb, eps_h) * eps_h) * m3
        else:
            new_h = h
        return new_pos, new_h

    tt = 2 * j
    z1_pos, z1_h = teacher_step(pos_t, h_t, tt)
    z2_pos, z2_h = teacher_step(z1_pos, z1_h, tt - 1)

    a_s, b_s = step_coeffs(student_phase.alphas, j)
    a_s3 = _per_graph(a_s, pos_t)
    # B <= 0 after the sq_sigma_ts clamp; a near-flat segment makes it ~0
    # (the step ignores eps there) — floor it so the target stays finite
    # (target_clip then bounds the regression pressure).
    inv_b = _per_graph(1.0 / jnp.minimum(b_s, -1e-8), pos_t)
    # Static target thresholding: at the TOP grid step the teacher's first
    # half-step multiplies its own eps error by alpha_{T-1}/alpha_T (~1e2+),
    # pushing its second evaluation off-distribution — the coordinate-channel
    # target can then reach 1e6+ even for a decent teacher (measured; the
    # paper's x-clipping plays the same role). Clipping keeps the target's
    # *direction*, which is all the student can usefully learn there.
    clip = lambda v: jnp.clip(v, -target_clip, target_clip)
    eps_x_tgt = clip(
        jax.lax.stop_gradient((z2_pos - a_s3 * pos_t) * inv_b)
    ) * m3

    eps_x_s, eps_h_s = denoise(student_params, pos_t, h_t,
                               student_phase.t_norm[j])
    sq = jnp.sum(((eps_x_s - eps_x_tgt) ** 2) * m3)
    if cfg.diffuse_species:
        # student step on h is h' = (A_S scale) h + B_S eps (see
        # teacher_step): invert that operator for the target.
        eps_h_tgt = clip(jax.lax.stop_gradient(
            (z2_h - a_s3 * scale * h_t) * inv_b
        )) * m3
        sq = sq + jnp.sum(((eps_h_s - eps_h_tgt) ** 2) * m3)
    num_graphs = jnp.maximum(
        jnp.sum(jnp.any(batch.mask > 0, axis=-1).astype(sq.dtype)), 1.0
    )
    return sq / num_graphs


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistillResult:
    params: dict          # BARE student denoiser variables (the same
    # shape as the teacher_denoiser_params input — callers wrap it back
    # under {"denoiser": ...} themselves, see api.distill)
    num_steps: int = dataclasses.field(metadata=dict(static=True))


def progressive_distill(
    cfg: Config,
    apply_fn: Callable,
    teacher_denoiser_params,
    schedule: Schedule,
    batches_fn: Callable[[], Iterable[GraphBatch]],
    key,
    final_steps: int,
    epochs_per_phase: int = 50,
    lr: float = 1e-4,
    target_clip: float = 20.0,
    log_fn: Callable[[str], None] = lambda s: None,
):
    """Distill ``teacher_denoiser_params`` down to a ``final_steps`` student.

    Args:
      apply_fn: ``DiffusionDenoiser.apply``-compatible callable.
      teacher_denoiser_params: the trained denoiser variables (the
        ``params["denoiser"]`` subtree; use eval params for schedule-free).
      schedule: the teacher's full T-step schedule table.
      batches_fn: zero-arg callable returning an iterable of GraphBatch —
        one epoch of clean training data (re-invoked every epoch).
      final_steps: target step count; ``T / final_steps`` must be a power
        of two.
      epochs_per_phase: distillation epochs per halving.

    Returns:
      DistillResult with the student params and its step count. Sample via
      ``cfg.replace(sample_steps=result.num_steps,
      deterministic_sampling=True)`` — the strided grid reproduces the
      dyadic training grid exactly when ``final_steps`` divides T.
    """
    t = schedule.num_timesteps
    ratio = t // final_steps
    if final_steps * ratio != t or ratio < 1 or (ratio & (ratio - 1)):
        raise ValueError(
            f"T={t} -> final_steps={final_steps}: ratio must be a power of 2"
        )

    phase = full_phase(schedule)
    student = teacher_denoiser_params
    # Clipping is load-bearing: near t=T the teacher's first step amplifies
    # its own prediction error by alpha_{T-1}/alpha_T (~1e2-1e3 for the
    # polynomial schedule), so early-phase targets can be large until the
    # student catches up — unclipped Adam diverges on those batches.
    opt = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                      optax.adam(lr))

    while phase.num_steps > final_steps:
        teacher = student
        teacher_phase = phase
        phase = phase.halve()
        opt_state = opt.init(student)

        @jax.jit
        def train_step(params, opt_state, k, batch,
                       _teacher=teacher, _tp=teacher_phase, _sp=phase):
            loss, grads = jax.value_and_grad(distill_loss)(
                params, _teacher, apply_fn, cfg, _tp, _sp, k, batch,
                target_clip=target_clip,
            )
            updates, opt_state = opt.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss

        for epoch in range(epochs_per_phase):
            last = None
            for batch in batches_fn():
                key, sub = jax.random.split(key)
                student, opt_state, last = train_step(
                    student, opt_state, sub, batch
                )
            if epoch % max(1, epochs_per_phase // 5) == 0:
                log_fn(
                    f"phase {teacher_phase.num_steps}->{phase.num_steps} "
                    f"epoch {epoch}: loss {float(last):.3e}"
                )

    return DistillResult(params=student, num_steps=phase.num_steps)
