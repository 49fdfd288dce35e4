"""Joint (x, h) diffusion process — forward noising and reverse denoising.

Functional, batched, masked rebuild of the reference ``E3DiffusionProcess``
(ref diffusion_x_h.py:16-106, the variant ``main.py:185`` actually ships).
The reference mutates per-graph tensors in Python; here every step is a pure
function over padded batches with per-graph integer timesteps, suitable for
``lax.scan``/``vmap``/``pjit``.

Conventions (matching the reference exactly):
  * ``alphas[t]`` for t = 0..T is used directly as alpha_t, and
    sigma_t = sqrt(1 - alpha_t^2)  (ref diffusion_x_h.py:25-26,36-46).
  * forward:  z_t = alpha_t z_0 + sigma_t eps, eps CoM-free for positions
    (ref :51-59).
  * posterior mean: mu = z/alpha_ts - sigma2_ts * eps / (alpha_ts * sigma_t)
    with alpha_ts = alpha_t/alpha_s, s = t-1 (ref :61-73).
  * reverse:  z_s = mu + sqrt(sigma2_ts * sigma2_s / sigma2_t) * eps',
    eps' CoM-free for positions (ref :75-90).
  * learned schedule: alpha_t = sqrt(sigmoid(-gamma(t/T))),
    sigma_t = sqrt(sigmoid(gamma(t/T)))  (ref :36-46) — note this also
    satisfies sigma = sqrt(1 - alpha^2), so one alphas table covers both.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from diffusion_model.config import Config
from diffusion_model.ops.com import remove_mean
from diffusion_model.ops.schedules import polynomial_alpha_schedule


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Schedule:
    """Noise schedule table: ``alphas[t]`` for t = 0..T (length T+1)."""

    alphas: jnp.ndarray

    @property
    def num_timesteps(self) -> int:
        return self.alphas.shape[0] - 1

    def alpha(self, t):
        return self.alphas[t]

    def sigma(self, t):
        return jnp.sqrt(1.0 - self.alphas[t] ** 2)


def predefined_schedule(cfg: Config) -> Schedule:
    """Polynomial schedule from config (ref diffusion_x_h.py:20-26)."""
    alphas = polynomial_alpha_schedule(
        cfg.num_diffusion_timestep,
        s=cfg.noise_precision,
        power=cfg.noise_schedule_power,
    )
    return Schedule(alphas=alphas)


def learned_schedule(gamma_apply, gamma_params, num_timesteps: int) -> Schedule:
    """Schedule from a GammaNetwork: alpha_t = sqrt(sigmoid(-gamma(t/T))).

    Differentiable w.r.t. ``gamma_params`` so the gamma net trains through
    the diffusion loss (ref diffusion_x_h.py:27-46).
    """
    t_grid = jnp.linspace(0.0, 1.0, num_timesteps + 1)[:, None]
    gamma = gamma_apply(gamma_params, t_grid)[:, 0]
    alphas = jnp.sqrt(jax.nn.sigmoid(-gamma))
    return Schedule(alphas=alphas)


def _bcast(coef, z):
    """Broadcast per-graph scalars ``[B]`` (or scalar) over node/feature axes."""
    coef = jnp.asarray(coef)
    while coef.ndim < z.ndim:
        coef = coef[..., None]
    return coef.astype(z.dtype)


def _noise_like(key, z, mode: str, mask):
    """Standard normal noise; CoM-projected for positions, padded rows zeroed."""
    eps = jax.random.normal(key, z.shape, z.dtype)
    if mode == "pos":
        eps = remove_mean(eps, mask)
    elif mask is not None:
        eps = eps * jnp.expand_dims(mask.astype(z.dtype), -1)
    return eps


def diffuse_zero_to_t(schedule: Schedule, key, z, t, mode: str = "pos",
                      mask=None):
    """Forward-noise clean data to time t (ref diffusion_x_h.py:51-59).

    Args:
      z: ``[B, N, D]`` clean values.
      t: integer timestep(s), scalar or ``[B]``.

    Returns:
      (z_t, eps) with eps the exact noise realisation (the training target).
    """
    eps = _noise_like(key, z, mode, mask)
    alpha_t = _bcast(schedule.alpha(t), z)
    sigma_t = _bcast(schedule.sigma(t), z)
    return alpha_t * z + sigma_t * eps, eps


def x_param_is_x0(cfg) -> bool:
    """True iff the coordinate head needs an eps-space conversion.

    Validated read of ``cfg.x_parameterization`` (see config.py). The
    name predates the "v" mode; it answers "non-eps?" — dispatch between
    the conversions happens in :func:`head_out_to_eps`.
    """
    if cfg.x_parameterization not in ("eps", "x0", "v"):
        raise ValueError(
            f"x_parameterization={cfg.x_parameterization!r} "
            "must be 'eps', 'x0' or 'v'"
        )
    return cfg.x_parameterization != "eps"


def x0_out_to_eps(schedule: Schedule, t, z, out):
    """Read an x0-parameterised coordinate head as an epsilon prediction.

    With ``x_parameterization="x0"`` the network's equivariant coordinate
    output points at the clean structure: ``x0_hat = z_t + out``. Every
    consumer (loss, sampler, t=0 epilogue) still runs on epsilon, so
    convert::

        eps_hat = (z_t - alpha_t x0_hat) / sigma_t
                = ((1 - alpha_t)/sigma_t) z_t - (alpha_t/sigma_t) out

    The coefficients are formed in the schedule's f32 before casting to
    the compute dtype: ``1 - alpha_t`` underflows to 0 in bf16 at low t
    (alpha ~ 1 - 1e-5), which would silently drop the z-term. Padded rows
    stay zero (both z and out are masked) and CoM-freeness is preserved
    (the output is a linear combination of two CoM-free fields), so the
    subtracted-CoM diffusion math is untouched. Identity check: feeding
    the oracle ``out = x0 - z_t`` returns the exact forward noise eps.
    """
    alpha_t = schedule.alpha(t)
    sigma_t = schedule.sigma(t)
    coef_z = (1.0 - alpha_t) / sigma_t
    coef_out = alpha_t / sigma_t
    return _bcast(coef_z, z) * z - _bcast(coef_out, out) * out


def v_out_to_eps(schedule: Schedule, t, z, out):
    """Read a v-parameterised coordinate head as an epsilon prediction.

    ``v = alpha_t eps - sigma_t x0`` (Salimans & Ho 2022, "Progressive
    Distillation for Fast Sampling of Diffusion Models", eq. 11 — public
    technique, PAPERS.md): the canonical t-interpolation between the eps
    head (which dominates at low noise) and the x0 head (which dominates
    at high noise). With ``z_t = alpha_t x0 + sigma_t eps``::

        eps_hat = alpha_t out + sigma_t z_t

    (substitute and use alpha^2 + sigma^2 = 1). Both coefficients are
    bounded by 1 for every t — unlike "x0", whose alpha/sigma factor
    amplifies low-t errors — so the conversion is perfectly conditioned
    across the whole chain. CoM-freeness and padded-row inertness are
    preserved (linear combination of two CoM-free masked fields).
    Identity check: feeding the oracle ``out = alpha eps - sigma x0``
    returns the exact forward noise eps.
    """
    alpha_t = schedule.alpha(t)
    sigma_t = schedule.sigma(t)
    return _bcast(alpha_t, out) * out + _bcast(sigma_t, z) * z


def head_out_to_eps(cfg, schedule: Schedule, t, z, out):
    """Dispatch the coordinate-head conversion for non-eps modes."""
    if cfg.x_parameterization == "x0":
        return x0_out_to_eps(schedule, t, z, out)
    if cfg.x_parameterization == "v":
        return v_out_to_eps(schedule, t, z, out)
    raise ValueError(
        f"no conversion for x_parameterization={cfg.x_parameterization!r}"
    )


def calculate_mu(schedule: Schedule, z, eps, t):
    """Posterior mean for the t -> t-1 step (ref diffusion_x_h.py:61-73)."""
    alpha_t = schedule.alpha(t)
    alpha_s = schedule.alpha(t - 1)
    sq_sigma_t = 1.0 - alpha_t**2
    sigma_t = jnp.sqrt(sq_sigma_t)
    sq_sigma_s = 1.0 - alpha_s**2
    alpha_ts = alpha_t / alpha_s
    sq_sigma_ts = sq_sigma_t - alpha_ts**2 * sq_sigma_s
    mu = z / _bcast(alpha_ts, z) - _bcast(
        sq_sigma_ts / (alpha_ts * sigma_t), z
    ) * eps
    return mu


def reverse_diffuse_one_step(schedule: Schedule, key, z, eps, t,
                             mode: str = "pos", mask=None,
                             deterministic: bool = False,
                             noise_scale: float = 1.0):
    """One ancestral reverse step z_t -> z_{t-1} (ref diffusion_x_h.py:75-90).

    ``deterministic=True`` drops the noise term (DDIM eta=0): the step
    reduces to the posterior mean. ``noise_scale`` (sampling temperature)
    multiplies the posterior std of the injected noise: 1.0 is the exact
    ancestral chain (reference), 0.0 coincides with ``deterministic``.
    """
    mu = calculate_mu(schedule, z, eps, t)
    if deterministic or noise_scale == 0.0:
        out = mu
    else:
        alpha_t = schedule.alpha(t)
        alpha_s = schedule.alpha(t - 1)
        sq_sigma_t = 1.0 - alpha_t**2
        sq_sigma_s = 1.0 - alpha_s**2
        alpha_ts = alpha_t / alpha_s
        sq_sigma_ts = sq_sigma_t - alpha_ts**2 * sq_sigma_s
        # Learned schedules can be near-flat between adjacent steps, where
        # sq_sigma_ts is a catastrophic cancellation of two ~equal tiny
        # numbers and rounds negative — clamp before the sqrt (a flat
        # segment's posterior noise is genuinely zero).
        std = jnp.sqrt(jnp.maximum(sq_sigma_ts, 0.0)
                       * sq_sigma_s / sq_sigma_t)
        noise = _noise_like(key, z, mode, mask)
        out = mu + noise_scale * _bcast(std, z) * noise
    if mask is not None:
        out = out * jnp.expand_dims(mask.astype(z.dtype), -1)
    return out


def final_denoise_step(schedule: Schedule, key, z, eps, mode: str = "pos",
                       mask=None, deterministic: bool = False,
                       noise_scale: float = 1.0):
    """The explicit t=0 epilogue (ref parts/train_per_iretation.py:391-426):

        mu = z/alpha_0 - sigma_0 * eps / alpha_0
        z' = mu + (sigma_0/alpha_0) * noise   (noise dropped when
                                               ``deterministic``, scaled by
                                               ``noise_scale`` otherwise)
    """
    alpha_0 = schedule.alpha(0)
    sigma_0 = schedule.sigma(0)
    mu = z / _bcast(alpha_0, z) - _bcast(sigma_0 / alpha_0, z) * eps
    if deterministic or noise_scale == 0.0:
        out = mu
    else:
        noise = _noise_like(key, z, mode, mask)
        out = mu + noise_scale * _bcast(sigma_0 / alpha_0, z) * noise
    if mask is not None:
        out = out * jnp.expand_dims(mask.astype(z.dtype), -1)
    return out
