"""VDM learned monotone noise schedule (gamma network).

Equivalent of the reference ``GammaNetwork``/``PositiveLinear``
(ref SNR.py:5-65): gamma_tilde(t) = l1(t) + l3(sigmoid(l2(l1(t)))) with
softplus-positive weights (monotone in t), normalised to [0, 1] over the
unit interval and rescaled to trainable endpoints gamma_0=-5, gamma_1=10.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import optax

from diffusion_model.nn.dense import subkey


@dataclasses.dataclass(frozen=True)
class PositiveLinear:
    """Linear layer with softplus-positive weights and no bias.

    Ref SNR.py:5-22: weights are kaiming-uniform initialised then shifted by
    ``param_init_offset`` (=-2) so softplus(weight) starts small.
    """

    features: int
    param_init_offset: float = -2.0

    def init_params(self, key, in_features: int) -> dict:
        # kaiming_uniform(a=sqrt(5)) over fan_in, as torch does for
        # nn.Linear weights, then the constant offset.
        gain = jnp.sqrt(2.0 / (1.0 + 5.0))  # a = sqrt(5)
        bound = gain * jnp.sqrt(3.0 / in_features)
        w = jax.random.uniform(key, (self.features, in_features),
                               jnp.float32, -bound, bound)
        return {"weight": w + self.param_init_offset}

    def init(self, key, x) -> dict:
        return {"params": self.init_params(key, x.shape[-1])}

    def apply(self, variables, x: jnp.ndarray) -> jnp.ndarray:
        return positive_linear(variables["params"], x)


def positive_linear(p, x):
    return x @ jax.nn.softplus(p["weight"]).T


@dataclasses.dataclass(frozen=True)
class GammaNetwork:
    """Monotone gamma(t) on t in [0, 1] (ref SNR.py:27-65).

    The trainable endpoints are stored PRE-SCALED by ``endpoint_scale``:
    Adam-family optimizers move every parameter ~lr per step regardless of
    gradient magnitude, so at lr=2e-4 a raw gamma_0 could traverse only
    ~±2 over a full 3000-epoch run — not enough to reach the clean-endpoint
    region (gamma_0 ~ -9 for sigma_0 ~ 1e-2) that the VDM boundary terms
    (train/trainer.py) ask for. Scaling the stored parameter multiplies the
    per-step endpoint movement without touching the loss surface shape.

    Checkpoint-format note: this reparameterisation changed the meaning of
    the stored ``gamma_0``/``gamma_1`` arrays. Checkpoints stamp the scale
    they were written under (``gamma_endpoint_scale`` in the saved config)
    and ``train.checkpoint.restore_checkpoint`` rescales mismatched
    endpoints on load (unstamped = pre-reparameterisation raw endpoints,
    scale 1.0), so old learned-schedule checkpoints restore to the same
    semantic schedule.
    """

    hidden: int = 1024
    endpoint_scale: float = 25.0

    def init(self, key, t) -> dict:
        s = self.endpoint_scale
        return {"params": {
            "l1": PositiveLinear(1).init_params(subkey(key, "l1"),
                                                t.shape[-1]),
            "l2": PositiveLinear(self.hidden).init_params(
                subkey(key, "l2"), 1),
            "l3": PositiveLinear(1).init_params(subkey(key, "l3"),
                                                self.hidden),
            "gamma_0": jnp.asarray([-5.0 / s]),
            "gamma_1": jnp.asarray([10.0 / s]),
        }}

    @staticmethod
    def _gamma_tilde(p, t: jnp.ndarray) -> jnp.ndarray:
        l1_t = positive_linear(p["l1"], t)
        return l1_t + positive_linear(
            p["l3"], jax.nn.sigmoid(positive_linear(p["l2"], l1_t)))

    def apply(self, variables, t: jnp.ndarray) -> jnp.ndarray:
        """t: ``[..., 1]`` in [0, 1] -> gamma ``[..., 1]``."""
        p = variables["params"]
        g0 = self._gamma_tilde(p, jnp.zeros_like(t))
        g1 = self._gamma_tilde(p, jnp.ones_like(t))
        gt = self._gamma_tilde(p, t)
        normalized = (gt - g0) / (g1 - g0)
        gamma_0 = p["gamma_0"] * self.endpoint_scale
        gamma_1 = p["gamma_1"] * self.endpoint_scale
        return gamma_0 + (gamma_1 - gamma_0) * normalized


def fit_gamma_to_schedule(gamma: GammaNetwork, alphas: jnp.ndarray,
                          key, steps: int = 6000, lr: float = 1e-2):
    """Regress a GammaNetwork onto a target alpha table in ALPHA^2 space.

    Used by ``Trainer`` for ``cfg.gamma_init="polynomial"``: starting the
    learned schedule at (the best in-family approximation of) the
    polynomial schedule instead of the VDM default (-5, 10) endpoints
    improves final RDF quality (0.861/0.928 vs 0.829/0.900 on the
    flagship pair, docs/quality/learned_origin_test.json) even though the
    eps-MSE objective then migrates the schedule away — the default init
    lands in a worse basin. The fit is in alpha^2 = sigmoid(-gamma) space
    because training only consumes alpha: gamma's log tails saturate, and
    the reference's bias-free PositiveLinear family (ref SNR.py:5-22)
    cannot represent the polynomial deep-noise tail in gamma space at all
    (its sigmoid ramps are all anchored at t = 0).

    One compiled ``lax.scan``. Returns ``(params, max_alpha2_err)``.
    """
    a2_target = alphas.astype(jnp.float32) ** 2
    t_grid = jnp.linspace(0.0, 1.0, alphas.shape[0])[:, None]
    params = gamma.init(key, jnp.zeros((1, 1)))
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps))

    def loss_fn(p):
        a2 = jax.nn.sigmoid(-gamma.apply(p, t_grid)[:, 0])
        err = a2 - a2_target
        return jnp.mean(err**2) + 50.0 * jnp.mean(err**4)

    def step(carry, _):
        p, opt_state = carry
        grads = jax.grad(loss_fn)(p)
        updates, opt_state = opt.update(grads, opt_state)
        return (optax.apply_updates(p, updates), opt_state), ()

    (params, _), _ = jax.lax.scan(
        step, (params, opt.init(params)), None, length=steps
    )
    a2 = jax.nn.sigmoid(-gamma.apply(params, t_grid)[:, 0])
    return params, jnp.max(jnp.abs(a2 - a2_target))
