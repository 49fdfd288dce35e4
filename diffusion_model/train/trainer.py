"""Training engine: optimizer factory, jitted train/eval steps, early stop.

Rebuild of the reference engine (ref parts/train_per_iretation.py:99-262,
parts/def_for_main.py:119-139, main.py:204-216) with the per-batch Python
loops collapsed into one jitted step. The learned gamma schedule trains
through the loss jointly with the denoiser, matching the reference's
optimizer-parameter grouping (ref parts/def_for_main.py:123-130).

Schedule-free RAdam (the reference default, ``schedulefree`` package) maps to
``optax.contrib.schedule_free`` wrapping ``optax.radam``; like the original,
evaluation must use the schedule-free *eval* parameters
(``optax.contrib.schedule_free_eval_params``), mirroring the reference's
``optimizer.train()/.eval()`` calls (ref :104,190).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import optax

from diffusion_model.config import Config
from diffusion_model.data.batch import GraphBatch
from diffusion_model.diffusion.process import (
    Schedule,
    learned_schedule,
    predefined_schedule,
    head_out_to_eps,
    x_param_is_x0,
)
from diffusion_model.nn.denoiser import DiffusionDenoiser
from diffusion_model.nn.gamma import GammaNetwork
from diffusion_model.ops.edges import knn_edges
from diffusion_model.train.loss import (
    diffuse_batch,
    epsilon_loss,
    t_band_weights,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EmaState:
    ema: Any


def _ema_tail(decay: float) -> optax.GradientTransformation:
    """Terminal chain element holding an exponential moving average of the
    *post-update* parameters. Living inside the optimizer state keeps the
    TrainState pytree structure unchanged (old checkpoints restore with the
    same template when EMA is off) and checkpoints the average for free
    when it is on. ``eval_params`` reads it back out."""

    def init_fn(params):
        return EmaState(ema=jax.tree.map(jnp.asarray, params))

    def update_fn(updates, state, params=None):
        new_params = optax.apply_updates(params, updates)
        ema = jax.tree.map(
            lambda e, p: decay * e + (1.0 - decay) * p, state.ema, new_params
        )
        return updates, EmaState(ema=ema)

    return optax.GradientTransformation(init_fn, update_fn)


def make_optimizer(cfg: Config) -> optax.GradientTransformation:
    """Adam / AdamW(amsgrad) / schedule-free RAdam, as in the reference
    (ref parts/def_for_main.py:119-139) plus global-norm clipping
    (``max_grad_norm`` exists in parameters.yaml:17 though the reference
    never wires it up; we do)."""
    if cfg.optimizer == "Adam":
        # torch.optim.Adam(weight_decay=wd) = coupled L2: decay added to
        # the gradient before the moment estimates
        base = optax.adam(cfg.lr)
        if cfg.weight_decay:
            base = optax.chain(
                optax.add_decayed_weights(cfg.weight_decay), base
            )
    elif cfg.optimizer == "AdamW":
        # torch.optim.AdamW(amsgrad=True) = DEcoupled decay: applied after
        # the Adam scaling, before the learning-rate step
        base = optax.chain(
            optax.scale_by_amsgrad(),
            optax.add_decayed_weights(cfg.weight_decay),
            optax.scale_by_learning_rate(cfg.lr),
        )
    elif cfg.optimizer == "RAdamScheduleFree":
        # schedule-free replaces the base optimizer's momentum with its
        # y/z/x interpolation — the base must run with b1=0 (optax's own
        # schedule_free_adamw does the same)
        base = optax.contrib.schedule_free(
            optax.radam(cfg.lr, b1=0.0), learning_rate=cfg.lr
        )
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    parts = [optax.clip_by_global_norm(cfg.max_grad_norm), base]
    if cfg.ema_decay > 0.0:
        if cfg.optimizer == "RAdamScheduleFree":
            # schedule-free already evaluates at its own averaged iterate
            # (the x-sequence); stacking a second average on the online
            # y-iterates evaluates neither sequence — reject rather than
            # silently sample from an unintended parameter family.
            raise ValueError(
                "ema_decay > 0 is redundant with RAdamScheduleFree's "
                "built-in averaging; use optimizer='Adam'/'AdamW' with EMA"
            )
        parts.append(_ema_tail(cfg.ema_decay))
    return optax.chain(*parts)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    opt_state: Any
    step: jnp.ndarray

    def eval_params(self, cfg: Config):
        """Parameters to use for evaluation/sampling.

        For schedule-free optimizers the online params are the *training*
        iterates; evaluation uses the averaged point. With ``ema_decay`` on
        (Adam/AdamW only) evaluation uses the EMA of the post-update
        parameters (standard diffusion practice — DDPM/EDM sample from the
        average, not the last iterate).
        """
        if cfg.ema_decay > 0.0:
            # _ema_tail is always the terminal chain element
            return self.opt_state[-1].ema
        if cfg.optimizer == "RAdamScheduleFree":
            # opt_state = (clip_state, schedule_free_state)
            sf_state = self.opt_state[1]
            return optax.contrib.schedule_free_eval_params(
                sf_state, self.params
            )
        return self.params


class EarlyStopping:
    """Stop when eval loss hasn't improved for ``patience`` epochs
    (ref parts/train_per_iretation.py:19-34)."""

    def __init__(self, patience: int = 0):
        self._step = 0
        self._loss = float("inf")
        self._patience = patience

    def validate(self, loss: float) -> bool:
        if self._loss < loss:
            self._step += 1
            if self._step > self._patience:
                return True
        else:
            self._step = 0
            self._loss = loss
        return False


class Trainer:
    """Owns model/optimizer and exposes jitted train/eval steps."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.model = DiffusionDenoiser(cfg)
        self.gamma = GammaNetwork() if cfg.noise_schedule == "learned" else None
        self.optimizer = make_optimizer(cfg)
        if cfg.debug_nans:
            jax.config.update("jax_debug_nans", True)
        self._static_schedule = (
            predefined_schedule(cfg) if cfg.noise_schedule == "predefined"
            else None
        )
        self._train_step = jax.jit(self._train_step_impl)
        self._eval_step = jax.jit(self._eval_step_impl)

    # -- init -----------------------------------------------------------
    def init_state(self, key, example: GraphBatch,
                   skip_gamma_fit: bool = False) -> TrainState:
        """Fresh TrainState. ``skip_gamma_fit=True`` skips the 6000-step
        gamma_init='polynomial' pre-fit (same tree structure, plain init
        values) — for restore TEMPLATES whose values are immediately
        overwritten by a checkpoint; running the fit there wastes a
        compile + scan on every generate/evaluate invocation."""
        b, n = example.mask.shape
        a = self.cfg.atom_type_size
        k1, k2 = jax.random.split(key)
        if self.cfg.neighbor_k:
            edges = knn_edges(example.pos, example.mask, self.cfg.neighbor_k)
        else:
            edges = example.pair_mask()
        params = {
            "denoiser": self.model.init(
                k1,
                jnp.zeros((b, n, a)), example.pos, example.spectrum,
                example.exo, jnp.zeros((b, n, 1)), example.mask,
                edges,
            )
        }
        if self.gamma is not None:
            if self.cfg.gamma_init == "polynomial" and not skip_gamma_fit:
                from diffusion_model.nn.gamma import (
                    fit_gamma_to_schedule,
                )

                params["gamma"], _ = fit_gamma_to_schedule(
                    self.gamma, predefined_schedule(self.cfg).alphas, k2
                )
            else:
                params["gamma"] = self.gamma.init(k2, jnp.zeros((1, 1)))
        opt_state = self.optimizer.init(params)
        return TrainState(params=params, opt_state=opt_state,
                          step=jnp.zeros((), jnp.int32))

    # -- schedule -------------------------------------------------------
    def schedule_for(self, params) -> Schedule:
        if self._static_schedule is not None:
            return self._static_schedule
        return learned_schedule(
            self.gamma.apply, params["gamma"],
            self.cfg.num_diffusion_timestep,
        )

    def denoise_fn(self, params) -> Callable:
        """Bound denoiser for the sampler (uses eval params upstream)."""
        return lambda *args: self.model.apply(params["denoiser"], *args)

    # -- loss -----------------------------------------------------------
    def _loss(self, params, key, batch: GraphBatch):
        cfg = self.cfg
        schedule = self.schedule_for(params)
        # independent streams: the Kabsch reverse chain and the conditioning
        # dropout must not reuse the key that draws the epsilon targets
        # (sibling splits of a shared key collide with diffuse_batch's
        # internal children)
        k_diff, k_kabsch, k_drop = jax.random.split(key, 3)
        pos_t, h_t, t, eps_pos, eps_h = diffuse_batch(
            schedule, cfg, k_diff, batch
        )
        b, n = batch.mask.shape
        t_norm = (
            t.astype(jnp.float32)[:, None, None]
            / cfg.num_diffusion_timestep
        ) * jnp.ones((b, n, 1))
        t_norm = t_norm * batch.mask[..., None]
        if cfg.neighbor_k:
            edges = knn_edges(pos_t, batch.mask, cfg.neighbor_k)
        else:
            edges = batch.pair_mask()
        spectrum = batch.spectrum
        if cfg.cond_dropout_prob > 0:
            # classifier-free guidance: drop the spectrum conditioning for
            # a random subset of graphs so the unconditional score trains
            keep = jax.random.bernoulli(
                k_drop, 1.0 - cfg.cond_dropout_prob, (batch.batch_size,)
            )
            spectrum = spectrum * keep[:, None, None].astype(spectrum.dtype)
        eps_x_pred, eps_h_pred = self.model.apply(
            params["denoiser"], h_t, pos_t, spectrum, batch.exo,
            t_norm, batch.mask, edges,
        )
        if x_param_is_x0(cfg):
            # x0/v-parameterised coordinate head: convert the output to
            # eps-space and train as usual (see config.py for what each
            # mode's eps-MSE weighs)
            eps_x_pred = head_out_to_eps(cfg, schedule, t, pos_t,
                                         eps_x_pred)
        loss, sum_sq, num_nodes = epsilon_loss(
            eps_x_pred, eps_h_pred, eps_pos, eps_h, batch.mask,
            include_h=cfg.diffuse_species,
            weights=t_band_weights(cfg, t),
        )
        if cfg.kabsch_loss:
            loss = loss + cfg.kabsch_loss_weight * self._kabsch_loss(
                params, k_kabsch, batch, schedule
            )
        if self.gamma is not None and cfg.gamma_boundary_weight > 0:
            loss = loss + cfg.gamma_boundary_weight * self._gamma_boundary(
                schedule, batch
            )
        return loss, (sum_sq, num_nodes)

    def _gamma_boundary(self, schedule, batch: GraphBatch):
        """VDM boundary terms for the learned schedule (Kingma et al. 2021,
        "Variational Diffusion Models", eqs. for the prior KL and the
        reconstruction likelihood; diagonal-Gaussian, discretisation-floored).

        The eps-MSE samples t ~ U{1..T} only, so the trainable endpoints
        (ref SNR.py:33-34) feel no pressure: gamma_0 settles near its init,
        leaving sigma(0) ~ 0.1 — and the t=0 epilogue
        (ref parts/train_per_iretation.py:391-426) then adds sigma_0/alpha_0
        of fresh noise to every final coordinate, wrecking RDF parity
        (measured: rdf_cos 0.53 vs 0.90 predefined). Per real dimension:

          reconstruction ~ 0.5 log((sigma_0^2 + delta^2) / alpha_0^2)
          prior KL       = 0.5 (alpha_T^2 E[x^2] + sigma_T^2 - 1
                                 - log sigma_T^2)

        delta = cfg.gamma_rec_floor is the position discretisation scale:
        the likelihood saturates there instead of diverging, so gamma_0 is
        pushed to sigma_0 ~ delta and no further. Gradients reach only the
        gamma params (the terms involve no denoiser call).

        Both terms are HINGED at their clean-endpoint values: Adam-family
        steps are gradient-scale invariant, so without the hinge even the
        vanishing tail gradient keeps marching the endpoints (measured:
        gamma_1 drifted to 34, alpha = 0 exactly over the top half of the
        chain — 500 dead steps and a squeezed interior). Once sigma_0 <=
        delta / alpha_T KL <= 1e-4 nats/dim the gradient cuts off."""
        cfg = self.cfg
        a0 = schedule.alpha(0)
        a_t = schedule.alpha(cfg.num_diffusion_timestep)
        s0_sq = 1.0 - a0**2
        st_sq = 1.0 - a_t**2
        d2 = cfg.gamma_rec_floor**2
        m3 = batch.mask[..., None]
        dims = 3.0 + (cfg.atom_type_size if cfg.diffuse_species else 0.0)
        n_dims = jnp.sum(batch.mask) * dims
        x2_sum = jnp.sum((batch.pos**2) * m3)
        if cfg.diffuse_species:
            x2_sum = x2_sum + jnp.sum((batch.species**2) * m3)
        rec = jnp.maximum(
            0.5 * jnp.log((s0_sq + d2) / a0**2),
            0.5 * jnp.log(2.0 * d2),  # value at sigma_0 = delta
        )
        prior = jnp.maximum(
            0.5 * (
                a_t**2 * (x2_sum / jnp.maximum(n_dims, 1.0))
                + st_sq - 1.0 - jnp.log(st_sq)
            ),
            1e-4,
        )
        num_graphs = jnp.maximum(
            jnp.sum(jnp.any(batch.mask > 0, axis=-1).astype(x2_sum.dtype)),
            1.0,
        )
        # same normalisation as the eps loss: per-dim terms summed over all
        # real dims, divided by the number of graphs
        return (rec + prior) * n_dims / num_graphs

    def _kabsch_loss(self, params, key, batch: GraphBatch, schedule):
        """Coordinate loss: differentiate through the full reverse chain and
        score the generated positions with Kabsch RMSD against ground truth
        (ref train_2024_11.py:204-237: loss = loss_noise + loss_coords).
        The scan body is rematerialised so the T-step chain doesn't hold all
        activations."""
        from jax import checkpoint as remat

        from diffusion_model.diffusion.sampler import sample
        from diffusion_model.ops.kabsch import kabsch_rmsd

        cfg = self.cfg
        steps = cfg.kabsch_loss_steps or cfg.num_diffusion_timestep
        # Let the sampler do its own striding (sample_steps=steps): its
        # round(linspace) grid and t_norm_table = idx/T keep the
        # (alpha_t, t_norm) pairs consistent with training for ANY step
        # count — a hand-rolled truncated-linspace subsample here fed the
        # denoiser t_norm = k/steps, which diverges from idx[k]/T whenever
        # steps does not divide T (identical when it does).
        sub_cfg = cfg.replace(sample_steps=steps, sample_grid="uniform")

        denoise_fn = remat(
            lambda *args: self.model.apply(params["denoiser"], *args)
        )
        res = sample(denoise_fn, schedule, sub_cfg, key, batch)
        # Zero-mask padded batch rows would hand the SVD a zero covariance
        # (NaN gradients through the degenerate decomposition) — substitute
        # a fixed well-conditioned point template for padded graphs and
        # average the RMSD over real graphs only.
        real = jnp.any(batch.mask > 0, axis=-1)
        n = batch.pos.shape[1]
        t = jnp.arange(n, dtype=batch.pos.dtype)
        template = jnp.stack(
            [jnp.sin(t), jnp.cos(1.3 * t), jnp.sin(2.7 * t + 1.0)], axis=-1
        )
        r3 = real[:, None, None]
        gen_pos = jnp.where(r3, res.pos, 1.5 * template + 1.0)
        ref_pos = jnp.where(r3, batch.pos, template)
        mask_safe = jnp.where(real[:, None], batch.mask,
                              jnp.ones_like(batch.mask))
        rmsd = kabsch_rmsd(gen_pos, ref_pos, mask_safe)
        total = jnp.sum(jnp.where(real, rmsd, 0.0))
        return total / jnp.maximum(jnp.sum(real.astype(rmsd.dtype)), 1.0)

    # -- ring (node-sharded) training ----------------------------------
    def ring_train_step_fn(self, mesh, axis: str = "data") -> Callable:
        """Jitted training step through the ring-sharded topology
        (parallel/ring.py) for ONE large cell per step (batch of 1 graph
        whose node axis is sharded over ``axis``).

        This is the SP-analogue training path (SURVEY.md §2.6): when a
        cell's dense pair grid exceeds one chip, gradients flow through the
        hand-scheduled ppermute ring — ``shard_map`` is differentiable, so
        the parameter cotangents are psum-reduced across the mesh exactly
        like DP gradients. Loss/normalisation semantics are identical to
        ``train_step`` (same ``diffuse_batch`` + ``epsilon_loss``); only
        the denoiser forward is routed through the ring.

        Returns ``step(state, key, batch) -> (state, metrics)``.
        """
        if self.cfg.kabsch_loss:
            # the kabsch variant differentiates through the FULL T-step
            # reverse chain per train step (ref train_2024_11.py:204-237)
            # — a small-cluster (<=10 atom) objective; at ring scale
            # (512+-atom cells) that is 1000 sharded EGNN forwards per
            # optimizer step. Silently skipping the coordinate loss would
            # train the wrong objective, so reject loudly.
            raise NotImplementedError(
                "kabsch_loss is not routed through the ring (full-chain "
                "reverse diffusion per step is a small-cluster objective; "
                "use the dense path for <=10-atom kabsch training)"
            )
        from diffusion_model.parallel.ring import ring_denoise_apply

        cfg = self.cfg
        apply_fn = ring_denoise_apply(cfg, mesh, axis)

        def loss_fn(params, key, batch: GraphBatch):
            if batch.mask.shape[0] != 1:
                # one ring = one graph; with B > 1 the single ring
                # prediction would broadcast against every graph's noise
                # targets in epsilon_loss — silently wrong gradients
                raise ValueError(
                    "ring training takes exactly one node-sharded graph "
                    f"per step (got batch_size={batch.mask.shape[0]})"
                )
            # learned schedule: gamma is tiny and runs replicated outside
            # shard_map; its params get gradients through diffuse_batch
            # and the boundary terms exactly like the dense path
            schedule = self.schedule_for(params)
            # same stream layout as _loss so ring and dense train steps
            # draw identical noise from the same key (parity-testable)
            k_diff, _, k_drop = jax.random.split(key, 3)
            pos_t, h_t, t, eps_pos, eps_h = diffuse_batch(
                schedule, cfg, k_diff, batch
            )
            b, n = batch.mask.shape
            t_norm = (
                t.astype(jnp.float32)[:, None, None]
                / cfg.num_diffusion_timestep
            ) * jnp.ones((b, n, 1)) * batch.mask[..., None]
            spectrum = batch.spectrum
            if cfg.cond_dropout_prob > 0:
                # classifier-free guidance: same bernoulli stream as the
                # dense loss — the single resident graph drops its
                # conditioning with prob p so the unconditional score trains
                keep = jax.random.bernoulli(
                    k_drop, 1.0 - cfg.cond_dropout_prob,
                    (batch.batch_size,),
                )
                spectrum = spectrum * keep[:, None, None].astype(
                    spectrum.dtype)
            eps_x_pred, eps_h_pred = apply_fn(
                params["denoiser"], h_t[0], pos_t[0], spectrum[0],
                batch.exo[0], t_norm[0], batch.mask[0],
            )
            if x_param_is_x0(cfg):
                # same eps-space conversion as the dense loss, on the
                # single resident graph (t[0] is its timestep)
                eps_x_pred = head_out_to_eps(
                    cfg, schedule, t[0], pos_t[0], eps_x_pred
                )
            loss, sum_sq, num_nodes = epsilon_loss(
                eps_x_pred[None], eps_h_pred[None], eps_pos, eps_h,
                batch.mask, include_h=cfg.diffuse_species,
                weights=t_band_weights(cfg, t),
            )
            if self.gamma is not None and cfg.gamma_boundary_weight > 0:
                loss = loss + cfg.gamma_boundary_weight * \
                    self._gamma_boundary(schedule, batch)
            return loss, (sum_sq, num_nodes)

        def step(state: TrainState, key, batch: GraphBatch):
            (loss, (sum_sq, num_nodes)), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(state.params, key, batch)
            updates, opt_state = self.optimizer.update(
                grads, state.opt_state, state.params
            )
            params = optax.apply_updates(state.params, updates)
            new_state = TrainState(
                params=params, opt_state=opt_state, step=state.step + 1
            )
            metrics = {
                "loss": loss,
                "sum_sq": sum_sq,
                "num_nodes": num_nodes,
                "grad_norm": optax.global_norm(grads),
            }
            return new_state, metrics

        return jax.jit(step)

    # -- steps ----------------------------------------------------------
    def _train_step_impl(self, state: TrainState, key, batch: GraphBatch):
        (loss, (sum_sq, num_nodes)), grads = jax.value_and_grad(
            self._loss, has_aux=True
        )(state.params, key, batch)
        updates, opt_state = self.optimizer.update(
            grads, state.opt_state, state.params
        )
        params = optax.apply_updates(state.params, updates)
        new_state = TrainState(
            params=params, opt_state=opt_state, step=state.step + 1
        )
        metrics = {
            "loss": loss,
            "sum_sq": sum_sq,
            "num_nodes": num_nodes,
            "grad_norm": optax.global_norm(grads),
        }
        return new_state, metrics

    def _eval_step_impl(self, params, key, batch: GraphBatch):
        _, (sum_sq, num_nodes) = self._loss(params, key, batch)
        return {"sum_sq": sum_sq, "num_nodes": num_nodes}

    def train_step(self, state, key, batch):
        return self._train_step(state, key, batch)

    def eval_step(self, state: TrainState, key, batch):
        # Uses schedule-free eval params like the reference's optimizer.eval()
        return self._eval_step(state.eval_params(self.cfg), key, batch)

    # -- epoch loops (host-side, mirror main.py:206-216) ---------------
    def _place(self, batch, mesh):
        if mesh is None:
            return batch
        from diffusion_model.parallel import shard_graph_batch

        return shard_graph_batch(batch, mesh, mode="dp")

    def train_epoch(self, state, key, batches, mesh=None) -> tuple:
        """One pass over ``batches``; with ``mesh`` the graph-batch axis is
        sharded over the ``data`` axis (params replicated by the caller or
        on first step by GSPMD). Metric accumulation stays on device so
        step dispatch never blocks on a host sync (one transfer per epoch,
        not per batch)."""
        total_sq = jnp.zeros(())
        total_nodes = jnp.zeros(())
        for batch in batches:
            key, sub = jax.random.split(key)
            state, m = self.train_step(state, sub, self._place(batch, mesh))
            total_sq = total_sq + m["sum_sq"]
            total_nodes = total_nodes + m["num_nodes"]
        return state, float(total_sq) / max(float(total_nodes), 1.0)

    def eval_epoch(self, state, key, batches, mesh=None) -> float:
        total_sq = jnp.zeros(())
        total_nodes = jnp.zeros(())
        params = state.eval_params(self.cfg)
        for batch in batches:
            key, sub = jax.random.split(key)
            m = self._eval_step(params, sub, self._place(batch, mesh))
            total_sq = total_sq + m["sum_sq"]
            total_nodes = total_nodes + m["num_nodes"]
        return float(total_sq) / max(float(total_nodes), 1.0)
