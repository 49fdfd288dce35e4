"""Training engine tests: loss mechanics, optimizers, end-to-end learning,
checkpoint roundtrip, early stopping."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffusion_model.config import Config
from diffusion_model.data.split import batch_iterator, split_dataset
from diffusion_model.data.synthetic import synthetic_sio2_dataset
from diffusion_model.diffusion import predefined_schedule
from diffusion_model.train import (
    EarlyStopping,
    Trainer,
    diffuse_batch,
    epsilon_loss,
    make_optimizer,
    restore_checkpoint,
    save_checkpoint,
)


def tiny_cfg(**kw):
    base = dict(
        n_max=8, L=2, m_hidden_size=32, h_hidden_size=32, x_hidden_size=32,
        m_size=16, spectrum_size=32, compressed_spectrum_size=8,
        compressor_hidden_dim=(16,), num_diffusion_timestep=50,
        batch_size=4, lr=1e-3, optimizer="Adam",
    )
    base.update(kw)
    return Config(**base)


def make_batches(cfg, num=16, seed=0):
    data = synthetic_sio2_dataset(seed, num, cfg.n_max,
                                  spectrum_size=cfg.spectrum_size)
    return list(batch_iterator(data, cfg.batch_size, cfg.n_max, seed=1))


class TestLossMechanics:
    def test_diffuse_batch_shapes_and_com(self, rng):
        cfg = tiny_cfg()
        batches = make_batches(cfg, num=4)
        b = batches[0]
        s = predefined_schedule(cfg)
        pos_t, h_t, t, eps_pos, eps_h = diffuse_batch(
            s, cfg, jax.random.key(0), b
        )
        assert pos_t.shape == b.pos.shape
        assert h_t.shape == b.species.shape
        assert t.shape == (cfg.batch_size,)
        assert np.asarray(t).min() >= 1
        assert np.asarray(t).max() <= cfg.num_diffusion_timestep
        for g in range(cfg.batch_size):
            m = np.asarray(b.mask[g]) > 0
            np.testing.assert_allclose(
                np.asarray(eps_pos[g])[m].mean(0), 0, atol=1e-5
            )

    def test_t_bias_band_validated_against_T(self):
        """A band outside [1, T] must raise instead of silently clamping
        the noise level while feeding t/T > 1 to the denoiser."""
        cfg = tiny_cfg(t_bias_frac=0.5)  # defaults lo=100, hi=600; T=50
        batches = make_batches(cfg, num=4)
        s = predefined_schedule(cfg)
        with pytest.raises(ValueError, match="t_bias band"):
            diffuse_batch(s, cfg, jax.random.key(0), batches[0])
        ok = tiny_cfg(t_bias_frac=0.5, t_bias_lo=10, t_bias_hi=40)
        diffuse_batch(s, ok, jax.random.key(0), batches[0])

    def test_t_bias_band_sampling(self):
        """config.t_bias_frac: opt-in mid-band timestep oversampling.

        frac=0 must reproduce the reference-exact uniform draw bit-for-bit
        (same key path); frac=1 confines every t to [t_bias_lo, t_bias_hi];
        fractional values mix."""
        cfg = tiny_cfg()
        batches = make_batches(cfg, num=4)
        b = batches[0]
        s = predefined_schedule(cfg)
        _, _, t_plain, _, _ = diffuse_batch(s, cfg, jax.random.key(0), b)
        cfg0 = tiny_cfg(t_bias_frac=0.0, t_bias_lo=10, t_bias_hi=20)
        _, _, t0, _, _ = diffuse_batch(s, cfg0, jax.random.key(0), b)
        np.testing.assert_array_equal(np.asarray(t_plain), np.asarray(t0))

        cfg1 = tiny_cfg(t_bias_frac=1.0, t_bias_lo=10, t_bias_hi=20)
        draws = []
        for i in range(16):
            _, _, t1, _, _ = diffuse_batch(s, cfg1, jax.random.key(i), b)
            draws.append(np.asarray(t1))
        draws = np.concatenate(draws)
        assert draws.min() >= 10 and draws.max() <= 20

        cfg_half = tiny_cfg(t_bias_frac=0.5, t_bias_lo=10, t_bias_hi=20)
        draws = []
        for i in range(64):
            _, _, th, _, _ = diffuse_batch(s, cfg_half, jax.random.key(i), b)
            draws.append(np.asarray(th))
        draws = np.concatenate(draws)
        in_band = ((draws >= 10) & (draws <= 20)).mean()
        # 50% forced into the band + ~22% of the uniform arm lands there
        assert 0.45 < in_band < 0.8

    def test_epsilon_loss_normalisation(self):
        mask = jnp.asarray([[1.0, 1, 0], [1, 0, 0]])
        ex_p = jnp.ones((2, 3, 3))
        eh_p = jnp.ones((2, 3, 2))
        ex = jnp.zeros((2, 3, 3))
        eh = jnp.zeros((2, 3, 2))
        loss, sum_sq, nodes = epsilon_loss(ex_p, eh_p, ex, eh, mask)
        # 3 real nodes * (3 + 2) unit errors = 15; graphs = 2
        assert float(sum_sq) == pytest.approx(15.0)
        assert float(loss) == pytest.approx(7.5)
        assert float(nodes) == pytest.approx(3.0)


class TestOptimizers:
    @pytest.mark.parametrize("opt", ["Adam", "AdamW", "RAdamScheduleFree"])
    @pytest.mark.slow
    def test_step_changes_params(self, opt):
        cfg = tiny_cfg(optimizer=opt)
        trainer = Trainer(cfg)
        batches = make_batches(cfg, num=4)
        state = trainer.init_state(jax.random.key(0), batches[0])
        new_state, metrics = trainer.train_step(
            state, jax.random.key(1), batches[0]
        )
        assert float(metrics["loss"]) > 0
        leaves0 = jax.tree.leaves(state.params)
        leaves1 = jax.tree.leaves(new_state.params)
        assert any(
            not np.allclose(np.asarray(a), np.asarray(b))
            for a, b in zip(leaves0, leaves1)
        )
        # eval params resolve for every optimizer
        _ = new_state.eval_params(cfg)


class TestEma:
    def test_ema_matches_manual_recursion(self):
        """opt_state's terminal EmaState tracks decay*e + (1-decay)*p of
        the post-update params; eval_params returns it."""
        decay = 0.9
        cfg = tiny_cfg(ema_decay=decay)
        trainer = Trainer(cfg)
        batches = make_batches(cfg, num=4)
        state = trainer.init_state(jax.random.key(0), batches[0])
        manual = jax.tree.map(jnp.asarray, state.params)
        key = jax.random.key(1)
        for _ in range(3):
            key, sub = jax.random.split(key)
            state, _ = trainer.train_step(state, sub, batches[0])
            manual = jax.tree.map(
                lambda e, p: decay * e + (1 - decay) * p,
                manual, state.params,
            )
        got = state.eval_params(cfg)
        for a, b in zip(jax.tree.leaves(manual), jax.tree.leaves(got)):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7
            )
        # the EMA lags the online iterate (it is a different point)
        assert any(
            not np.allclose(np.asarray(a), np.asarray(b))
            for a, b in zip(jax.tree.leaves(got),
                            jax.tree.leaves(state.params))
        )

    def test_ema_off_is_identity(self):
        cfg = tiny_cfg()
        trainer = Trainer(cfg)
        batches = make_batches(cfg, num=4)
        state = trainer.init_state(jax.random.key(0), batches[0])
        state, _ = trainer.train_step(state, jax.random.key(1), batches[0])
        got = state.eval_params(cfg)
        assert got is state.params

    def test_ema_rejected_with_schedule_free(self):
        with pytest.raises(ValueError, match="ema_decay"):
            Trainer(tiny_cfg(optimizer="RAdamScheduleFree", ema_decay=0.99))

    def test_ema_checkpoint_roundtrip(self, tmp_path):
        """The EMA average lives in opt_state, so a checkpoint carries it
        and a resumed run keeps evaluating from the same average."""
        cfg = tiny_cfg(ema_decay=0.95)
        trainer = Trainer(cfg)
        batches = make_batches(cfg, num=4)
        state = trainer.init_state(jax.random.key(0), batches[0])
        state, _ = trainer.train_step(state, jax.random.key(1), batches[0])
        save_checkpoint(str(tmp_path / "ck"), state, cfg, step=1)
        template = trainer.init_state(jax.random.key(0), batches[0])
        restored, rcfg = restore_checkpoint(str(tmp_path / "ck"), template)
        assert rcfg.ema_decay == cfg.ema_decay
        for a, b in zip(
            jax.tree.leaves(state.eval_params(cfg)),
            jax.tree.leaves(restored.eval_params(rcfg)),
        ):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b))


class TestEndToEnd:
    @pytest.mark.slow
    def test_loss_decreases(self):
        cfg = tiny_cfg()
        trainer = Trainer(cfg)
        data = synthetic_sio2_dataset(7, 24, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        train, val, test = split_dataset(data, seed=cfg.seed)
        assert len(train) == 19 and len(val) == 2 and len(test) == 3
        batches = list(
            batch_iterator(train, cfg.batch_size, cfg.n_max, seed=2)
        )
        state = trainer.init_state(jax.random.key(0), batches[0])
        key = jax.random.key(3)
        state, first = trainer.train_epoch(state, key, batches)
        losses = [first]
        for e in range(15):
            key, sub = jax.random.split(key)
            state, l = trainer.train_epoch(state, sub, batches)
            losses.append(l)
        assert losses[-1] < 0.7 * losses[0], losses

    @pytest.mark.slow
    def test_learned_schedule_trains_gamma(self):
        cfg = tiny_cfg(noise_schedule="learned")
        trainer = Trainer(cfg)
        batches = make_batches(cfg, num=4)
        state = trainer.init_state(jax.random.key(0), batches[0])
        g0 = jax.tree.leaves(state.params["gamma"])
        state, _ = trainer.train_step(state, jax.random.key(1), batches[0])
        g1 = jax.tree.leaves(state.params["gamma"])
        assert any(
            not np.allclose(np.asarray(a), np.asarray(b))
            for a, b in zip(g0, g1)
        )

    @pytest.mark.slow
    def test_gamma_boundary_drives_sigma0_to_floor(self):
        """The VDM boundary terms must pull sigma(0) from its ~0.082 init
        (gamma_0 = -5) toward the reconstruction floor; without them the
        eps-MSE leaves the endpoint untouched (measured on the flagship:
        sigma_0 drifted UP to 0.124, rdf_cos 0.53 vs 0.90 predefined)."""

        def sigma0_after(weight, epochs=30):
            cfg = tiny_cfg(noise_schedule="learned",
                           gamma_boundary_weight=weight)
            trainer = Trainer(cfg)
            batches = make_batches(cfg, num=16)
            state = trainer.init_state(jax.random.key(0), batches[0])
            key = jax.random.key(4)
            for _ in range(epochs):
                key, sub = jax.random.split(key)
                state, _ = trainer.train_epoch(state, sub, batches)
            sched = trainer.schedule_for(state.params)
            a = np.asarray(sched.alphas)
            return float(np.sqrt(1.0 - a[0] ** 2)), float(a[-1])

        s0_on, aT_on = sigma0_after(1.0)
        s0_off, _ = sigma0_after(0.0)
        assert s0_on < 0.05, (s0_on, s0_off)
        assert s0_on < 0.75 * s0_off, (s0_on, s0_off)
        assert aT_on < 0.05  # prior end stays clean


class TestCheckpoint:
    @pytest.mark.slow
    def test_roundtrip(self, tmp_path):
        cfg = tiny_cfg()
        trainer = Trainer(cfg)
        batches = make_batches(cfg, num=4)
        state = trainer.init_state(jax.random.key(0), batches[0])
        state, _ = trainer.train_step(state, jax.random.key(1), batches[0])
        ckdir = os.path.join(tmp_path, "ckpt")
        save_checkpoint(ckdir, state, cfg, step=int(state.step))
        template = trainer.init_state(jax.random.key(9), batches[0])
        restored, cfg2 = restore_checkpoint(ckdir, template)
        assert cfg2.n_max == cfg.n_max
        for a, b in zip(jax.tree.leaves(state.params),
                        jax.tree.leaves(restored.params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(state.opt_state),
                        jax.tree.leaves(restored.opt_state)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # training continues from the restored state
        restored_next, m = trainer.train_step(
            restored, jax.random.key(2), batches[0]
        )
        assert int(restored_next.step) == int(state.step) + 1

    def test_gamma_endpoint_rescale_on_schema_mismatch(self):
        """Learned-schedule checkpoints written under a different (or no)
        endpoint_scale reparameterisation must restore to the same
        SEMANTIC schedule: stored raw endpoints are rescaled by
        stored_scale/current_scale on load (nn/gamma.py stores the
        trainable endpoints pre-scaled; an unstamped config means
        pre-reparameterisation raw values, scale 1.0)."""
        import jax.numpy as jnp

        from diffusion_model.nn.gamma import GammaNetwork
        from diffusion_model.train.checkpoint import (
            _rescale_gamma_endpoints,
        )
        from diffusion_model.train.trainer import TrainState

        state = TrainState(
            params={
                "denoiser": {"w": jnp.ones(2)},
                "gamma": {"params": {
                    "gamma_0": jnp.asarray([-5.0]),
                    "gamma_1": jnp.asarray([10.0]),
                    "l1": {"weight": jnp.ones((1, 1))},
                }},
            },
            opt_state=None, step=jnp.zeros((), jnp.int32),
        )
        scale = float(GammaNetwork.endpoint_scale)
        # unstamped sidecar = raw (scale-1.0) endpoints -> divided by scale
        out = _rescale_gamma_endpoints(state, {})
        g = out.params["gamma"]["params"]
        assert float(g["gamma_0"][0]) == pytest.approx(-5.0 / scale)
        assert float(g["gamma_1"][0]) == pytest.approx(10.0 / scale)
        # other leaves untouched; original state unmodified
        np.testing.assert_array_equal(
            np.asarray(out.params["denoiser"]["w"]), np.ones(2))
        assert float(
            state.params["gamma"]["params"]["gamma_0"][0]) == -5.0
        # matching stamp -> no-op
        same = _rescale_gamma_endpoints(
            state, {"gamma_endpoint_scale": scale})
        assert same is state
        # no gamma subtree (predefined schedule) -> no-op
        pos_only = TrainState(params={"denoiser": {}}, opt_state=None,
                              step=jnp.zeros((), jnp.int32))
        assert _rescale_gamma_endpoints(pos_only, {}) is pos_only

    def test_gamma_endpoint_rescale_reaches_opt_state(self):
        """The rescale must also fix the parameter COPIES evaluation reads
        out of the optimizer state: schedule-free's z iterate (eval_params
        interpolates y/z — a raw z defeats the rescue under the DEFAULT
        optimizer) and the EMA average; Adam moments transform linearly
        (mu) / quadratically (nu)."""
        import jax.numpy as jnp

        from diffusion_model.nn.gamma import GammaNetwork
        from diffusion_model.train.checkpoint import (
            _rescale_gamma_endpoints,
        )
        from diffusion_model.train.trainer import (
            TrainState,
            make_optimizer,
        )

        params = {
            "denoiser": {"w": jnp.ones(2)},
            "gamma": {"params": {
                "gamma_0": jnp.asarray([-5.0]),
                "gamma_1": jnp.asarray([10.0]),
            }},
        }
        scale = float(GammaNetwork.endpoint_scale)

        # schedule-free: z copy rescales like the params
        cfg = tiny_cfg(optimizer="RAdamScheduleFree")
        opt = make_optimizer(cfg)
        st = opt.init(params)
        # make z distinguishable from fresh-init params
        state = TrainState(params=params, opt_state=st,
                           step=jnp.zeros((), jnp.int32))
        out = _rescale_gamma_endpoints(state, {})
        z = out.opt_state[1].z["gamma"]["params"]
        assert float(z["gamma_0"][0]) == pytest.approx(-5.0 / scale)
        assert float(z["gamma_1"][0]) == pytest.approx(10.0 / scale)
        np.testing.assert_array_equal(
            np.asarray(out.opt_state[1].z["denoiser"]["w"]), np.ones(2))
        # eval_params now sees consistent y and z
        ev = out.eval_params(cfg)
        assert float(ev["gamma"]["params"]["gamma_0"][0]) == pytest.approx(
            -5.0 / scale)

        # EMA: the average rescales; Adam mu/nu scale ratio / ratio^2
        cfg_e = tiny_cfg(optimizer="Adam", ema_decay=0.99)
        opt_e = make_optimizer(cfg_e)
        st_e = opt_e.init(params)
        # seed non-zero moments so the scaling is observable
        import jax

        st_e = jax.tree.map(lambda a: a + 1.0 if a.ndim else a, st_e)
        state_e = TrainState(params=params, opt_state=st_e,
                             step=jnp.zeros((), jnp.int32))
        out_e = _rescale_gamma_endpoints(state_e, {})
        ema = out_e.opt_state[-1].ema["gamma"]["params"]
        assert float(ema["gamma_0"][0]) == pytest.approx(-4.0 / scale)
        import jax.tree_util as jtu

        def find(state_tree, moment):
            for path, leaf in jtu.tree_leaves_with_path(state_tree):
                keys = [getattr(k, "name", None) or getattr(k, "key", None)
                        for k in path]
                if moment in keys and "gamma_0" in keys:
                    return float(leaf.reshape(-1)[0])
            raise AssertionError(f"{moment} gamma_0 leaf not found")

        # moments track gradients (g_raw = g_sem * scale): inverse of the
        # parameter transform — unstamped (scale 1) -> current (scale s)
        # means ratio = 1/s, so mu scales by s and nu by s^2
        assert find(out_e.opt_state, "mu") == pytest.approx(scale)
        assert find(out_e.opt_state, "nu") == pytest.approx(scale**2)


class TestEarlyStopping:
    def test_semantics(self):
        es = EarlyStopping(patience=2)
        assert not es.validate(1.0)
        assert not es.validate(0.9)
        assert not es.validate(1.1)  # step 1
        assert not es.validate(1.2)  # step 2
        assert es.validate(1.3)      # step 3 > patience
        es2 = EarlyStopping(patience=2)
        assert not es2.validate(1.0)
        assert not es2.validate(1.1)
        assert not es2.validate(0.5)  # improvement resets
        assert not es2.validate(0.6)
        assert not es2.validate(0.7)
        assert es2.validate(0.8)


class TestGammaInitPolynomial:
    def test_init_tracks_polynomial_schedule_and_trains(self):
        """cfg.gamma_init='polynomial': the learned schedule starts at the
        best in-family approximation of the polynomial schedule (alpha^2-
        space pre-fit, nn/gamma.fit_gamma_to_schedule) instead of the VDM
        default endpoints — measured better final quality
        (docs/quality/learned_origin_test.json)."""
        cfg = tiny_cfg(noise_schedule="learned", gamma_init="polynomial",
                       num_diffusion_timestep=50, noise_precision=0.05)
        trainer = Trainer(cfg)
        batches = make_batches(cfg, num=2)
        state = trainer.init_state(jax.random.key(0), batches[0])
        sched = trainer.schedule_for(state.params)
        target = predefined_schedule(cfg)
        dev = np.max(np.abs(np.asarray(sched.alphas)
                            - np.asarray(target.alphas)))
        assert dev < 0.12, dev  # in-family tail limit is ~0.09-0.1
        # interior must be tight (the representable region)
        mid = slice(5, 40)
        dev_mid = np.max(np.abs(np.asarray(sched.alphas)[mid]
                                - np.asarray(target.alphas)[mid]))
        assert dev_mid < 0.06, dev_mid  # toy T=50 schedule fits a bit looser
        state, m = trainer.train_step(state, jax.random.key(1),
                                      batches[0])
        assert np.isfinite(float(m["loss"]))


class TestTLossWeight:
    """config.t_loss_weight: per-graph t-band loss weighting
    (the gradient-emphasis variant of t_bias_frac, VERDICT-r4 candidate)."""

    def test_off_is_none_and_loss_identical(self):
        from diffusion_model.train import t_band_weights

        cfg = tiny_cfg()
        assert t_band_weights(cfg, jnp.asarray([1, 2, 3])) is None
        # weights of ones reproduce the unweighted loss exactly
        mask = jnp.asarray([[1.0, 1, 0], [1, 0, 0]])
        ex_p, eh_p = jnp.ones((2, 3, 3)), jnp.ones((2, 3, 2))
        ex, eh = jnp.zeros((2, 3, 3)), jnp.zeros((2, 3, 2))
        plain = epsilon_loss(ex_p, eh_p, ex, eh, mask)
        ones = epsilon_loss(ex_p, eh_p, ex, eh, mask,
                            weights=jnp.ones((2,)))
        np.testing.assert_allclose(float(plain[0]), float(ones[0]))
        np.testing.assert_allclose(float(plain[1]), float(ones[1]))

    def test_analytic_normalisation(self):
        """E[w(t)] over the uniform draw is exactly 1 — the loss scale
        (hence effective lr under clipping) is unchanged, including at
        batch_size=1 where a batch-mean normalisation would cancel the
        lever outright."""
        from diffusion_model.train import t_band_weights

        cfg = tiny_cfg(t_loss_weight=3.0, t_bias_lo=10, t_bias_hi=20)
        t_all = jnp.arange(1, cfg.num_diffusion_timestep + 1)
        w = t_band_weights(cfg, t_all)
        np.testing.assert_allclose(float(w.mean()), 1.0, rtol=1e-6)
        # in-band / out-of-band ratio is the configured factor
        assert np.isclose(float(w[14] / w[0]), 3.0, rtol=1e-6)

    def test_metrics_stay_unweighted(self):
        """sum_sq (the reported loss curve) must not move with the weight
        so arms stay comparable; the gradient loss must."""
        mask = jnp.ones((2, 3))
        ex_p, eh_p = jnp.ones((2, 3, 3)), jnp.ones((2, 3, 2))
        ex, eh = jnp.zeros((2, 3, 3)), jnp.zeros((2, 3, 2))
        w = jnp.asarray([2.0, 0.5])
        plain = epsilon_loss(ex_p, eh_p, ex, eh, mask)
        weighted = epsilon_loss(ex_p, eh_p, ex, eh, mask, weights=w)
        assert float(plain[1]) == float(weighted[1])
        assert float(plain[0]) != float(weighted[0])

    def test_validation(self):
        from diffusion_model.train import t_band_weights

        t = jnp.asarray([1, 2])
        with pytest.raises(ValueError, match="t-band"):
            t_band_weights(tiny_cfg(t_loss_weight=2.0), t)  # hi=600 > T=50
        with pytest.raises(ValueError, match="t_loss_weight"):
            t_band_weights(
                tiny_cfg(t_loss_weight=-1.0, t_bias_lo=10, t_bias_hi=20), t
            )

    def test_train_step_runs_and_differs(self):
        cfg_w = tiny_cfg(t_loss_weight=4.0, t_bias_lo=10, t_bias_hi=20,
                         optimizer="Adam")
        cfg_p = tiny_cfg(optimizer="Adam")
        batches = make_batches(cfg_p, num=4)
        tr_w, tr_p = Trainer(cfg_w), Trainer(cfg_p)
        s_w = tr_w.init_state(jax.random.key(0), batches[0])
        s_p = tr_p.init_state(jax.random.key(0), batches[0])
        s_w, m_w = tr_w.train_step(s_w, jax.random.key(1), batches[0])
        s_p, m_p = tr_p.train_step(s_p, jax.random.key(1), batches[0])
        assert np.isfinite(float(m_w["loss"]))
        # identical key path: same noise draw, same raw error metric
        np.testing.assert_allclose(float(m_w["sum_sq"]),
                                   float(m_p["sum_sq"]), rtol=1e-5)
        # but the gradient step differs (unless no t landed in band —
        # with B=4 and band width 11/50 that has prob ~0.37, so draw the
        # comparison over several keys)
        diff = 0.0
        for i in range(1, 6):
            s_w, _ = tr_w.train_step(s_w, jax.random.key(i), batches[0])
            s_p, _ = tr_p.train_step(s_p, jax.random.key(i), batches[0])
        a = jax.tree.leaves(s_w.params)[0]
        b = jax.tree.leaves(s_p.params)[0]
        assert not np.allclose(np.asarray(a), np.asarray(b))


class TestCurriculumInit:
    def test_init_params_from_seeds_eval_params(self, tmp_path):
        """api.train(init_params_from=...) starts from the SOURCE run's
        eval params (the quality-bearing schedule-free average), with a
        fresh optimizer and epoch 0 — and works across n_max (the EGNN is
        size-agnostic)."""
        from diffusion_model import api

        cfg_a = tiny_cfg(optimizer="RAdamScheduleFree", num_epochs=2,
                         checkpoint_every=0)
        data = synthetic_sio2_dataset(0, 12, cfg_a.n_max,
                                      spectrum_size=cfg_a.spectrum_size)
        dir_a = str(tmp_path / "a")
        trainer_a, state_a, _ = api.train(cfg_a, data, dir_a)
        want = state_a.eval_params(cfg_a)

        # target run at a LARGER n_max, zero epochs: state must equal the
        # source eval params exactly
        cfg_b = tiny_cfg(optimizer="RAdamScheduleFree", num_epochs=0,
                         n_max=12)
        data_b = synthetic_sio2_dataset(1, 12, cfg_b.n_max,
                                        spectrum_size=cfg_b.spectrum_size)
        dir_b = str(tmp_path / "b")
        _, state_b, _ = api.train(cfg_b, data_b, dir_b,
                                  init_params_from=dir_a)
        got = state_b.params
        jax.tree.map(
            lambda w, g: np.testing.assert_allclose(
                np.asarray(w), np.asarray(g), rtol=1e-6),
            want, got,
        )
        assert int(state_b.step) == 0

    def test_resume_wins_over_init_from(self, tmp_path):
        """A checkpoint in the run dir + resume=True must take precedence
        (watchdog relaunches of a curriculum run keep their progress)."""
        from diffusion_model import api

        cfg = tiny_cfg(optimizer="Adam", num_epochs=2, checkpoint_every=1)
        data = synthetic_sio2_dataset(0, 12, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        dir_a = str(tmp_path / "a")
        api.train(cfg, data, dir_a)
        dir_b = str(tmp_path / "b")
        _, state_b, _ = api.train(cfg, data, dir_b, init_params_from=dir_a)
        # relaunch with resume: continues from dir_b's checkpoint (epoch 2
        # = num_epochs, so no further training happens)
        _, state_b2, _ = api.train(cfg, data, dir_b, init_params_from=dir_a,
                                   resume=True)
        jax.tree.map(
            lambda w, g: np.testing.assert_allclose(
                np.asarray(w), np.asarray(g), rtol=1e-7),
            state_b.params, state_b2.params,
        )
