"""Diffusion process + scan sampler tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffusion_model.config import Config
from diffusion_model.data.batch import GraphBatch
from diffusion_model.diffusion import (
    calculate_mu,
    diffuse_zero_to_t,
    learned_schedule,
    predefined_schedule,
    reverse_diffuse_one_step,
    sample,
    sample_with_retry,
)
from diffusion_model.diffusion.sampler import tile_batch
from diffusion_model.nn import DiffusionDenoiser, GammaNetwork


def small_cfg(**kw):
    base = dict(n_max=6, L=2, m_hidden_size=16, h_hidden_size=16,
                x_hidden_size=16, m_size=8, num_diffusion_timestep=20,
                spectrum_size=10, compressed_spectrum_size=4,
                compressor_hidden_dim=(8,))
    base.update(kw)
    return Config(**base)


def make_cond(cfg, b=2, n_real=None, rng=None):
    rng = rng or np.random.default_rng(0)
    n = cfg.n_max
    mask = np.zeros((b, n), np.float32)
    for i in range(b):
        mask[i, : (n_real or n)] = 1
    spec = np.zeros((b, n, cfg.spectrum_size), np.float32)
    spec[:, 0] = rng.random((b, cfg.spectrum_size))
    exo = np.zeros((b, n, 1), np.float32)
    exo[:, 0, 0] = 1
    return GraphBatch(
        pos=jnp.zeros((b, n, 3)),
        species=jnp.zeros((b, n, cfg.atom_type_size)),
        spectrum=jnp.asarray(spec),
        exo=jnp.asarray(exo),
        mask=jnp.asarray(mask),
    )


class TestSchedule:
    def test_predefined_endpoints(self):
        cfg = Config()
        s = predefined_schedule(cfg)
        assert s.num_timesteps == 1000
        assert float(s.alpha(0)) == pytest.approx(1 - 1e-5, abs=1e-6)
        assert float(s.alpha(1000)) == pytest.approx(1e-5, abs=1e-7)
        # f32 cancellation in 1 - alpha^2 near alpha=1 => absolute tolerance
        assert float(s.sigma(0)) == pytest.approx(
            np.sqrt(1 - (1 - 1e-5) ** 2), abs=1e-5
        )

    def test_learned_schedule_monotone(self):
        net = GammaNetwork(hidden=32)
        t = jnp.zeros((1, 1))
        params = net.init(jax.random.key(0), t)
        s = learned_schedule(net.apply, params, 50)
        a = np.asarray(s.alphas)
        assert a.shape == (51,)
        assert np.all(np.diff(a) <= 1e-7)  # alpha decreasing as gamma grows
        # endpoints from gamma_0=-5, gamma_1=10
        assert a[0] == pytest.approx(np.sqrt(1 / (1 + np.exp(-5.0))), rel=1e-4)


class TestForwardNoise:
    def test_identity_and_com(self, rng):
        cfg = small_cfg()
        s = predefined_schedule(cfg)
        z = jnp.asarray(rng.normal(size=(3, 6, 3)), jnp.float32)
        mask = jnp.asarray(np.stack([[1, 1, 1, 1, 0, 0]] * 3), jnp.float32)
        t = jnp.asarray([1, 10, 20])
        z_t, eps = diffuse_zero_to_t(s, jax.random.key(1), z, t, "pos", mask)
        alpha = np.asarray(s.alphas)[np.asarray(t)][:, None, None]
        sigma = np.sqrt(1 - alpha**2)
        np.testing.assert_allclose(
            np.asarray(z_t), alpha * np.asarray(z) + sigma * np.asarray(eps),
            rtol=1e-5, atol=1e-6,
        )
        for b in range(3):
            m = np.asarray(mask[b]) > 0
            np.testing.assert_allclose(np.asarray(eps[b])[m].mean(0), 0,
                                       atol=1e-6)
            np.testing.assert_allclose(np.asarray(eps[b])[~m], 0)

    def test_h_mode_no_com(self, rng):
        cfg = small_cfg()
        s = predefined_schedule(cfg)
        z = jnp.asarray(rng.normal(size=(2, 6, 2)), jnp.float32)
        mask = jnp.ones((2, 6))
        _, eps = diffuse_zero_to_t(s, jax.random.key(2), z, 5, "h", mask)
        assert abs(float(np.asarray(eps).mean())) > 1e-4  # not CoM-projected


class TestReverse:
    def test_mu_formula(self, rng):
        cfg = small_cfg()
        s = predefined_schedule(cfg)
        z = jnp.asarray(rng.normal(size=(1, 4, 3)), jnp.float32)
        eps = jnp.asarray(rng.normal(size=(1, 4, 3)), jnp.float32)
        t = 7
        mu = np.asarray(calculate_mu(s, z, eps, t))
        a = np.asarray(s.alphas)
        a_t, a_s = a[t], a[t - 1]
        s2_t, s2_s = 1 - a_t**2, 1 - a_s**2
        a_ts = a_t / a_s
        s2_ts = s2_t - a_ts**2 * s2_s
        want = np.asarray(z) / a_ts - s2_ts * np.asarray(eps) / a_ts / np.sqrt(s2_t)
        np.testing.assert_allclose(mu, want, rtol=1e-5, atol=1e-6)

    def test_reverse_step_statistics(self, rng):
        cfg = small_cfg()
        s = predefined_schedule(cfg)
        z = jnp.zeros((1, 4, 3))
        eps = jnp.zeros((1, 4, 3))
        t = 10
        outs = []
        for i in range(300):
            out = reverse_diffuse_one_step(s, jax.random.key(i), z, eps, t,
                                           mode="h")
            outs.append(np.asarray(out))
        std = np.std(np.stack(outs))
        a = np.asarray(s.alphas)
        a_t, a_s = a[t], a[t - 1]
        s2_t, s2_s = 1 - a_t**2, 1 - a_s**2
        a_ts = a_t / a_s
        want_std = np.sqrt((s2_t - a_ts**2 * s2_s) * s2_s / s2_t)
        assert std == pytest.approx(want_std, rel=0.1)


class TestSampler:
    # With the production noise floor s=1e-5, an UNTRAINED denoiser explodes
    # through the 1/alpha_ts reverse-chain gain (a_0/a_T = 1e5) and NaNs —
    # the exact scenario behind the reference's NaN-retry loop
    # (ref parts/train_per_iretation.py:376-389). Unit tests use a gentler
    # floor so random weights stay finite; trained-model behaviour is covered
    # by the end-to-end training test.
    NOISE_KW = dict(noise_precision=0.05)

    def _setup(self, cfg):
        cond = make_cond(cfg, b=2, n_real=4)
        model = DiffusionDenoiser(cfg)
        b, n = cond.mask.shape
        params = model.init(
            jax.random.key(0),
            jnp.zeros((b, n, cfg.atom_type_size)), cond.pos, cond.spectrum,
            cond.exo, jnp.zeros((b, n, 1)), cond.mask, cond.pair_mask(),
        )
        denoise_fn = lambda *a: model.apply(params, *a)
        return cond, denoise_fn

    def test_shapes_finite_com(self):
        cfg = small_cfg(**self.NOISE_KW)
        cond, fn = self._setup(cfg)
        s = predefined_schedule(cfg)
        res = sample(fn, s, cfg, jax.random.key(3), cond)
        assert res.pos.shape == (2, cfg.n_max, 3)
        assert res.species.shape == (2, cfg.n_max, cfg.atom_type_size)
        assert bool(jnp.all(res.finite))
        # species is one-hot on real nodes, zero on padding
        sp = np.asarray(res.species)
        mask = np.asarray(cond.mask)
        assert np.all(sp[mask > 0].sum(-1) == 1)
        assert np.all(sp[mask == 0] == 0)
        assert np.all(np.asarray(res.pos)[mask == 0] == 0)

    @pytest.mark.slow
    def test_deterministic_given_key(self):
        cfg = small_cfg(**self.NOISE_KW)
        cond, fn = self._setup(cfg)
        s = predefined_schedule(cfg)
        r1 = sample(fn, s, cfg, jax.random.key(5), cond)
        r2 = sample(fn, s, cfg, jax.random.key(5), cond)
        np.testing.assert_array_equal(np.asarray(r1.pos), np.asarray(r2.pos))
        r3 = sample(fn, s, cfg, jax.random.key(6), cond)
        assert not np.allclose(np.asarray(r1.pos), np.asarray(r3.pos))

    def test_trajectory_snapshots(self):
        cfg = small_cfg(num_diffusion_timestep=20, snapshot_every=5,
                        **self.NOISE_KW)
        cond, fn = self._setup(cfg)
        s = predefined_schedule(cfg)
        res = sample(fn, s, cfg, jax.random.key(1), cond,
                     return_trajectory=True)
        traj_pos, traj_h = res.trajectory
        assert traj_pos.shape == (4, 2, cfg.n_max, 3)

    @pytest.mark.slow
    def test_retry_and_tile(self):
        cfg = small_cfg(**self.NOISE_KW)
        cond, fn = self._setup(cfg)
        s = predefined_schedule(cfg)
        tiled = tile_batch(cond, 3)
        assert tiled.mask.shape[0] == 6
        res = sample_with_retry(fn, s, cfg, jax.random.key(2), tiled)
        assert res.pos.shape[0] == 6
        assert bool(jnp.all(res.finite))


class TestStridedSampler:
    @pytest.mark.slow
    def test_full_steps_unchanged(self):
        cfg = small_cfg(noise_precision=0.05)
        cond = make_cond(cfg, b=2, n_real=4)
        model = DiffusionDenoiser(cfg)
        b, n = cond.mask.shape
        params = model.init(
            jax.random.key(0),
            jnp.zeros((b, n, cfg.atom_type_size)), cond.pos, cond.spectrum,
            cond.exo, jnp.zeros((b, n, 1)), cond.mask, cond.pair_mask(),
        )
        fn = lambda *a: model.apply(params, *a)
        s = predefined_schedule(cfg)
        r_full = sample(fn, s, cfg, jax.random.key(7), cond)
        r_same = sample(fn, s, cfg.replace(
            sample_steps=cfg.num_diffusion_timestep
        ), jax.random.key(7), cond)
        np.testing.assert_array_equal(np.asarray(r_full.pos),
                                      np.asarray(r_same.pos))

    def test_strided_runs_finite(self):
        cfg = small_cfg(noise_precision=0.05, num_diffusion_timestep=20,
                        sample_steps=5)
        cond = make_cond(cfg, b=2, n_real=4)
        model = DiffusionDenoiser(cfg)
        b, n = cond.mask.shape
        params = model.init(
            jax.random.key(0),
            jnp.zeros((b, n, cfg.atom_type_size)), cond.pos, cond.spectrum,
            cond.exo, jnp.zeros((b, n, 1)), cond.mask, cond.pair_mask(),
        )
        fn = lambda *a: model.apply(params, *a)
        s = predefined_schedule(cfg)
        res = sample(fn, s, cfg, jax.random.key(8), cond)
        assert bool(jnp.all(res.finite))
        assert res.pos.shape == (2, cfg.n_max, 3)



    def test_steps_beyond_table_rejected(self):
        """sample_steps > T must raise: the snr_grid monotonicity clamp
        would wrap leading indices into the high-noise end of the table
        (a silently corrupt schedule) and the uniform grid degenerates."""
        cfg = small_cfg(noise_precision=0.05).replace(
            sample_steps=small_cfg().num_diffusion_timestep + 1)
        cond = make_cond(cfg, b=1, n_real=4)
        schedule = predefined_schedule(cfg)
        with pytest.raises(ValueError, match="exceeds"):
            sample(lambda *a: (jnp.zeros_like(cond.pos),
                               jnp.zeros_like(cond.species)),
                   schedule, cfg, jax.random.key(0), cond)

class TestSnrGrid:
    def test_monotone_with_pinned_endpoints(self):
        from diffusion_model.diffusion.sampler import snr_grid

        cfg = small_cfg(num_diffusion_timestep=100)
        alphas = predefined_schedule(cfg).alphas
        idx = np.asarray(snr_grid(alphas, 10))
        assert idx[0] == 0 and idx[-1] == 100
        assert (np.diff(idx) >= 0).all()
        assert len(set(idx.tolist())) == 11  # strictly increasing here

    def test_concentrates_steps_where_schedule_moves(self):
        """A squeezed schedule (log-SNR nearly flat outside t in [40, 60],
        steep inside) must get most grid points in the steep window;
        uniform would place only ~1/5 of them there."""
        import jax.numpy as jnp

        from diffusion_model.diffusion.sampler import snr_grid

        t = np.arange(101) / 100.0
        # piecewise log-SNR: slow drift on the tails, a 30-unit jump inside
        g = (-12.0 + 2.0 * np.clip(t / 0.4, 0, 1)
             + 30.0 * np.clip((t - 0.4) / 0.2, 0, 1)
             + 2.0 * np.clip((t - 0.6) / 0.4, 0, 1))
        alphas = jnp.asarray(np.sqrt(1.0 / (1.0 + np.exp(g))))
        idx = np.asarray(snr_grid(alphas, 20))
        inside = ((idx >= 40) & (idx <= 60)).sum()
        assert inside >= 14, idx  # uniform stride would give ~5
        assert idx[0] == 0 and idx[-1] == 100

    def test_bounded_alpha_ratio_on_underflowing_tail(self):
        """Learned schedules underflow alpha to ~0 past their signal band;
        the grid must keep per-step alpha ratios bounded there instead of
        fusing the tail into one exploding step (gamma computed without
        f32 clip saturation)."""
        import jax.numpy as jnp

        from diffusion_model.diffusion.sampler import snr_grid

        t = np.arange(1001) / 1000.0
        g = (-9.2 + 60.0 * np.clip((t - 0.1) / 0.4, 0, 1)
             + 30.0 * np.clip((t - 0.5) / 0.5, 0, 1))
        alphas = jnp.asarray(np.sqrt(1.0 / (1.0 + np.exp(g))))
        idx = np.asarray(snr_grid(alphas, 100))
        a = np.asarray(alphas)
        ratios = a[idx[1:]] / np.maximum(a[idx[:-1]], 1e-38)
        assert ratios.min() > 0.1, ratios.min()

    def test_snr_grid_sampling_runs_finite(self):
        cfg = small_cfg(noise_precision=0.05, num_diffusion_timestep=20,
                        sample_steps=5, sample_grid="snr")
        cond = make_cond(cfg, b=2, n_real=4)
        model = DiffusionDenoiser(cfg)
        b, n = cond.mask.shape
        params = model.init(
            jax.random.key(0),
            jnp.zeros((b, n, cfg.atom_type_size)), cond.pos, cond.spectrum,
            cond.exo, jnp.zeros((b, n, 1)), cond.mask, cond.pair_mask(),
        )
        fn = lambda *a: model.apply(params, *a)
        s = predefined_schedule(cfg)
        res = sample(fn, s, cfg, jax.random.key(8), cond)
        assert bool(jnp.all(res.finite))


class TestDeterministicSampling:
    @pytest.mark.slow
    def test_only_init_noise_matters(self):
        """DDIM eta=0: two different scan keys with the same init noise give
        identical structures; different init noise differs."""
        cfg = small_cfg(noise_precision=0.05, deterministic_sampling=True)
        cond = make_cond(cfg, b=2, n_real=4)
        model = DiffusionDenoiser(cfg)
        b, n = cond.mask.shape
        params = model.init(
            jax.random.key(0),
            jnp.zeros((b, n, cfg.atom_type_size)), cond.pos, cond.spectrum,
            cond.exo, jnp.zeros((b, n, 1)), cond.mask, cond.pair_mask(),
        )
        fn = lambda *a: model.apply(params, *a)
        s = predefined_schedule(cfg)
        r1 = sample(fn, s, cfg, jax.random.key(3), cond)
        r2 = sample(fn, s, cfg, jax.random.key(3), cond)
        np.testing.assert_array_equal(np.asarray(r1.pos), np.asarray(r2.pos))
        assert bool(jnp.all(r1.finite))
        # stochastic mode with the same key differs from deterministic
        r3 = sample(fn, s, cfg.replace(deterministic_sampling=False),
                    jax.random.key(3), cond)
        assert not np.allclose(np.asarray(r1.pos), np.asarray(r3.pos))


class TestSampleNoiseScale:
    @pytest.mark.slow
    def test_temperature_endpoints_and_interior(self):
        """sample_noise_scale: 0.0 coincides with the DDIM mean chain,
        1.0 is the exact reference ancestral chain, interior values land
        elsewhere (same key throughout)."""
        cfg = small_cfg(noise_precision=0.05)
        cond = make_cond(cfg, b=2, n_real=4)
        model = DiffusionDenoiser(cfg)
        b, n = cond.mask.shape
        params = model.init(
            jax.random.key(0),
            jnp.zeros((b, n, cfg.atom_type_size)), cond.pos, cond.spectrum,
            cond.exo, jnp.zeros((b, n, 1)), cond.mask, cond.pair_mask(),
        )
        fn = lambda *a: model.apply(params, *a)
        s = predefined_schedule(cfg)
        key = jax.random.key(3)
        r_ddim = sample(fn, s, cfg.replace(deterministic_sampling=True),
                        key, cond)
        r_zero = sample(fn, s, cfg.replace(sample_noise_scale=0.0),
                        key, cond)
        np.testing.assert_array_equal(
            np.asarray(r_ddim.pos), np.asarray(r_zero.pos)
        )
        r_ref = sample(fn, s, cfg, key, cond)  # default 1.0
        r_half = sample(fn, s, cfg.replace(sample_noise_scale=0.5),
                        key, cond)
        assert not np.allclose(np.asarray(r_ref.pos), np.asarray(r_half.pos))
        assert not np.allclose(np.asarray(r_zero.pos), np.asarray(r_half.pos))
        # padded nodes stay inert at every temperature
        pad = np.asarray(cond.mask) == 0
        for r in (r_ref, r_half, r_zero):
            assert np.all(np.asarray(r.pos)[pad] == 0)
