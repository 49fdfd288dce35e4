"""Progressive distillation: step-coefficient algebra, dyadic grids, and the
end-to-end property that a distilled few-step student tracks the full-step
teacher better than the raw teacher run at few steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffusion_model.config import Config
from diffusion_model.data.split import batch_iterator
from diffusion_model.data.synthetic import synthetic_sio2_dataset
from diffusion_model.diffusion import predefined_schedule, sample
from diffusion_model.diffusion.process import reverse_diffuse_one_step
from diffusion_model.train import Trainer
from diffusion_model.train.distill import (
    PhaseSchedule,
    full_phase,
    progressive_distill,
    step_coeffs,
)


def tiny_cfg(**kw):
    # noise_precision=0.05 tames the toy schedule's alpha tail: with the
    # reference s=1e-5 an 8-step grid's top two-for-one step amplifies by
    # alpha_4/alpha_8 ~ 8.7e3, which no toy-trained teacher survives — the
    # flagship regime (T=1000, strided to >=125) never sees ratios like
    # that between *trained-quality* predictions (strided_eval.json).
    base = dict(
        n_max=5, L=2, m_hidden_size=32, h_hidden_size=32, x_hidden_size=32,
        m_size=16, spectrum_size=32, compressed_spectrum_size=8,
        compressor_hidden_dim=(16,), num_diffusion_timestep=8,
        batch_size=8, lr=2e-3, optimizer="Adam", zero_init_x=False,
        noise_precision=0.05,
    )
    base.update(kw)
    return Config(**base)


class TestStepCoeffs:
    def test_matches_deterministic_reverse_step(self):
        cfg = tiny_cfg()
        sched = predefined_schedule(cfg)
        key = jax.random.key(0)
        z = jax.random.normal(key, (4, 5, 3))
        eps = jax.random.normal(jax.random.key(1), (4, 5, 3))
        t = jnp.array([3, 5, 1, 8])
        a, b = step_coeffs(sched.alphas, t)
        got = a[:, None, None] * z + b[:, None, None] * eps
        want = reverse_diffuse_one_step(
            sched, key, z, eps, t, mode="h", deterministic=True
        )
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)

    def test_scaled_species_step_matches_sampler_operator(self):
        """The sampler stores reverse(scale*h) back unscaled (ref
        parts/train_per_iretation.py:343,373), so in h-units the species
        transition is h' = (A scale) h + B eps — the operator distillation
        must train against when onehot_scaling_factor != 1."""
        cfg = tiny_cfg(onehot_scaling_factor=4.0)
        sched = predefined_schedule(cfg)
        scale = cfg.onehot_scaling_factor
        h = jax.random.normal(jax.random.key(2), (4, 5, 2))
        eps = jax.random.normal(jax.random.key(3), (4, 5, 2))
        t = jnp.array([3, 5, 1, 8])
        a, b = step_coeffs(sched.alphas, t)
        got = (a * scale)[:, None, None] * h + b[:, None, None] * eps
        want = reverse_diffuse_one_step(
            sched, jax.random.key(0), scale * h, eps, t, mode="h",
            deterministic=True
        )
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)

    def test_flat_schedule_segment_keeps_coeffs_finite(self):
        """A near-flat learned-schedule plateau makes sq_sigma_ts a
        catastrophic cancellation; the clamp must keep (A, B) finite with
        B <= 0 rather than letting rounding flip its sign."""
        alphas = jnp.array([0.9999999, 0.9999999, 0.5, 0.5000001, 0.1])
        for t in range(1, 5):
            a, b = step_coeffs(alphas, jnp.array([t]))
            assert np.isfinite(float(a[0])) and np.isfinite(float(b[0]))
            assert float(b[0]) <= 0.0

    def test_halving_is_dyadic_and_matches_strided_sampler_grid(self):
        cfg = tiny_cfg()
        phase = full_phase(predefined_schedule(cfg))
        p2 = phase.halve().halve()  # 8 -> 4 -> 2 steps
        np.testing.assert_array_equal(
            np.asarray(p2.alphas), np.asarray(phase.alphas[::4])
        )
        # the strided sampler subsamples with round(linspace(0, T, K+1)) —
        # for K dividing T that is exactly the dyadic grid the student
        # trained on (diffusion/sampler.py:70)
        idx = jnp.round(jnp.linspace(0.0, 8, 2 + 1)).astype(jnp.int32)
        np.testing.assert_array_equal(np.asarray(idx), [0, 4, 8])
        np.testing.assert_array_equal(
            np.asarray(p2.t_norm), np.asarray(idx, np.float32) / 8
        )

    def test_rejects_non_power_of_two_ratio(self):
        cfg = tiny_cfg(num_diffusion_timestep=12)
        sched = predefined_schedule(cfg)
        trainer = Trainer(cfg)
        with pytest.raises(ValueError, match="power of 2"):
            progressive_distill(
                cfg, trainer.model.apply, {}, sched, lambda: [],
                jax.random.key(0), final_steps=4,
            )


class TestProgressiveDistill:
    @pytest.mark.slow
    def test_student_tracks_teacher_better_than_raw_few_step(self):
        """Distil an 8-step teacher to 2 steps; the student's 2-step
        deterministic samples must land closer to the teacher's 8-step
        samples (same init noise) than the teacher itself run at 2 steps."""
        cfg = tiny_cfg()
        data = synthetic_sio2_dataset(0, 32, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        batches = list(batch_iterator(data, cfg.batch_size, cfg.n_max,
                                      seed=1))
        trainer = Trainer(cfg)
        state = trainer.init_state(jax.random.key(0), batches[0])
        # brief teacher training so the denoiser is non-trivial
        key = jax.random.key(1)
        for _ in range(20):
            state, _ = trainer.train_epoch(state, key, batches)
            key, _ = jax.random.split(key)

        teacher = state.eval_params(cfg)["denoiser"]
        sched = trainer.schedule_for(state.params)
        result = progressive_distill(
            cfg, trainer.model.apply, teacher, sched,
            lambda: batches, jax.random.key(2),
            final_steps=2, epochs_per_phase=60, lr=1e-3,
        )
        assert result.num_steps == 2

        cond = batches[0]
        k = jax.random.key(7)
        full_cfg = cfg.replace(deterministic_sampling=True)
        fast_cfg = full_cfg.replace(sample_steps=2)
        fn_t = lambda *a: trainer.model.apply(teacher, *a)
        fn_s = lambda *a: trainer.model.apply(result.params, *a)
        ref = sample(fn_t, sched, full_cfg, k, cond)       # 8-step teacher
        raw = sample(fn_t, sched, fast_cfg, k, cond)       # 2-step teacher
        stu = sample(fn_s, sched, fast_cfg, k, cond)       # 2-step student

        m3 = np.asarray(cond.mask)[..., None]
        err = lambda r: float(
            np.sum(np.abs(np.asarray(r.pos) - np.asarray(ref.pos)) * m3)
            / max(m3.sum(), 1)
        )
        e_raw, e_stu = err(raw), err(stu)
        assert np.isfinite(e_stu)
        assert e_stu < e_raw, (e_stu, e_raw)
        # and meaningfully so, not within noise
        assert e_stu < 0.7 * e_raw, (e_stu, e_raw)
