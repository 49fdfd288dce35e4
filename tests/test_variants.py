"""Model-variant tests: pos-only diffusion, Kabsch coordinate loss,
spectrum-to-latent conditioning, profiling utils."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffusion_model.config import Config
from diffusion_model.data.split import batch_iterator
from diffusion_model.data.synthetic import synthetic_sio2_dataset
from diffusion_model.diffusion import predefined_schedule, sample
from diffusion_model.nn.spectrum_latent import (
    encode_dataset,
    pretrain_autoencoder,
)
from diffusion_model.train import Trainer
from diffusion_model.utils.profiling import PhaseTimer


def tiny_cfg(**kw):
    base = dict(
        n_max=8, L=2, m_hidden_size=32, h_hidden_size=32, x_hidden_size=32,
        m_size=16, spectrum_size=32, compressed_spectrum_size=8,
        compressor_hidden_dim=(16,), num_diffusion_timestep=20,
        batch_size=4, lr=1e-3, optimizer="Adam", noise_precision=0.05,
    )
    base.update(kw)
    return Config(**base)


def data_and_batch(cfg, num=8):
    graphs = synthetic_sio2_dataset(0, num, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size)
    return graphs, next(batch_iterator(graphs, cfg.batch_size, cfg.n_max))


class TestPosOnly:
    @pytest.mark.slow
    def test_train_step_and_sampling(self):
        cfg = tiny_cfg(diffuse_species=False)
        trainer = Trainer(cfg)
        graphs, batch = data_and_batch(cfg)
        state = trainer.init_state(jax.random.key(0), batch)
        state, m = trainer.train_step(state, jax.random.key(1), batch)
        assert np.isfinite(float(m["loss"]))

        s = predefined_schedule(cfg)
        res = sample(trainer.denoise_fn(state.params), s, cfg,
                     jax.random.key(2), batch)
        # species unchanged from the condition
        np.testing.assert_array_equal(np.asarray(res.species),
                                      np.asarray(batch.species))
        assert bool(jnp.all(res.finite))

    @pytest.mark.slow
    def test_h_excluded_from_loss(self):
        """Pos-only loss must not depend on the h-branch prediction."""
        cfg = tiny_cfg(diffuse_species=False)
        trainer = Trainer(cfg)
        graphs, batch = data_and_batch(cfg)
        state = trainer.init_state(jax.random.key(0), batch)
        _, m1 = trainer.train_step(state, jax.random.key(1), batch)
        cfg2 = tiny_cfg(diffuse_species=True)
        trainer2 = Trainer(cfg2)
        _, m2 = trainer2.train_step(state, jax.random.key(1), batch)
        # joint loss includes the h term, so it must be strictly larger
        assert float(m2["sum_sq"]) > float(m1["sum_sq"])


class TestKabschLoss:
    @pytest.mark.slow
    def test_adds_coordinate_term(self):
        cfg = tiny_cfg(kabsch_loss=True, kabsch_loss_steps=5)
        trainer = Trainer(cfg)
        graphs, batch = data_and_batch(cfg)
        state = trainer.init_state(jax.random.key(0), batch)
        state2, m = trainer.train_step(state, jax.random.key(1), batch)
        assert np.isfinite(float(m["loss"]))
        # grads flowed: params changed
        changed = any(
            not np.allclose(np.asarray(a), np.asarray(b))
            for a, b in zip(jax.tree.leaves(state.params),
                            jax.tree.leaves(state2.params))
        )
        assert changed


class TestSpectrumLatent:
    @pytest.mark.slow
    def test_autoencoder_and_encoding(self, rng):
        spectra = rng.random((32, 40)).astype(np.float32)
        enc, enc_p, dec, dec_p, mse = pretrain_autoencoder(
            spectra, latent_dim=8, steps=200
        )
        assert mse < np.var(spectra)  # beats predicting the mean
        cfg = tiny_cfg(spectrum_size=40)
        graphs, _ = data_and_batch(cfg, num=4)
        # give graphs 40-wide spectra
        encoded = encode_dataset(graphs, enc, enc_p)
        g = encoded[0]
        assert g["spectrum"].shape[1] == 8
        assert np.all(g["spectrum"][1:] == 0)

    @pytest.mark.slow
    def test_latent_conditioned_training(self, rng):
        cfg = tiny_cfg(spectrum_to_latent=True, to_compress_spectrum=False,
                       latent_dim=8)
        assert cfg.cond_spectrum_size == 8
        trainer = Trainer(cfg)
        graphs, _ = data_and_batch(cfg)
        spectra = np.stack([g["spectrum"][0] for g in graphs])
        enc, enc_p, _, _, _ = pretrain_autoencoder(spectra, latent_dim=8,
                                                   steps=50)
        encoded = encode_dataset(graphs, enc, enc_p)
        batch = next(batch_iterator(encoded, cfg.batch_size, cfg.n_max))
        state = trainer.init_state(jax.random.key(0), batch)
        _, m = trainer.train_step(state, jax.random.key(1), batch)
        assert np.isfinite(float(m["loss"]))


class TestProfiling:
    def test_phase_timer(self):
        t = PhaseTimer()
        with t.phase("a"):
            pass
        with t.phase("a"):
            pass
        rep = t.report()
        assert rep["a"]["count"] == 2
        assert rep["a"]["total_s"] >= 0


class TestUnconditional:
    @pytest.mark.slow
    def test_unconditional_training_and_sampling(self):
        """conditional=False drops the spectrum features entirely
        (ref main.py:107-108: h_size = atom_type + t)."""
        import jax.numpy as jnp
        from diffusion_model.diffusion import predefined_schedule, sample

        cfg = tiny_cfg(conditional=False, give_exO=False)
        assert cfg.h_size == cfg.atom_type_size + 1
        trainer = Trainer(cfg)
        graphs, batch = (
            synthetic_sio2_dataset(0, 8, cfg.n_max,
                                   spectrum_size=cfg.spectrum_size),
            None,
        )
        from diffusion_model.data.split import batch_iterator

        batch = next(batch_iterator(graphs, cfg.batch_size, cfg.n_max))
        state = trainer.init_state(jax.random.key(0), batch)
        state, m = trainer.train_step(state, jax.random.key(1), batch)
        assert np.isfinite(float(m["loss"]))
        res = sample(trainer.denoise_fn(state.params),
                     predefined_schedule(cfg), cfg, jax.random.key(2), batch)
        assert bool(jnp.all(res.finite))


class TestKabschLossPaddedBatch:
    @pytest.mark.slow
    def test_no_nan_grads_with_zero_mask_rows(self):
        """kabsch_loss over a batch containing zero-mask padding rows must
        yield finite gradients (degenerate-SVD hazard) and average the RMSD
        over real graphs only."""
        cfg = tiny_cfg(kabsch_loss=True, kabsch_loss_steps=3, batch_size=4)
        trainer = Trainer(cfg)
        # 6 graphs, batch 4 -> final batch has 2 zero-mask padded rows
        graphs = synthetic_sio2_dataset(0, 6, cfg.n_max,
                                        spectrum_size=cfg.spectrum_size)
        batches = list(batch_iterator(graphs, cfg.batch_size, cfg.n_max))
        padded = batches[-1]
        assert float(jnp.sum(jnp.any(padded.mask > 0, axis=-1))) == 2
        state = trainer.init_state(jax.random.key(0), batches[0])
        state2, m = trainer.train_step(state, jax.random.key(1), padded)
        assert np.isfinite(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
        for leaf in jax.tree.leaves(state2.params):
            assert np.isfinite(np.asarray(leaf)).all()


class TestClassifierFreeGuidance:
    @pytest.mark.slow
    def test_dropout_training_and_guided_sampling(self):
        cfg = tiny_cfg(cond_dropout_prob=0.3)
        trainer = Trainer(cfg)
        graphs, batch = data_and_batch(cfg)
        state = trainer.init_state(jax.random.key(0), batch)
        state, m = trainer.train_step(state, jax.random.key(1), batch)
        assert np.isfinite(float(m["loss"]))

        s = predefined_schedule(cfg)
        fn = trainer.denoise_fn(state.params)
        plain = sample(fn, s, cfg, jax.random.key(2), batch)
        guided = sample(fn, s, cfg.replace(guidance_scale=2.0),
                        jax.random.key(2), batch)
        assert bool(jnp.all(guided.finite))
        # guidance changes the trajectory
        assert not np.allclose(np.asarray(plain.pos),
                               np.asarray(guided.pos))

    def test_zero_scale_identical(self):
        cfg = tiny_cfg()
        trainer = Trainer(cfg)
        graphs, batch = data_and_batch(cfg)
        state = trainer.init_state(jax.random.key(0), batch)
        s = predefined_schedule(cfg)
        fn = trainer.denoise_fn(state.params)
        a = sample(fn, s, cfg, jax.random.key(5), batch)
        b = sample(fn, s, cfg.replace(guidance_scale=0.0),
                   jax.random.key(5), batch)
        np.testing.assert_array_equal(np.asarray(a.pos), np.asarray(b.pos))
