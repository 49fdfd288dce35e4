"""Fixed-degree kNN message-passing path (large-cell topology)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffusion_model.config import Config
from diffusion_model.data.batch import collate
from diffusion_model.data.split import batch_iterator
from diffusion_model.data.synthetic import (
    amorphous_cell,
    synthetic_sio2_dataset,
)
from diffusion_model.diffusion import predefined_schedule, sample
from diffusion_model.nn import DiffusionDenoiser
from diffusion_model.ops import dense_pair_mask, knn_edges
from diffusion_model.train import Trainer


def tiny_cfg(**kw):
    base = dict(
        n_max=12, L=2, m_hidden_size=32, h_hidden_size=32, x_hidden_size=32,
        m_size=16, spectrum_size=16, compressed_spectrum_size=8,
        compressor_hidden_dim=(8,), num_diffusion_timestep=10,
        batch_size=2, optimizer="Adam", noise_precision=0.05,
    )
    base.update(kw)
    return Config(**base)


class TestKnnEquivalence:
    @pytest.mark.slow
    def test_full_k_matches_dense(self, rng):
        """K = N-1 neighbour lists must reproduce the dense result exactly
        (same edges, same math)."""
        cfg = tiny_cfg()
        model = DiffusionDenoiser(cfg)
        graphs = synthetic_sio2_dataset(0, 2, cfg.n_max,
                                        spectrum_size=cfg.spectrum_size,
                                        shells=2)
        batch = collate(graphs, cfg.n_max)
        b, n = batch.mask.shape
        t_norm = jnp.full((b, n, 1), 0.3) * batch.mask[..., None]
        species = jnp.asarray(rng.normal(size=(b, n, 2)), jnp.float32)
        pos = jnp.asarray(rng.normal(size=(b, n, 3)), jnp.float32)
        args_head = (species, pos, batch.spectrum, batch.exo, t_norm,
                     batch.mask)
        params = model.init(jax.random.key(0), *args_head,
                            batch.pair_mask())
        dense_out = model.apply(params, *args_head, batch.pair_mask())
        edges = knn_edges(pos, batch.mask, cfg.n_max - 1)
        knn_out = model.apply(params, *args_head, edges)
        np.testing.assert_allclose(np.asarray(dense_out[0]),
                                   np.asarray(knn_out[0]),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(np.asarray(dense_out[1]),
                                   np.asarray(knn_out[1]),
                                   rtol=2e-4, atol=2e-5)

    @pytest.mark.slow
    def test_knn_training_and_sampling(self):
        cfg = tiny_cfg(neighbor_k=4)
        trainer = Trainer(cfg)
        graphs = synthetic_sio2_dataset(1, 4, cfg.n_max,
                                        spectrum_size=cfg.spectrum_size,
                                        shells=2)
        batch = next(batch_iterator(graphs, cfg.batch_size, cfg.n_max))
        state = trainer.init_state(jax.random.key(0), batch)
        state, m = trainer.train_step(state, jax.random.key(1), batch)
        assert np.isfinite(float(m["loss"]))
        s = predefined_schedule(cfg)
        res = sample(trainer.denoise_fn(state.params), s, cfg,
                     jax.random.key(2), batch)
        assert bool(jnp.all(res.finite))

    @pytest.mark.slow
    def test_large_cell_smoke(self):
        """Config #4 shape: a big padded cell through the kNN path."""
        cfg = tiny_cfg(n_max=128, neighbor_k=8, batch_size=1)
        trainer = Trainer(cfg)
        cell = amorphous_cell(seed=0, num_atoms=100,
                              spectrum_size=cfg.spectrum_size)
        batch = next(batch_iterator([cell], 1, cfg.n_max))
        state = trainer.init_state(jax.random.key(0), batch)
        state, m = trainer.train_step(state, jax.random.key(1), batch)
        assert np.isfinite(float(m["loss"]))


def test_generate_2048_atoms_through_xla():
    """The large-cell recipe (kNN + h_residual + virtual_node) at 2048
    atoms samples through ``api.generate``, whose chain is the plain
    sampler over ``Trainer.denoise_fn``: same key, same structure."""
    from diffusion_model import api

    cfg = tiny_cfg(n_max=2048, neighbor_k=8, h_residual=True,
                   virtual_node=True, sample_steps=3, batch_size=1,
                   max_nan_retries=0)
    cell = amorphous_cell(seed=0, num_atoms=2048,
                          spectrum_size=cfg.spectrum_size)
    cond = collate([cell], cfg.n_max)
    trainer = Trainer(cfg)
    state = trainer.init_state(jax.random.key(0), cond)
    res = api.generate(cfg, trainer, state, [cell], key=jax.random.key(1),
                       gen_num_per_spectrum=1, batch_size=1)
    assert res["generated_pos"].shape == (1, 2048, 3)
    assert np.isfinite(res["generated_pos"]).all()
    params = state.eval_params(cfg)
    direct = jax.jit(lambda k: sample(
        trainer.denoise_fn(params), trainer.schedule_for(params), cfg, k,
        cond))(jax.random.split(jax.random.key(1))[1])
    np.testing.assert_allclose(res["generated_pos"], np.asarray(direct.pos),
                               rtol=1e-6, atol=1e-6)
