"""Portable .npz parameter snapshots (train/checkpoint.py).

Run-dir checkpoints carry optimizer state and are tied to a TrainState
template; the flat npz snapshot is the durable, git-committable artifact
behind the quality claims. These tests pin the roundtrip: tree
structure, f16 storage tolerance, embedded config, and that a restored
snapshot actually drives the sampler.
"""

import jax
import numpy as np

from diffusion_model.config import Config
from diffusion_model.data.split import batch_iterator
from diffusion_model.data.synthetic import synthetic_sio2_dataset
from diffusion_model.diffusion import sample
from diffusion_model.train import Trainer
from diffusion_model.train.checkpoint import (
    load_config_npz,
    load_params_npz,
    save_params_npz,
)


def tiny_cfg(**kw):
    base = dict(
        n_max=8, L=2, m_hidden_size=32, h_hidden_size=32, x_hidden_size=32,
        m_size=16, spectrum_size=32, compressed_spectrum_size=8,
        compressor_hidden_dim=(16,), num_diffusion_timestep=20,
        batch_size=4, lr=1e-3, optimizer="Adam", noise_precision=0.05,
    )
    base.update(kw)
    return Config(**base)


class TestParamsNpz:
    def test_roundtrip_and_sampling(self, tmp_path):
        cfg = tiny_cfg()
        trainer = Trainer(cfg)
        graphs = synthetic_sio2_dataset(0, 8, cfg.n_max,
                                        spectrum_size=cfg.spectrum_size)
        batch = next(batch_iterator(graphs, cfg.batch_size, cfg.n_max))
        # one Adam step at lr 1e-3 from a random init sends some draws'
        # reverse chains to NaN (2 of init keys 0-7 before the plain-JAX
        # port, 3 after); key 2 is a draw whose one-step model samples
        # finitely, which the restore check below needs
        state = trainer.init_state(jax.random.key(2), batch)
        state, _ = trainer.train_step(state, jax.random.key(1), batch)
        eval_params = state.eval_params(cfg)

        path = str(tmp_path / "snap.npz")
        n = save_params_npz(eval_params, path, cfg=cfg)
        assert n == len(jax.tree.leaves(eval_params))

        loaded = load_params_npz(path)
        # same tree structure, f16 storage tolerance
        flat_a = jax.tree_util.tree_flatten_with_path(eval_params)[0]
        flat_b = jax.tree_util.tree_flatten_with_path(loaded)[0]
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (p, a), (_, b) in zip(flat_a, flat_b):
            np.testing.assert_allclose(
                np.asarray(a), b, rtol=2e-3, atol=2e-3,
                err_msg=jax.tree_util.keystr(p))

        cfg2 = load_config_npz(path)
        assert cfg2 == cfg

        # a snapshot restores to a working sampler
        res = sample(trainer.denoise_fn(loaded),
                     trainer.schedule_for(loaded), cfg2,
                     jax.random.key(3), batch)
        assert bool(np.all(np.asarray(res.finite)))

    def test_no_config_returns_none(self, tmp_path):
        cfg = tiny_cfg()
        trainer = Trainer(cfg)
        graphs = synthetic_sio2_dataset(0, 4, cfg.n_max,
                                        spectrum_size=cfg.spectrum_size)
        batch = next(batch_iterator(graphs, cfg.batch_size, cfg.n_max))
        state = trainer.init_state(jax.random.key(0), batch)
        path = str(tmp_path / "bare.npz")
        save_params_npz(state.eval_params(cfg), path)
        assert load_config_npz(path) is None
        assert load_params_npz(path)  # still loads

    def test_no_pickle_required(self, tmp_path):
        """A committed artifact must be readable with allow_pickle=False
        (numpy's default) — the config is stored as a unicode scalar,
        never dtype=object; legacy object-dtype snapshots still load
        through the fallback in load_config_npz."""
        import json

        cfg = tiny_cfg()
        trainer = Trainer(cfg)
        graphs = synthetic_sio2_dataset(0, 4, cfg.n_max,
                                        spectrum_size=cfg.spectrum_size)
        batch = next(batch_iterator(graphs, cfg.batch_size, cfg.n_max))
        state = trainer.init_state(jax.random.key(0), batch)
        params = state.eval_params(cfg)

        path = str(tmp_path / "snap.npz")
        save_params_npz(params, path, cfg=cfg)
        with np.load(path) as z:  # allow_pickle defaults to False
            assert z["__config_json__"].dtype.kind == "U"
            for k in z.files:
                z[k]
        assert load_config_npz(path) == cfg

        # legacy format: object-dtype config key
        legacy = str(tmp_path / "legacy.npz")
        flat = {}
        with np.load(path) as z:
            for k in z.files:
                flat[k] = z[k]
        flat["__config_json__"] = np.array(
            json.dumps(cfg.to_dict()), dtype=object)
        np.savez_compressed(legacy, **flat)
        assert load_config_npz(legacy) == cfg
        assert load_params_npz(legacy)
