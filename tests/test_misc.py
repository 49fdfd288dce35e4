"""Misc coverage: legacy npy ingestion, dataset IO roundtrip,
config loading, logging."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffusion_model.config import Config, from_dict, load_config
from diffusion_model.data.batch import collate
from diffusion_model.data.io import load_dataset, resize_spectra, save_dataset
from diffusion_model.data.legacy import npy_to_graphs
from diffusion_model.data.synthetic import synthetic_sio2_dataset
from diffusion_model.nn import DiffusionDenoiser
from diffusion_model.utils.logging import RunLogger, load_run_config


class TestLegacyNpy:
    def test_npy_to_graphs(self, rng):
        records = [
            ("mp-1", rng.random(20), [
                ([1, 0], [0.0, 0, 0]), ([0, 1], [1.6, 0, 0]),
            ]),
            ("mp-2", rng.random(20), [([1, 0], [0.0, 0, 0])]),  # CN0 drop
        ]
        graphs = npy_to_graphs(records)
        assert len(graphs) == 1
        g = graphs[0]
        assert g["id"] == "mp-1"
        assert g["pos"].shape == (2, 3)
        # every node carries the spectrum (legacy layout)
        np.testing.assert_allclose(g["spectrum"][0], g["spectrum"][1])


class TestDatasetIO:
    def test_roundtrip(self, tmp_path):
        ds = synthetic_sio2_dataset(0, 4, n_max=10, spectrum_size=16)
        path = str(tmp_path / "ds.npz")
        save_dataset(ds, path)
        back = load_dataset(path)
        assert len(back) == 4
        for a, b in zip(ds, back):
            np.testing.assert_allclose(a["pos"], b["pos"])
            assert a["id"] == b["id"]

    def test_resize_spectra(self):
        ds = synthetic_sio2_dataset(0, 2, n_max=10, spectrum_size=32)
        out = resize_spectra(ds, 16)
        assert out[0]["spectrum"].shape[1] == 16


class TestConfigIO:
    def test_reference_yaml_loads(self):
        cfg = load_config("configs/parameters.yaml")
        assert cfg.L == 5
        assert cfg.h_size == 36  # 2 + 32 + 1 + 1
        assert cfg.m_input_size == 73
        assert cfg.h_input_size == 292
        assert cfg.optimizer == "RAdamScheduleFree"

    def test_from_dict_ignores_unknown(self):
        cfg = from_dict({"L": 3, "wandb_run_id": "abc"})
        assert cfg.L == 3


class TestRunLogger:
    def test_roundtrip(self, tmp_path):
        cfg = Config(L=3)
        run_dir = str(tmp_path / "run")
        logger = RunLogger(run_dir, cfg, notes="hello")
        logger.log({"loss": 1.5}, step=0)
        logger.register_artifact("model", "/tmp/x.pth")
        assert logger.artifact("model") == "/tmp/x.pth"
        cfg2 = load_run_config(run_dir)
        assert cfg2.L == 3
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            rec = json.loads(f.readline())
        assert rec["loss"] == 1.5


class TestProfiling:
    def test_phase_timer_accumulates(self):
        import time

        from diffusion_model.utils.profiling import PhaseTimer

        t = PhaseTimer()
        for _ in range(3):
            with t.phase("work"):
                time.sleep(0.01)
        with t.phase("other"):
            pass
        rep = t.report()
        assert rep["work"]["count"] == 3
        assert rep["work"]["total_s"] >= 0.03
        # report rounds total and mean independently
        assert rep["work"]["mean_s"] == pytest.approx(
            rep["work"]["total_s"] / 3, rel=2e-2)
        assert rep["other"]["count"] == 1

    def test_annotate_inside_jit(self):
        import jax
        import jax.numpy as jnp

        from diffusion_model.utils.profiling import annotate

        def f(x):
            with annotate("block"):
                return x * 2

        assert float(jax.jit(f)(jnp.asarray(3.0))) == 6.0

    @pytest.mark.slow
    def test_api_train_writes_profile(self, tmp_path):
        from diffusion_model import api
        from diffusion_model.data.synthetic import synthetic_sio2_dataset

        cfg = Config(
            n_max=5, L=1, m_hidden_size=8, h_hidden_size=8,
            x_hidden_size=8, m_size=4, spectrum_size=8,
            compressed_spectrum_size=4, compressor_hidden_dim=(4,),
            num_diffusion_timestep=4, batch_size=8, optimizer="Adam",
        )
        graphs = synthetic_sio2_dataset(0, 16, cfg.n_max,
                                        spectrum_size=cfg.spectrum_size)
        rd = str(tmp_path / "run")
        api.train(cfg, graphs, rd, num_epochs=2)
        with open(os.path.join(rd, "profile.json")) as f:
            prof = json.load(f)
        assert prof["train_epoch"]["count"] == 2
        assert prof["checkpoint"]["count"] >= 1


class TestFramesAndLegacySchedules:
    def test_center_of_mass(self):
        from diffusion_model.data.frames import center_of_mass

        pos = np.array([[0.0, 0, 0], [1.0, 0, 0]])
        com = center_of_mass(pos, ["O", "Si"])
        # weighted toward Si (28.0855 vs 16)
        assert com[0] == pytest.approx(28.0855 / 44.0855, rel=1e-6)

    def test_align_exo_frame(self, rng):
        from diffusion_model.data.frames import (
            align_exo_frame,
            center_of_mass,
        )

        pos = rng.normal(size=(5, 3))
        symbols = ["O", "Si", "Si", "O", "O"]
        out = align_exo_frame(pos, symbols)
        com = center_of_mass(out, symbols)
        v = out[0] - com
        # exO - CoM now along +x
        assert v[1] == pytest.approx(0.0, abs=1e-9)
        assert v[2] == pytest.approx(0.0, abs=1e-9)
        assert v[0] > 0
        # rigid: pairwise distances preserved
        d0 = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        d1 = np.linalg.norm(out[:, None] - out[None], axis=-1)
        np.testing.assert_allclose(d0, d1, rtol=1e-9, atol=1e-9)

    def test_pad_and_flatten(self):
        from diffusion_model.data.frames import pad_and_flatten

        out = pad_and_flatten(np.ones((3, 3)))
        assert out.shape == (15,)
        assert out[:9].sum() == 9 and out[9:].sum() == 0

    def test_beta_schedules(self):
        from diffusion_model.ops.schedules import (
            beta_schedule,
            ddpm_alpha_bar,
        )

        b = np.asarray(beta_schedule("sigmoid", 1e-4, 0.02, 100))
        assert b.shape == (101,)
        assert b[0] == pytest.approx(1e-4 + (0.02 - 1e-4) / (1 + np.e**6),
                                     rel=1e-4)
        assert b[-1] < 0.02 + 1e-6 and np.all(np.diff(b) >= 0)
        lin = np.asarray(beta_schedule("linear", 0.0, 1.0, 10))
        np.testing.assert_allclose(lin, np.linspace(0, 1, 11), rtol=1e-6)
        ab = np.asarray(ddpm_alpha_bar(jnp.asarray(lin)))
        np.testing.assert_allclose(ab, np.cumprod(1 - lin), rtol=1e-5)
        with pytest.raises(ValueError):
            beta_schedule("cosine", 0, 1, 10)


class TestMultiSpecies:
    @pytest.mark.slow
    def test_qm9_style_training_and_sampling(self):
        """atom_type_size=5 path (the reference's QM9 smoke test widens the
        species one-hot to 5, ref main.py:90-95)."""
        from diffusion_model.data.split import batch_iterator
        from diffusion_model.data.synthetic import (
            synthetic_molecule_dataset,
        )
        from diffusion_model.diffusion import predefined_schedule, sample
        from diffusion_model.train import Trainer

        cfg = Config(n_max=10, L=2, m_hidden_size=32, h_hidden_size=32,
                     x_hidden_size=32, m_size=16, spectrum_size=16,
                     compressed_spectrum_size=8, compressor_hidden_dim=(8,),
                     atom_type_size=5, num_diffusion_timestep=10,
                     batch_size=4, optimizer="Adam", noise_precision=0.05)
        assert cfg.h_size == 5 + 8 + 1 + 1
        graphs = synthetic_molecule_dataset(0, 8, cfg.n_max,
                                            atom_type_size=5,
                                            spectrum_size=cfg.spectrum_size)
        assert graphs[0]["species"].shape[1] == 5
        trainer = Trainer(cfg)
        batch = next(batch_iterator(graphs, cfg.batch_size, cfg.n_max))
        state = trainer.init_state(jax.random.key(0), batch)
        state, m = trainer.train_step(state, jax.random.key(1), batch)
        assert np.isfinite(float(m["loss"]))
        res = sample(trainer.denoise_fn(state.params),
                     predefined_schedule(cfg), cfg, jax.random.key(2), batch)
        assert res.species.shape[-1] == 5
        sp = np.asarray(res.species)
        mask = np.asarray(batch.mask)
        assert np.all(sp[mask > 0].sum(-1) == 1)


class TestCachedCell:
    """data/synthetic.cached_cell: disk-memoised generation must return
    the maker's exact payload on miss AND on hit (dtype/value roundtrip
    through the atomic npz), and must not re-invoke the maker on hit."""

    def test_roundtrip_and_single_invocation(self, tmp_path):
        from diffusion_model.data.synthetic import (
            amorphous_network_cell,
            cached_cell,
        )

        calls = []

        def counting_maker(**kw):
            calls.append(kw)
            return amorphous_network_cell(**kw)

        counting_maker.__name__ = "amorphous_network_cell"
        kw = dict(seed=7, num_atoms=24, spectrum_size=16)
        first = cached_cell(counting_maker, str(tmp_path), **kw)
        second = cached_cell(counting_maker, str(tmp_path), **kw)
        assert len(calls) == 1
        assert second["id"] == first["id"] == "network_7"
        assert second["cn"] == first["cn"]
        for k in ("pos", "species", "spectrum", "exo"):
            assert second[k].dtype == first[k].dtype
            np.testing.assert_array_equal(second[k], first[k])
