"""High-level api facade tests (train -> generate -> evaluate on CPU)."""

import json
import os

import numpy as np
import pytest

from diffusion_model import api
from diffusion_model.config import Config
from diffusion_model.data.synthetic import synthetic_sio2_dataset


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cfg = Config(
        n_max=8, L=2, m_hidden_size=32, h_hidden_size=32, x_hidden_size=32,
        m_size=16, spectrum_size=24, compressed_spectrum_size=8,
        compressor_hidden_dim=(8,), num_diffusion_timestep=25,
        batch_size=8, lr=1e-3, optimizer="Adam", num_epochs=30,
        noise_precision=0.05, gen_num_per_spectrum=2,
    )
    run_dir = str(tmp_path_factory.mktemp("api_run"))
    graphs = synthetic_sio2_dataset(2, 40, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size)
    trainer, state, splits = api.train(cfg, graphs, run_dir)
    return cfg, run_dir, trainer, state, splits


class TestApi:
    def test_train_artifacts(self, run):
        cfg, run_dir, trainer, state, splits = run
        assert os.path.isdir(os.path.join(run_dir, "checkpoints"))
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(l) for l in f]
        losses = [r["train_loss"] for r in recs if "train_loss" in r]
        assert len(losses) == cfg.num_epochs
        assert losses[-1] < losses[0]

    def test_generate_grouping(self, run):
        cfg, run_dir, trainer, state, (tr, va, te) = run
        results = api.generate(cfg, trainer, state, te, batch_size=4)
        g = cfg.gen_num_per_spectrum
        assert len(results["ids"]) == len(te) * g
        # condition i repeated g times contiguously
        assert results["ids"][0] == results["ids"][g - 1]
        assert results["original_pos"].shape[0] == len(te) * g
        np.testing.assert_allclose(results["original_pos"][0],
                                   results["original_pos"][g - 1])

    def test_evaluate_and_resume(self, run):
        cfg, run_dir, trainer, state, (tr, va, te) = run
        results = api.generate(cfg, trainer, state, te, batch_size=4)
        summary = api.evaluate(results, run_dir, create_xyz=True)
        assert summary["num_accepted"] >= 0
        if summary["num_accepted"]:
            assert np.isfinite(summary["sorted_rmsd"][0][1])
            assert os.path.isfile(os.path.join(run_dir, "first_min_rmsd.xyz"))

        # resume from checkpoint: same eval params -> same denoise output
        from diffusion_model.data.batch import collate

        example = collate(te[:1], cfg.n_max)
        trainer2, state2 = api.load_trained(run_dir, cfg, example)
        import jax

        for a, b in zip(jax.tree.leaves(state.params),
                        jax.tree.leaves(state2.params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_record_schedule(self, run):
        cfg, run_dir, trainer, state, _ = run
        paths = api.record_schedule(cfg, trainer, state, run_dir)
        assert set(paths) == {"alpha", "sigma", "SNR"}
        assert all(os.path.isfile(p) for p in paths.values())

    def test_fit_n_max(self):
        graphs = synthetic_sio2_dataset(0, 5, 12, spectrum_size=8, shells=2)
        n = api.fit_n_max(graphs)
        assert n % 8 == 0
        assert n >= max(g["pos"].shape[0] for g in graphs)


class TestResume:
    @pytest.mark.slow
    def test_mid_training_resume(self, tmp_path):
        """Interrupt at epoch 6, resume to 12; metrics show both phases."""
        cfg = Config(
            n_max=8, L=1, m_hidden_size=16, h_hidden_size=16,
            x_hidden_size=16, m_size=8, spectrum_size=16,
            compressed_spectrum_size=8, compressor_hidden_dim=(8,),
            num_diffusion_timestep=10, batch_size=8, lr=1e-3,
            optimizer="Adam", checkpoint_every=3,
        )
        run_dir = str(tmp_path / "resume_run")
        graphs = synthetic_sio2_dataset(4, 24, cfg.n_max,
                                        spectrum_size=cfg.spectrum_size)
        trainer, state6, _ = api.train(cfg, graphs, run_dir, num_epochs=6)
        assert int(state6.step) > 0
        trainer, state12, _ = api.train(cfg, graphs, run_dir,
                                        num_epochs=12, resume=True)
        # resumed training advanced the optimizer step counter beyond the
        # first phase's
        assert int(state12.step) > int(state6.step)
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            steps = [json.loads(l).get("step") for l in f
                     if "train_loss" in l]
        assert max(steps) == 11
        # resume started at epoch 6, not 0
        assert steps.count(0) == 1


class TestNanRecovery:
    def test_rollback_on_divergence(self, tmp_path, monkeypatch):
        """A non-finite epoch rolls back to the last good state."""
        cfg = Config(
            n_max=8, L=1, m_hidden_size=16, h_hidden_size=16,
            x_hidden_size=16, m_size=8, spectrum_size=16,
            compressed_spectrum_size=8, compressor_hidden_dim=(8,),
            num_diffusion_timestep=10, batch_size=8, optimizer="Adam",
        )
        graphs = synthetic_sio2_dataset(3, 16, cfg.n_max,
                                        spectrum_size=cfg.spectrum_size)
        from diffusion_model.train import Trainer

        calls = {"n": 0}
        orig = Trainer.train_epoch

        def flaky(self, state, key, batches, mesh=None):
            calls["n"] += 1
            if calls["n"] == 2:  # second epoch "diverges"
                return state, float("nan")
            return orig(self, state, key, batches, mesh=mesh)

        monkeypatch.setattr(Trainer, "train_epoch", flaky)
        run_dir = str(tmp_path / "nanrun")
        trainer, state, _ = api.train(cfg, graphs, run_dir, num_epochs=4)
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(l) for l in f]
        assert any("nan_recovery" in r for r in recs)
        finite_epochs = [r for r in recs if "train_loss" in r]
        assert len(finite_epochs) == 3  # epoch 2 rolled back, others logged
        assert all(np.isfinite(r["train_loss"]) for r in finite_epochs)


class TestTrajectory:
    @pytest.mark.slow
    def test_generate_trajectory_and_movie(self, tmp_path):
        from diffusion_model.data.xyz import write_xyz_trajectory

        cfg = Config(
            n_max=8, L=1, m_hidden_size=16, h_hidden_size=16,
            x_hidden_size=16, m_size=8, spectrum_size=16,
            compressed_spectrum_size=8, compressor_hidden_dim=(8,),
            num_diffusion_timestep=20, snapshot_every=5, batch_size=8,
            optimizer="Adam", noise_precision=0.05, gen_num_per_spectrum=1,
        )
        graphs = synthetic_sio2_dataset(5, 16, cfg.n_max,
                                        spectrum_size=cfg.spectrum_size)
        trainer, state, (tr, va, te) = api.train(
            cfg, graphs, str(tmp_path / "t"), num_epochs=1
        )
        results = api.generate(cfg, trainer, state, te,
                               return_trajectory=True)
        traj = results["trajectory_pos"]
        assert traj.shape[0] == 4  # 20 steps / snapshot_every 5
        assert traj.shape[1] == len(results["ids"])
        movie = str(tmp_path / "movie.xyz")
        write_xyz_trajectory(movie, traj[:, 0],
                             results["generated_species"][0])
        content = open(movie).read()
        assert content.count("frame") == 4


class TestSizePrediction:
    @pytest.mark.slow
    def test_generate_with_predicted_sizes(self, tmp_path):
        """Full predicted-size pipeline: CN MLP chooses the atom count
        (the reference hardcodes the true size with a 'should be
        predicted' comment, ref parts/train_per_iretation.py:291-292)."""
        import jax
        import jax.numpy as jnp
        import optax

        from diffusion_model.nn import CNPredictor

        cfg = Config(
            n_max=8, L=1, m_hidden_size=16, h_hidden_size=16,
            x_hidden_size=16, m_size=8, spectrum_size=24,
            compressed_spectrum_size=8, compressor_hidden_dim=(8,),
            num_diffusion_timestep=5, batch_size=8, optimizer="Adam",
            noise_precision=0.05, gen_num_per_spectrum=1,
        )
        graphs = synthetic_sio2_dataset(6, 48, cfg.n_max,
                                        spectrum_size=cfg.spectrum_size)
        trainer, state, (tr, va, te) = api.train(
            cfg, graphs, str(tmp_path / "s"), num_epochs=1
        )

        # train the CN predictor on the spectra -> atom counts
        cn = CNPredictor(hidden_dims=(32, 16))
        x = jnp.asarray(np.stack([g["spectrum"][0] for g in tr]))
        y = jnp.asarray([[float(g["pos"].shape[0])] for g in tr])
        params = cn.init(jax.random.key(0), x)
        opt = optax.adam(1e-2)
        ost = opt.init(params)

        @jax.jit
        def step(p, o):
            loss, grads = jax.value_and_grad(
                lambda q: jnp.mean((cn.apply(q, x) - y) ** 2)
            )(p)
            up, o = opt.update(grads, o)
            return optax.apply_updates(p, up), o, loss

        for _ in range(300):
            params, ost, loss = step(params, ost)
        # predictor learned the CN-encoding spectra
        pred = np.round(np.asarray(cn.apply(params, x))[:, 0])
        truth = np.asarray(y)[:, 0]
        assert (pred == truth).mean() > 0.7

        results = api.generate(cfg, trainer, state, te,
                               size_predictor=(cn, params))
        sizes = np.asarray(results["mask"]).sum(-1)
        want = np.clip(np.round(np.asarray(
            cn.apply(params, jnp.asarray(
                np.stack([g["spectrum"][0] for g in te])
            ))
        )[:, 0]), 2, cfg.n_max)
        np.testing.assert_array_equal(sizes, want)
