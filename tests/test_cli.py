"""CLI driver smoke tests (micro configs, CPU)."""

import json
import os

import numpy as np
import pytest

from diffusion_model.cli import main as cli_main
from diffusion_model.data.io import save_dataset
from diffusion_model.data.synthetic import synthetic_sio2_dataset

# config files are YAML; the package itself does not need PyYAML
yaml = pytest.importorskip("yaml")

MICRO_CFG = dict(
    L=1, m_hidden_size=16, h_hidden_size=16, x_hidden_size=16, m_size=8,
    spectrum_size=16, compressed_spectrum_size=8, compressor_hidden_dim=[8],
    num_diffusion_timestep=4, batch_size=8, lr=1e-3, optimizer="Adam",
    noise_precision=0.05, gen_num_per_spectrum=1, num_epochs=2,
)


@pytest.fixture
def micro_yaml(tmp_path):
    p = tmp_path / "micro.yaml"
    p.write_text(yaml.safe_dump(MICRO_CFG))
    return str(p)


class TestMainCLI:
    @pytest.mark.slow
    def test_train_and_generate_then_evaluate_only(self, tmp_path,
                                                   micro_yaml):
        run_dir = str(tmp_path / "run")
        cli_main.main([
            "--mode", "train_and_generate", "--run_dir", run_dir,
            "--config", micro_yaml, "--synthetic", "24",
            "--create_xyz_file",
        ])
        assert os.path.isfile(os.path.join(run_dir, "generated.npz"))
        assert os.path.isfile(os.path.join(run_dir, "config.json"))
        with open(os.path.join(run_dir, "artifacts.json")) as f:
            arts = json.load(f)
        assert "generated_graph_save_path" in arts

        # evaluate_only resumes from run-dir state
        cli_main.main([
            "--mode", "evaluate_only", "--run_dir", run_dir,
            "--synthetic", "24",
        ])

    @pytest.mark.slow
    def test_dataset_npz_path(self, tmp_path, micro_yaml):
        ds = synthetic_sio2_dataset(0, 16, 8, spectrum_size=16)
        ds_path = str(tmp_path / "ds.npz")
        save_dataset(ds, ds_path)
        run_dir = str(tmp_path / "run2")
        cli_main.main([
            "--mode", "train_only", "--run_dir", run_dir,
            "--config", micro_yaml, "--dataset_path", ds_path,
            "--num_epochs", "1",
        ])
        assert os.path.isdir(os.path.join(run_dir, "checkpoints"))

    def test_missing_data_exits(self, tmp_path, micro_yaml):
        with pytest.raises(SystemExit):
            cli_main.main([
                "--mode", "train_only", "--run_dir", str(tmp_path / "x"),
                "--config", micro_yaml,
            ])


class TestGenerateAmorphousCLI:
    @pytest.mark.slow
    def test_runs_on_trained_dir(self, tmp_path, micro_yaml):
        from diffusion_model.cli import generate_amorphous

        run_dir = str(tmp_path / "run3")
        cli_main.main([
            "--mode", "train_only", "--run_dir", run_dir,
            "--config", micro_yaml, "--synthetic", "24",
        ])
        generate_amorphous.main([
            "--run_dir", run_dir, "--synthetic", "8",
            "--gen_num_per_spectrum", "1",
        ])
        assert os.path.isfile(
            os.path.join(run_dir, "generated_amorphous.npz")
        )

    @pytest.mark.slow
    def test_amorphous_conditions_with_panel(self, tmp_path, micro_yaml):
        """--amorphous N --generator network --panel: CRN conditions,
        chunked sampling, structural panel + in-protocol RDF ceiling."""
        import json

        from diffusion_model.cli import generate_amorphous

        run_dir = str(tmp_path / "run3b")
        cli_main.main([
            "--mode", "train_only", "--run_dir", run_dir,
            "--config", micro_yaml, "--synthetic", "24",
        ])
        generate_amorphous.main([
            "--run_dir", run_dir, "--amorphous", "3", "--num_atoms", "24",
            "--generator", "network", "--gen_num_per_spectrum", "1",
            "--batch_size", "2", "--panel",
        ])
        panel_path = os.path.join(run_dir, "amorphous_panel.json")
        assert os.path.isfile(panel_path)
        panel = json.load(open(panel_path))
        assert "finite_fraction" in panel
        if panel["accepted"]:
            assert "rdf_ceiling" in panel
            assert 0.0 < panel["rdf_ceiling"]["mean"] <= 1.0
            assert "pair_dist_w1" in panel["panel"]

    @pytest.mark.slow
    def test_ring_route(self, tmp_path, micro_yaml):
        """--ring samples through the ppermute ring (api.generate_ring):
        the CLI route for cells whose pair grid exceeds one chip —
        exercised here on the 8-device virtual mesh (fit_n_max rounds to
        a multiple of 8, so the node axis shards evenly)."""
        from diffusion_model.cli import generate_amorphous

        run_dir = str(tmp_path / "run_ring")
        cli_main.main([
            "--mode", "train_only", "--run_dir", run_dir,
            "--config", micro_yaml, "--synthetic", "24",
        ])
        generate_amorphous.main([
            "--run_dir", run_dir, "--synthetic", "2",
            "--gen_num_per_spectrum", "1", "--ring",
        ])
        out = os.path.join(run_dir, "generated_amorphous.npz")
        assert os.path.isfile(out)
        z = np.load(out)
        assert z["generated_pos"].shape[0] == 2
        assert np.isfinite(z["generated_pos"]).all()


class TestCNCLI:
    def test_cn_predictor_trains(self, capsys):
        from diffusion_model.cli import cn

        cn.main(["--synthetic", "64", "--epochs", "60"])
        out = capsys.readouterr().out
        assert "test MAE" in out

    def test_cn_predictor_f1_bar(self):
        """Numeric pin for nn/cn_mlp.py (ref CN.py:79-137 semantics:
        spectrum(200) -> [100,100,50,25] -> 1 regression, macro-F1 on the
        rounded prediction): a seeded 400-epoch train on synthetic spectra
        (whose peak positions encode CN, data/synthetic.py) must recover
        the atom count nearly perfectly — measured 1.00 F1 / 0.05 MAE at
        this budget, asserted with slack."""
        import jax
        import jax.numpy as jnp
        import optax

        from diffusion_model.cli.cn import graphs_to_xy, macro_f1
        from diffusion_model.data.split import split_dataset
        from diffusion_model.data.synthetic import synthetic_sio2_dataset
        from diffusion_model.nn import CNPredictor

        graphs = synthetic_sio2_dataset(2024, 256, 16, spectrum_size=200)
        train_g, _, test_g = split_dataset(graphs, 2024)
        x_tr, y_tr = graphs_to_xy(train_g)
        x_te, y_te = graphs_to_xy(test_g)

        model = CNPredictor()
        # architecture pin: the reference's hidden stack
        assert tuple(model.hidden_dims) == (100, 100, 50, 25)
        params = model.init(jax.random.key(2024), x_tr[:1])
        opt = optax.adam(1e-3)
        opt_state = opt.init(params)

        @jax.jit
        def step(params, opt_state):
            loss, grads = jax.value_and_grad(
                lambda p: jnp.mean((model.apply(p, x_tr) - y_tr) ** 2)
            )(params)
            updates, opt_state = opt.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        for _ in range(400):
            params, opt_state, _ = step(params, opt_state)

        pred = np.asarray(model.apply(params, x_te))[:, 0]
        truth = np.asarray(y_te)[:, 0]
        mae = float(np.mean(np.abs(pred - truth)))
        f1 = macro_f1(truth.astype(int), np.round(pred).astype(int))
        assert mae <= 0.25, mae
        assert f1 >= 0.9, f1
