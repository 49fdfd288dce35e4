"""Every evaluator CLI must run end-to-end over a real finished run dir
(the reference's evaluators are standalone wandb-keyed CLIs,
ref evaluate_RDF.py:126-144 etc. — here they key off --run_dir)."""

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
    noise_precision=0.05, gen_num_per_spectrum=2, num_epochs=2,
)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """One micro train_and_generate run shared by every evaluator test."""
    root = tmp_path_factory.mktemp("evalcli")
    cfg_path = root / "micro.yaml"
    cfg_path.write_text(yaml.safe_dump(MICRO_CFG))
    rd = str(root / "run")
    cli_main.main([
        "--mode", "train_and_generate", "--run_dir", rd,
        "--config", str(cfg_path), "--synthetic", "24",
        "--create_xyz_file",
    ])
    return rd


class TestEvaluatorCLIs:
    def test_evaluate_rdf(self, run_dir, capsys):
        from diffusion_model.cli.evaluate_rdf import main

        main(["--run_dir", run_dir])
        assert "rdf cos" in capsys.readouterr().out

    def test_evaluate_rdf_all_metrics(self, run_dir, capsys):
        from diffusion_model.cli.evaluate_rdf import main

        for metric in ("euclidean", "mse", "wasserstein"):
            main(["--run_dir", run_dir, "--metric", metric])
        assert "rdf" in capsys.readouterr().out

    def test_evaluate_cn2(self, run_dir, capsys):
        from diffusion_model.cli.evaluate_cn2 import main

        main(["--run_dir", run_dir])
        out = capsys.readouterr().out
        assert "angle" in out or "CN2" in out

    def test_evaluate_rmsd(self, run_dir, capsys):
        from diffusion_model.cli.evaluate_rmsd import main

        main(["--run_dir", run_dir])
        out = capsys.readouterr().out.lower()
        # prints the sorted best/mid/worst RMSD triple
        assert "best" in out and "worst" in out

    def test_evaluate_si_o_si(self, run_dir, capsys):
        from diffusion_model.cli.evaluate_si_o_si import main

        main(["--run_dir", run_dir])
        out = capsys.readouterr().out.lower()
        # a 2-epoch micro model rarely generates 2-Si-coordinated exO
        # structures; the CLI must say so rather than crash
        assert "si-o-si" in out or "2-si-coordinated" in out

    def test_evaluate_fingerprint_both_methods(self, run_dir, capsys):
        from diffusion_model.cli.evaluate_fingerprint import main

        main(["--run_dir", run_dir])
        main(["--run_dir", run_dir, "--method", "morgan"])
        assert "similarity" in capsys.readouterr().out.lower()

    def test_create_xyz(self, run_dir, tmp_path):
        from diffusion_model.cli.create_xyz import main

        out_dir = str(tmp_path / "xyz")
        main(["--run_dir", run_dir, "--out_dir", out_dir])
        # one subdirectory of aligned original/generated xyz per sample
        # (ref create_xyz.py writes pair dirs)
        subdirs = [os.path.join(out_dir, d) for d in os.listdir(out_dir)]
        assert subdirs
        assert any(
            f.endswith(".xyz")
            for d in subdirs if os.path.isdir(d) for f in os.listdir(d)
        )

    def test_template_matching(self, run_dir, tmp_path, capsys):
        from diffusion_model.cli.template_matching import main

        ref = synthetic_sio2_dataset(5, 12, 8, spectrum_size=16)
        tgt = synthetic_sio2_dataset(6, 4, 8, spectrum_size=16)
        ref_path = str(tmp_path / "ref.npz")
        tgt_path = str(tmp_path / "tgt.npz")
        save_dataset(ref, ref_path)
        save_dataset(tgt, tgt_path)
        save_dir = str(tmp_path / "tm")
        main(["--reference_dataset_path", ref_path,
              "--target_dataset_path", tgt_path,
              "--save_dir", save_dir])
        assert os.path.isdir(save_dir)

    def test_artifacts_registry_updated(self, run_dir):
        """Evaluator CLIs register their figures/outputs like the
        reference's wandb.config.update (ref evaluate_RDF.py:132-137)."""
        with open(os.path.join(run_dir, "artifacts.json")) as f:
            artifacts = json.load(f)
        assert len(artifacts) >= 2
