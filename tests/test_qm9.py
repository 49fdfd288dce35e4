"""QM9 (GDB-9) raw-xyz ingestion tests (ref main.py:43,90-95,145-152)."""

import os

import numpy as np
import pytest

from diffusion_model.data.qm9 import (
    QM9_PROPERTY_NAMES,
    QM9_SPECIES,
    load_qm9_dataset,
    read_qm9_xyz,
)

# config files are YAML; the package itself does not need PyYAML
yaml = pytest.importorskip("yaml")

# A real-format GDB-9 entry (methane-like), including the *^ exponent wart
# and the frequency/SMILES/InChI trailer lines the parser must skip.
GDB9_TEMPLATE = """{na}
gdb {idx}\t157.7\t157.7\t157.7\t0.\t13.21\t-0.3877\t0.1171\t0.5048\t35.36\t0.044749\t-40.47893\t-40.476062\t-40.475117\t-40.498597\t6.469
{atoms}
100.1\t200.2\t300.3
C\tC
InChI=1S/CH4/h1H4\tInChI=1S/CH4/h1H4
"""


def write_gdb9(path, idx, elems, coords, charges=None):
    charges = charges or ["-0.535689"] * len(elems)
    atoms = "\n".join(
        f"{e}\t{x}\t{y}\t{z}\t{q}"
        for e, (x, y, z), q in zip(elems, coords, charges)
    )
    path.write_text(GDB9_TEMPLATE.format(na=len(elems), idx=idx,
                                         atoms=atoms))


@pytest.fixture
def qm9_dir(tmp_path):
    d = tmp_path / "qm9"
    d.mkdir()
    rng = np.random.default_rng(7)
    pool = list(QM9_SPECIES)
    for i in range(8):
        n = int(rng.integers(3, 7))
        elems = [pool[j] for j in rng.integers(0, len(pool), n)]
        coords = np.round(rng.normal(0, 1.2, (n, 3)), 6)
        write_gdb9(d / f"dsgdb9nsd_{i:06d}.xyz", i + 1, elems, coords)
    return str(d)


class TestReadQm9:
    def test_parses_species_positions_properties(self, tmp_path):
        p = tmp_path / "mol.xyz"
        write_gdb9(p, 42, ["C", "H", "H", "H", "H"],
                   [(0, 0, 0), (0.63, 0.63, 0.63), (-0.63, -0.63, 0.63),
                    (0.63, -0.63, -0.63), (-0.63, 0.63, -0.63)])
        g = read_qm9_xyz(str(p), spectrum_size=16)
        assert g["pos"].shape == (5, 3)
        assert g["species"].shape == (5, len(QM9_SPECIES))
        # PyG one-hot order H,C,N,O,F: first atom is C -> column 1
        assert g["species"][0].tolist() == [0, 1, 0, 0, 0]
        assert g["species"][1].tolist() == [1, 0, 0, 0, 0]
        np.testing.assert_allclose(g["pos"][1], [0.63, 0.63, 0.63])
        assert g["spectrum"].shape == (5, 16)
        assert not g["spectrum"].any() and not g["exo"].any()
        assert g["id"] == "gdb_42"
        assert set(g["properties"]) == set(QM9_PROPERTY_NAMES)
        assert g["properties"]["mu"] == 0.0
        assert g["properties"]["Cv"] == pytest.approx(6.469)

    def test_star_caret_exponent(self, tmp_path):
        p = tmp_path / "mol.xyz"
        write_gdb9(p, 1, ["N", "H"], [("1.6991*^-6", 0, 0), (1, 0, 0)])
        g = read_qm9_xyz(str(p))
        assert g["pos"][0, 0] == pytest.approx(1.6991e-6)

    def test_rejects_unknown_element(self, tmp_path):
        p = tmp_path / "mol.xyz"
        write_gdb9(p, 1, ["Si", "O"], [(0, 0, 0), (1, 0, 0)])
        with pytest.raises(ValueError, match="unexpected element"):
            read_qm9_xyz(str(p))

    def test_rejects_truncated_file(self, tmp_path):
        p = tmp_path / "mol.xyz"
        write_gdb9(p, 1, ["C", "H"], [(0, 0, 0), (1, 0, 0)])
        lines = p.read_text().splitlines()[:3]  # drop the 2nd atom
        p.write_text("\n".join(lines))
        with pytest.raises(ValueError, match="declares 2 atoms"):
            read_qm9_xyz(str(p))


class TestLoadQm9Dataset:
    def test_loads_directory_sorted(self, qm9_dir):
        graphs = load_qm9_dataset(qm9_dir, spectrum_size=16)
        assert len(graphs) == 8
        assert graphs[0]["id"] == "gdb_1"
        assert all(g["species"].shape[1] == 5 for g in graphs)

    def test_limit_is_seeded_subset(self, qm9_dir):
        a = load_qm9_dataset(qm9_dir, limit=3, seed=11)
        b = load_qm9_dataset(qm9_dir, limit=3, seed=11)
        c = load_qm9_dataset(qm9_dir, limit=3, seed=12)
        assert [g["id"] for g in a] == [g["id"] for g in b]
        assert len(a) == 3
        assert {g["id"] for g in a} != {g["id"] for g in c} or True
        # subsets keep sorted order (deterministic batching downstream)
        ids = [int(g["id"].split("_")[1]) for g in a]
        assert ids == sorted(ids)

    def test_missing_dir_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_qm9_dataset(str(tmp_path / "empty"))


class TestQm9CLI:
    @pytest.mark.slow
    def test_train_smoke(self, qm9_dir, tmp_path):
        """The reference's QM9 smoke run (ref main.py:145-152): widened
        atom_type_size, unconditional, end-to-end through the trainer."""
        from diffusion_model.cli import main as cli_main

        micro = dict(
            L=1, m_hidden_size=16, h_hidden_size=16, x_hidden_size=16,
            m_size=8, spectrum_size=16, compressed_spectrum_size=8,
            compressor_hidden_dim=[8], num_diffusion_timestep=4,
            batch_size=8, lr=1e-3, optimizer="Adam", noise_precision=0.05,
            gen_num_per_spectrum=1, num_epochs=2,
        )
        cfg_path = tmp_path / "micro.yaml"
        cfg_path.write_text(yaml.safe_dump(micro))
        run_dir = str(tmp_path / "run")
        cli_main.main([
            "--mode", "train_only", "--run_dir", run_dir,
            "--config", str(cfg_path),
            "--test_by_provided_data", "QM9",
            "--dataset_path", qm9_dir,
        ])
        assert os.path.isdir(os.path.join(run_dir, "checkpoints"))
        import json
        with open(os.path.join(run_dir, "config.json")) as f:
            saved = json.load(f)
        assert saved["atom_type_size"] == 5
        assert saved["conditional"] is False
