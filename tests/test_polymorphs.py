"""Public SiO2 polymorph corpus: crystallography pins + pipeline e2e.

The corpus (data/polymorphs.py) is the real-data validation substrate the
reference ran privately (ref make_dataset.py:60-143 on CASTEP output
trees); these tests pin the published crystallography so a regression in
the Wyckoff expansion or the lattice construction cannot silently corrupt
the "real data" claim.
"""

import os

import numpy as np
import pytest

from diffusion_model.data import polymorphs as P


def _bonds(poly):
    sites = P._structure(poly)
    lat = P.lattice_matrix(poly["abc"], poly["angles"])
    fr = np.array([x for _, x in sites])
    sp = [s for s, _ in sites]
    out = []
    for i, s in enumerate(sp):
        if s != "O":
            continue
        d = fr - fr[i]
        d -= np.round(d)
        dist = np.linalg.norm(d @ lat, axis=1)
        out += [dist[j] for j in range(len(sp))
                if sp[j] == "Si" and 0.1 < dist[j] < 2.0]
    return np.asarray(out)


class TestCrystallography:
    def test_multiplicities(self):
        for poly, n_si, n_o in ((P.QUARTZ, 3, 6),
                                (P.CRISTOBALITE_WYCKOFF, 4, 8),
                                (P.COESITE_WYCKOFF, 16, 32)):
            sites = P._structure(poly)
            assert sum(1 for s, _ in sites if s == "Si") == n_si
            assert sum(1 for s, _ in sites if s == "O") == n_o

    def test_quartz_bond_goldens(self):
        # frozen golden values shared with the CASTEP fixture
        # (tests/test_data.py: alpha-quartz Si-O 1.6075 / 1.6101 A)
        b = _bonds(P.QUARTZ)
        assert abs(b.min() - 1.6074) < 2e-3
        assert abs(b.max() - 1.6104) < 2e-3

    def test_all_polymorphs_physical_bonds(self):
        for poly in P.POLYMORPHS:
            b = _bonds(poly)
            assert b.size, poly["name"]
            assert 1.55 < b.min() and b.max() < 1.65, poly["name"]

    def test_every_o_twofold_coordinated(self):
        for poly in P.POLYMORPHS:
            n_o = sum(1 for s, _ in P._structure(poly) if s == "O")
            for oi in range(n_o):
                cn, _ = P.local_geometry(poly, oi)
                assert cn == 2, (poly["name"], oi)

    def test_published_angles(self):
        # alpha-quartz Si-O-Si ~ 143.7 deg (Levien et al. 1980); coesite
        # O1 sits on an inversion centre: exactly 180 (Levien/Prewitt 81)
        _, ang_q = P.local_geometry(P.QUARTZ, 0)
        assert abs(ang_q - 143.7) < 1.0
        _, ang_c1 = P.local_geometry(P.COESITE_WYCKOFF, 0)
        assert abs(ang_c1 - 180.0) < 1e-3
        # coesite's non-special sites are bent (137-150 deg)
        angles = [P.local_geometry(P.COESITE_WYCKOFF, i)[1]
                  for i in range(4, 32)]
        assert min(angles) > 130 and max(angles) < 155


class TestCorpusPipeline:
    def test_sample_drives_make_dataset(self, tmp_path):
        rng = np.random.default_rng(0)
        d = tmp_path / "c" / "sample_000_quartz_o0"
        cn, ang = P.write_sample(str(d), P.QUARTZ, 0, rng)
        assert cn == 2
        from diffusion_model.data.shells import build_dataset

        ds = build_dataset(str(tmp_path / "c"), nn_range="2NN")
        assert len(ds) == 1
        g = ds[0]
        assert g["pos"].shape[0] == 9  # exO + 2 Si + 6 O (2NN shell)
        assert g["exo"][0, 0] == 1.0
        assert np.isfinite(g["spectrum"]).all()
        # spectrum row 0 only (ref make_dataset.py:125-128)
        assert np.abs(g["spectrum"][1:]).max() == 0.0

    def test_spectra_distinguish_angles(self, tmp_path):
        """Conditioning carries real signal: the 180-deg coesite O1 site
        and a ~143-deg quartz site must produce distinct spectra (the
        angle peak moves with the real geometry)."""
        rng = np.random.default_rng(0)
        ev = np.arange(-5.0, 25.0, 0.1)
        y_q = P.physical_edge_curve(2, 143.7, rng, ev)
        y_c = P.physical_edge_curve(2, 180.0, rng, ev)
        # the angle peak sits at -0.5 + 4*(angle/180): 2.69 eV (quartz)
        # vs 3.5 eV (coesite O1); restrict to the low-energy window where
        # it is the only feature (the CN peaks live at 7.4 / 12.6 eV)
        window = (ev > 1.0) & (ev < 5.0)
        pk_q = ev[window][np.argmax(y_q[window])]
        pk_c = ev[window][np.argmax(y_c[window])]
        assert abs(pk_q - 2.69) < 0.3, pk_q
        assert abs(pk_c - 3.5) < 0.3, pk_c

    @pytest.mark.slow
    def test_corpus_to_training_e2e(self, tmp_path):
        """corpus -> cli.make_dataset -> train -> finite decreasing loss
        (the miniature of examples/real_data_e2e.py)."""
        import jax

        from diffusion_model import api
        from diffusion_model.cli import make_dataset
        from diffusion_model.config import Config
        from diffusion_model.data.io import load_dataset

        corpus = str(tmp_path / "corpus")
        P.write_corpus(corpus, seed=0, max_sites_per_polymorph=4)
        make_dataset.main(["--range", "2NN", "--cell_dir_path", corpus,
                           "--save_dir_path", str(tmp_path / "ds")])
        graphs = load_dataset(str(tmp_path / "ds" / "dataset.npz"))
        assert len(graphs) == 12
        cfg = Config(
            n_max=9, L=2, m_hidden_size=32, h_hidden_size=32,
            x_hidden_size=32, m_size=16, compressed_spectrum_size=8,
            compressor_hidden_dim=(8,), num_diffusion_timestep=20,
            batch_size=8, optimizer="Adam", lr=1e-3,
        )
        graphs = api.prepare_dataset(graphs, cfg)
        trainer, state, _ = api.train(cfg, graphs, str(tmp_path / "run"),
                                      num_epochs=40)
        import json

        losses = []
        with open(tmp_path / "run" / "metrics.jsonl") as f:
            for line in f:
                row = json.loads(line)
                if "train_loss" in row:
                    losses.append(row["train_loss"])
        assert np.isfinite(losses).all()
        assert np.mean(losses[-5:]) < np.mean(losses[:5])


class TestRattledCorpus:
    """Thermal-rattle corpus widening (write_corpus n_rattles).

    The invariant that makes the augmentation honest: the spectrum is
    synthesized from the geometry OF THE WRITTEN (perturbed) CELL, so a
    rattled sample is a self-consistent (spectrum, structure) pair, not
    label noise.
    """

    def test_rattled_cell_matches_manifest_geometry(self, tmp_path):
        from diffusion_model.data.cell import read_castep_cell

        corpus = str(tmp_path / "c")
        man = P.write_corpus(corpus, seed=3, max_sites_per_polymorph=2,
                             n_rattles=2, rattle_sigma_A=0.03)
        # 3 polymorphs x 2 sites x (1 base + 2 rattles)
        assert len(man) == 18
        base = [m for m in man if "_r" not in m[0].split("_o")[1]]
        rattled = [m for m in man if m not in base]
        assert len(base) == 6 and len(rattled) == 12

        import os
        for name, poly_name, cn, angle in rattled:
            struct = read_castep_cell(
                os.path.join(corpus, name, "coreloss.cell"))
            sites = list(zip(struct.species,
                             [tuple(f) for f in struct.frac_coords]))
            o_sites = [i for i, sp in enumerate(struct.species)
                       if sp == "O"]
            o_index = o_sites.index(struct.exo_index)
            cn2, angle2 = P.local_geometry_sites(
                sites, struct.lattice, o_index)
            assert cn2 == cn == 2
            # writer rounds fracs to 6 decimals -> sub-0.05-deg slack
            assert abs(angle2 - angle) < 0.05, (name, angle, angle2)

    def test_rattles_spread_the_discrete_angles(self, tmp_path):
        corpus = str(tmp_path / "c")
        man = P.write_corpus(corpus, seed=5, max_sites_per_polymorph=1,
                             n_rattles=4, rattle_sigma_A=0.03)
        for poly in ("quartz", "cristobalite", "coesite"):
            angles = [a for n, p, _, a in man if p == poly]
            base, rest = angles[0], angles[1:]
            # each rattle lands at a distinct nearby angle
            assert len({round(a, 3) for a in rest}) == len(rest)
            assert all(abs(a - base) < 25.0 for a in rest)
            assert max(abs(a - base) for a in rest) > 0.1

    def test_base_samples_unchanged_by_rattle_option(self, tmp_path):
        man0 = P.write_corpus(str(tmp_path / "a"), seed=0,
                              max_sites_per_polymorph=1)
        man1 = P.write_corpus(str(tmp_path / "b"), seed=0,
                              max_sites_per_polymorph=1, n_rattles=1)
        base1 = [m for m in man1 if "_r" not in m[0].split("_o")[1]]
        assert [(p, c, round(a, 6)) for _, p, c, a in man0] == \
               [(p, c, round(a, 6)) for _, p, c, a in base1]
