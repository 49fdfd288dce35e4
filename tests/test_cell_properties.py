"""Property-based hardening tests for CASTEP .cell ingestion (data/cell.py).

Seeded randomized trials over lattice parameters, coordinate
representations, units and formatting noise: every property must hold for
any well-formed cell a real CASTEP run can emit (the reference's parser,
ref data_preparation.py:14-50, only ever read its own exports)."""

import numpy as np
import pytest

from diffusion_model.data.cell import (
    CellStructure,
    distance_matrix,
    lattice_from_parameters,
    min_image_distance_matrix,
    read_castep_cell,
    supercell_333,
)

N_TRIALS = 20
BOHR = 0.529177210903


def random_cell(rng, n_sites=None):
    """Random valid (lengths, angles, frac, species, exo_index)."""
    lengths = rng.uniform(4.0, 14.0, 3)
    # angle triple must satisfy the triangle-like validity condition; the
    # 70-110 deg box always does
    angles = rng.uniform(70.0, 110.0, 3)
    n = n_sites or int(rng.integers(2, 9))
    frac = rng.uniform(0.0, 1.0, (n, 3))
    species = ["O" if rng.random() < 0.6 else "Si" for _ in range(n)]
    exo = int(rng.integers(0, n))
    species[exo] = "O"
    return lengths, angles, frac, species, exo


def write_abc(path, lengths, angles, frac, species, exo, unit=None):
    lines = ["%BLOCK LATTICE_ABC"]
    if unit:
        lines.append(unit)
    lines += [" ".join(f"{v:.10f}" for v in lengths),
              " ".join(f"{v:.10f}" for v in angles),
              "%ENDBLOCK LATTICE_ABC", "", "%BLOCK POSITIONS_FRAC"]
    for i, (s, f) in enumerate(zip(species, frac)):
        tag = f"{s}:ex" if i == exo else s
        lines.append(f"{tag} " + " ".join(f"{v:.10f}" for v in f))
    lines.append("%ENDBLOCK POSITIONS_FRAC")
    path.write_text("\n".join(lines) + "\n")


def write_cart_abs(path, lattice, cart, species, exo, unit_scale=1.0,
                   unit_name=None):
    lines = ["%BLOCK LATTICE_CART"]
    if unit_name:
        lines.append(unit_name)
    lines += [" ".join(f"{v:.10f}" for v in row / unit_scale)
              for row in lattice]
    lines += ["%ENDBLOCK LATTICE_CART", "", "%BLOCK POSITIONS_ABS"]
    if unit_name:
        lines.append(unit_name)
    for i, (s, c) in enumerate(zip(species, cart)):
        tag = f"{s}:ex" if i == exo else s
        lines.append(f"{tag} " + " ".join(f"{v:.10f}" for v in c / unit_scale))
    lines.append("%ENDBLOCK POSITIONS_ABS")
    path.write_text("\n".join(lines) + "\n")


class TestLatticeRoundTrip:
    def test_lengths_and_angles_recovered(self, tmp_path):
        """Parsing a LATTICE_ABC file must reproduce the stated cell
        geometry: row norms = lengths, inter-row angles = angles."""
        rng = np.random.default_rng(0)
        for trial in range(N_TRIALS):
            lengths, angles, frac, species, exo = random_cell(rng)
            p = tmp_path / f"abc_{trial}.cell"
            write_abc(p, lengths, angles, frac, species, exo)
            s = read_castep_cell(str(p))
            got_len = np.linalg.norm(s.lattice, axis=1)
            np.testing.assert_allclose(got_len, lengths, rtol=1e-8)
            # alpha = angle(b, c), beta = angle(a, c), gamma = angle(a, b)
            def ang(u, v):
                return np.degrees(np.arccos(
                    np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v))))
            got_ang = [ang(s.lattice[1], s.lattice[2]),
                       ang(s.lattice[0], s.lattice[2]),
                       ang(s.lattice[0], s.lattice[1])]
            np.testing.assert_allclose(got_ang, angles, rtol=1e-7)
            np.testing.assert_allclose(s.frac_coords, frac, atol=1e-9)
            assert s.exo_index == exo

    def test_abc_and_cart_representations_agree(self, tmp_path):
        """The same structure written as LATTICE_ABC+FRAC and as
        LATTICE_CART+ABS must give identical interatomic distances (the
        representation is a gauge choice)."""
        rng = np.random.default_rng(1)
        for trial in range(N_TRIALS):
            lengths, angles, frac, species, exo = random_cell(rng)
            lattice = lattice_from_parameters(*lengths, *angles)
            pa = tmp_path / f"a_{trial}.cell"
            pc = tmp_path / f"c_{trial}.cell"
            write_abc(pa, lengths, angles, frac, species, exo)
            write_cart_abs(pc, lattice, frac @ lattice, species, exo)
            sa = read_castep_cell(str(pa))
            sc = read_castep_cell(str(pc))
            np.testing.assert_allclose(distance_matrix(sa),
                                       distance_matrix(sc), atol=1e-7)
            np.testing.assert_allclose(sc.frac_coords, frac, atol=1e-7)
            assert sa.species == sc.species

    def test_bohr_unit_scales_everything(self, tmp_path):
        """A file written in bohr must parse to the same Angstrom geometry
        as its ang twin."""
        rng = np.random.default_rng(2)
        for trial in range(N_TRIALS // 2):
            lengths, angles, frac, species, exo = random_cell(rng)
            lattice = lattice_from_parameters(*lengths, *angles)
            p_ang = tmp_path / f"ang_{trial}.cell"
            p_bohr = tmp_path / f"bohr_{trial}.cell"
            write_cart_abs(p_ang, lattice, frac @ lattice, species, exo)
            write_cart_abs(p_bohr, lattice, frac @ lattice, species, exo,
                           unit_scale=BOHR, unit_name="bohr")
            np.testing.assert_allclose(
                distance_matrix(read_castep_cell(str(p_ang))),
                distance_matrix(read_castep_cell(str(p_bohr))), atol=1e-6)


class TestFormattingNoise:
    def test_comments_blanks_and_case_are_ignored(self, tmp_path):
        rng = np.random.default_rng(3)
        lengths, angles, frac, species, exo = random_cell(rng, n_sites=5)
        clean = tmp_path / "clean.cell"
        write_abc(clean, lengths, angles, frac, species, exo)
        noisy = tmp_path / "noisy.cell"
        out = []
        for line in clean.read_text().splitlines():
            if line.startswith("%"):
                line = line.lower()
            out.append(line + ("   # trailing comment"
                               if rng.random() < 0.5 else ""))
            if rng.random() < 0.3:
                out.append("")
            if rng.random() < 0.3:
                out.append("! a full-line comment")
        noisy.write_text("\n".join(out) + "\n")
        a = read_castep_cell(str(clean))
        b = read_castep_cell(str(noisy))
        np.testing.assert_allclose(a.frac_coords, b.frac_coords)
        assert a.species == b.species and a.exo_index == b.exo_index

    def test_unrelated_blocks_and_directives_are_skipped(self, tmp_path):
        rng = np.random.default_rng(4)
        lengths, angles, frac, species, exo = random_cell(rng, n_sites=4)
        p = tmp_path / "extra.cell"
        write_abc(p, lengths, angles, frac, species, exo)
        extra = ("kpoint_mp_grid 4 4 4\nsymmetry_generate\n"
                 "%BLOCK SPECIES_POT\nO  O_soft.usp\nSi Si.usp\n"
                 "%ENDBLOCK SPECIES_POT\n")
        p.write_text(extra + p.read_text())
        s = read_castep_cell(str(p))
        assert s.num_sites == 4
        np.testing.assert_allclose(s.frac_coords, frac, atol=1e-9)


class TestPeriodicConsistency:
    def test_mic_invariant_under_integer_translations(self):
        """MIC distances must not change when any site is shifted by whole
        lattice vectors."""
        rng = np.random.default_rng(5)
        for _ in range(N_TRIALS):
            lengths, angles, frac, species, exo = random_cell(rng)
            lattice = lattice_from_parameters(*lengths, *angles)
            s1 = CellStructure(lattice, frac, species, exo)
            shift = rng.integers(-3, 4, frac.shape).astype(np.float64)
            s2 = CellStructure(lattice, frac + shift, species, exo)
            np.testing.assert_allclose(min_image_distance_matrix(s1),
                                       min_image_distance_matrix(s2),
                                       atol=1e-7)

    def test_mic_never_exceeds_direct_distance(self):
        rng = np.random.default_rng(6)
        for _ in range(N_TRIALS):
            lengths, angles, frac, species, exo = random_cell(rng)
            lattice = lattice_from_parameters(*lengths, *angles)
            s = CellStructure(lattice, frac, species, exo)
            assert np.all(min_image_distance_matrix(s)
                          <= distance_matrix(s) + 1e-9)

    def test_mic_matches_supercell_nearest_image(self):
        """For each pair, the MIC distance equals the minimum over the 27
        supercell images — cross-validates the two periodic codepaths the
        extraction pipeline uses (data/local_env.py vs data/shells.py)."""
        rng = np.random.default_rng(7)
        for _ in range(N_TRIALS // 2):
            lengths, angles, frac, species, exo = random_cell(rng,
                                                              n_sites=4)
            lattice = lattice_from_parameters(*lengths, *angles)
            s = CellStructure(lattice, frac, species, exo)
            mic = min_image_distance_matrix(s)
            sup = supercell_333(s)
            d_sup = distance_matrix(sup)
            n = s.num_sites
            # central image sites sit at block 13*n .. 14*n
            c0 = 13 * n
            for i in range(n):
                for j in range(n):
                    if i == j:
                        continue
                    images = d_sup[c0 + i, j::n].min()
                    assert mic[i, j] == pytest.approx(images, abs=1e-7)
