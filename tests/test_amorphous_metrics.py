"""Tests for the amorphous structural-quality panel (evals/amorphous.py)
and the continuous-random-network cell generator
(data/synthetic.amorphous_network_cell)."""

import numpy as np
import pytest

from diffusion_model.data.synthetic import (
    amorphous_cell,
    amorphous_network_cell,
)
from diffusion_model.evals.amorphous import (
    aggregate_exo_rdf,
    bond_angle_samples,
    coordination_stats,
    envelope_matched_cloud,
    excess_rdf_cos,
    exo_rdf_resampling_ceiling,
    pair_distances,
    radial_envelope,
    structure_panel,
)


def _stack(cells):
    n = max(len(c["pos"]) for c in cells)
    pos = np.zeros((len(cells), n, 3), np.float32)
    spec = np.zeros((len(cells), n, 2), np.float32)
    mask = np.zeros((len(cells), n), np.float32)
    for i, c in enumerate(cells):
        k = len(c["pos"])
        pos[i, :k] = c["pos"]
        spec[i, :k] = c["species"]
        mask[i, :k] = 1.0
    return pos, spec, mask


class TestNetworkGenerator:
    def test_schema_matches_dataset_contract(self):
        c = amorphous_network_cell(seed=3, num_atoms=96, spectrum_size=64)
        assert c["pos"].shape == (96, 3)
        assert c["species"].shape == (96, 2)
        assert c["spectrum"].shape == (96, 64)
        assert c["exo"].shape == (96, 1)
        # exO: node 0, at the origin, an oxygen, only spectrum row 0 set
        np.testing.assert_allclose(c["pos"][0], 0.0)
        np.testing.assert_allclose(c["species"][0], [1.0, 0.0])
        assert c["exo"][0, 0] == 1.0 and c["exo"][1:].sum() == 0
        assert np.abs(c["spectrum"][0]).sum() > 0
        assert np.abs(c["spectrum"][1:]).sum() == 0

    def test_deterministic_in_seed(self):
        a = amorphous_network_cell(seed=11, num_atoms=64)
        b = amorphous_network_cell(seed=11, num_atoms=64)
        np.testing.assert_array_equal(a["pos"], b["pos"])
        c = amorphous_network_cell(seed=12, num_atoms=64)
        assert not np.allclose(a["pos"], c["pos"])

    def test_silica_chemistry(self):
        c = amorphous_network_cell(seed=0, num_atoms=512)
        m = np.ones(512, np.float32)
        cn = coordination_stats(c["pos"], c["species"], m)
        # bulk CN(Si)=4 / CN(O)=2; ball-surface truncation lowers means
        assert 3.2 < cn["cn_si_mean"] <= 4.0
        assert 1.6 < cn["cn_o_mean"] <= 2.0
        osio, siosi = bond_angle_samples(c["pos"], c["species"], m)
        assert abs(np.mean(osio) - 109.5) < 5.0   # tetrahedral Si
        assert abs(np.mean(siosi) - 147.0) < 5.0  # bent bridge target
        d = pair_distances(c["pos"], m, 1.9)
        assert abs(np.median(d) - 1.61) < 0.1     # Si-O bond length

    def test_density_is_silica(self):
        c = amorphous_network_cell(seed=5, num_atoms=512)
        r = np.linalg.norm(c["pos"] - c["pos"].mean(0), axis=-1)
        rho = 512 / (4 / 3 * np.pi * r.max() ** 3)
        assert abs(rho - 0.066) < 0.01  # amorphous SiO2 atoms/A^3

    def test_stoichiometry(self):
        c = amorphous_network_cell(seed=7, num_atoms=384)
        o_frac = c["species"][:, 0].mean()
        assert abs(o_frac - 2 / 3) < 0.05  # SiO2


class TestPanel:
    def test_identical_stacks_are_perfect(self):
        cells = [amorphous_network_cell(seed=i, num_atoms=48)
                 for i in range(3)]
        pos, spec, mask = _stack(cells)
        p = structure_panel(pos, spec, pos, spec, mask)
        assert p["aggregate_rdf_cos"] == 1.0
        assert p["pair_dist_w1"] == 0.0
        assert p["envelope_scale_ratio_p50"] == 1.0
        assert p["cn_si_mean_original"] == p["cn_si_mean_generated"]

    def test_detects_uniform_scale_error(self):
        cells = [amorphous_network_cell(seed=i, num_atoms=48)
                 for i in range(3)]
        pos, spec, mask = _stack(cells)
        p = structure_panel(pos, spec, pos * 1.1, spec, mask)
        assert p["envelope_scale_ratio_p50"] == pytest.approx(1.1, abs=0.01)
        assert p["pair_dist_w1"] > 0.05

    def test_bond_peak_width_tracks_jitter(self):
        """The explicit bond-peak stats must see the diagnosed failure
        mode: positional jitter leaves the peak centred but broadens it."""
        cells = [amorphous_network_cell(seed=i, num_atoms=64)
                 for i in range(3)]
        pos, spec, mask = _stack(cells)
        p0 = structure_panel(pos, spec, pos, spec, mask)
        assert p0["bond_peak_width_generated"] == \
            p0["bond_peak_width_original"]
        rng = np.random.default_rng(1)
        # sigma 0.15 -> bond-length spread grows ~sqrt(0.154^2 + 0.21^2)
        # ~ 1.7x, comfortably above the 1.3x assertion for any draw
        jit = pos + rng.normal(0, 0.15, pos.shape).astype(np.float32)
        p1 = structure_panel(pos, spec, jit, spec, mask)
        assert p1["bond_peak_width_generated"] > \
            1.3 * p1["bond_peak_width_original"]
        # centred: the median moves far less than the width grows
        assert abs(p1["bond_peak_center_generated"]
                   - p1["bond_peak_center_original"]) < 0.1

    def test_pair_w1_monotone_in_jitter(self):
        cells = [amorphous_network_cell(seed=i, num_atoms=64)
                 for i in range(3)]
        pos, spec, mask = _stack(cells)
        rng = np.random.default_rng(0)
        w = []
        for sig in (0.1, 0.3, 0.9):
            jit = pos + rng.normal(0, sig, pos.shape).astype(np.float32)
            w.append(structure_panel(pos, spec, jit, spec,
                                     mask)["pair_dist_w1"])
        assert w[0] < w[1] < w[2]

    def test_structureless_floor_below_one(self):
        cells = [amorphous_network_cell(seed=i, num_atoms=64)
                 for i in range(4)]
        pos, spec, mask = _stack(cells)
        p = structure_panel(pos, spec, pos, spec, mask)
        assert p["aggregate_rdf_cos_structureless_floor"] < 0.95

    def test_cloud_matches_envelope_distribution_not_exact_radii(self):
        """The cloud must match the POOLED radial distribution but NOT
        reuse per-atom radii — exact reuse preserves all exO-centred
        distances (the exO sits at ~the CoM) and the floor inherits the
        fine structure it is supposed to erase."""
        cells = [amorphous_network_cell(seed=i, num_atoms=256)
                 for i in range(4)]
        pos, _, mask = _stack(cells)
        cloud = envelope_matched_cloud(pos, mask, np.random.default_rng(0))
        r0 = np.sort(np.concatenate(
            [np.linalg.norm(p - p.mean(0), axis=-1) for p in pos]))
        r1 = np.sort(np.concatenate(
            [np.linalg.norm(c - c.mean(0), axis=-1) for c in cloud]))
        # distribution-level match: pooled quantiles within a few percent
        for q in (25, 50, 75, 95):
            assert abs(np.percentile(r0, q) - np.percentile(r1, q)) \
                < 0.05 * max(np.percentile(r0, q), 1.0)
        # but NOT an exact per-atom radius copy within each cell
        rc0 = np.sort(np.linalg.norm(pos[0] - pos[0].mean(0), axis=-1))
        rc1 = np.sort(np.linalg.norm(cloud[0] - pos[0].mean(0), axis=-1))
        assert np.abs(rc0 - rc1).max() > 1e-3

    def test_radial_envelope_keys(self):
        cells = [amorphous_network_cell(seed=1, num_atoms=48)]
        pos, _, mask = _stack(cells)
        env = radial_envelope(pos, mask)
        assert set(env) == {"p25", "p50", "p75", "p95"}
        assert env["p25"] < env["p95"]


class TestExcessRdf:
    """The envelope-subtracted readout: at large dense cells the RAW
    aggregate-RDF cosine is dominated by the smooth radial-envelope
    background — an envelope-matched structureless cloud can score raw
    cosine ABOVE the resampling ceiling (measured at 512 atoms, round 3).
    The excess cosine subtracts each stack's own cloud background, so a
    structureless generator lands near 0 while ground truth vs ground
    truth stays high."""

    def test_self_consistency_high(self):
        cells = [amorphous_network_cell(seed=i, num_atoms=96)
                 for i in range(4)]
        pos, _, mask = _stack(cells)
        assert excess_rdf_cos(pos, mask, pos, mask) > 0.95

    def test_structureless_cloud_scores_near_zero(self):
        cells = [amorphous_network_cell(seed=i, num_atoms=96)
                 for i in range(4)]
        pos, _, mask = _stack(cells)
        cloud = envelope_matched_cloud(pos, mask, np.random.default_rng(7))
        assert abs(excess_rdf_cos(pos, mask, cloud, mask)) < 0.45

    def test_bracket_coherent_where_raw_is_not(self):
        """Raw floor can exceed the raw resampling score on envelope-
        dominated stacks; the excess bracket stays ordered
        floor < resample regardless."""
        cells_a = [amorphous_network_cell(seed=i, num_atoms=96)
                   for i in range(4)]
        cells_b = [amorphous_network_cell(seed=100 + i, num_atoms=96)
                   for i in range(4)]
        pa, _, ma = _stack(cells_a)
        pb, _, mb = _stack(cells_b)
        cloud = envelope_matched_cloud(pa, ma, np.random.default_rng(3))
        resample = excess_rdf_cos(pa, ma, pb, mb)
        floor = excess_rdf_cos(pa, ma, cloud, ma)
        assert floor < resample


class TestCeiling:
    def test_ceiling_estimator_runs_and_bounds(self):
        f = lambda s: amorphous_network_cell(seed=s, num_atoms=48)
        c = exo_rdf_resampling_ceiling(f, num_cells=4, pairs=2)
        assert 0.0 < c["mean"] <= 1.0
        assert c["min"] <= c["mean"]
        assert c["pairs"] == 2 and c["num_cells"] == 4
        # excess-protocol ceiling rides along
        assert -1.0 <= c["excess_mean"] <= 1.0
        assert c["excess_sd"] >= 0.0

    def test_network_ceiling_beats_packing(self):
        """The motivating measurement: the CRN generator's aggregate
        exO-RDF is far more reproducible across disjoint ground-truth
        sets than the hard-sphere packing's (fixed chemical peaks vs
        envelope sample noise)."""
        net = exo_rdf_resampling_ceiling(
            lambda s: amorphous_network_cell(seed=s, num_atoms=96),
            num_cells=4, pairs=2)
        pack = exo_rdf_resampling_ceiling(
            lambda s: amorphous_cell(seed=s, num_atoms=96),
            num_cells=4, pairs=2)
        assert net["mean"] > pack["mean"]
