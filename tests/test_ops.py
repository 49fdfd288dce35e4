"""Core math library tests: schedules, CoM projection, Kabsch, RDF, angles.

Golden values are independent numpy/scipy re-derivations of the reference
formulas (diffusion_x_h.py:92-106, evaluate_RDF.py:48-60,
CN2_evaluate.py:12-21, evaluate_rmsd_for_pos_generate.py:11-51).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.ndimage import gaussian_filter1d

from diffusion_model.ops import (
    clip_noise_schedule,
    cn2_angle_deg,
    cn2_bond_lengths,
    dense_pair_mask,
    kabsch_rmsd,
    knn_edges,
    masked_mean,
    pairwise_sq_dist,
    polynomial_alpha_schedule,
    rdf_from_exo,
    remove_mean,
)
from diffusion_model.ops.rdf import gaussian_smooth_1d


def numpy_polynomial_schedule(timesteps, s=1e-4, power=3.0):
    """Independent numpy port of ref diffusion_x_h.py:92-106."""
    x = np.linspace(0, timesteps, timesteps + 1)
    alphas2 = (1 - (x / timesteps) ** power) ** 2
    alphas2 = np.concatenate([np.ones(1), alphas2])
    steps = np.clip(alphas2[1:] / alphas2[:-1], 0.001, 1.0)
    alphas2 = np.cumprod(steps)
    return (1 - 2 * s) * alphas2 + s


class TestSchedules:
    @pytest.mark.parametrize("power,s,T", [(2.0, 1e-5, 1000), (3.0, 1e-4, 50)])
    def test_polynomial_matches_reference_formula(self, power, s, T):
        got = np.asarray(polynomial_alpha_schedule(T, s=s, power=power))
        want = numpy_polynomial_schedule(T, s=s, power=power)
        # rtol accounts for float32 cumprod drift over T steps vs float64
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-7)

    def test_endpoints_and_monotonicity(self):
        a = np.asarray(polynomial_alpha_schedule(1000, s=1e-5, power=2.0))
        assert a.shape == (1001,)
        assert a[0] == pytest.approx(1.0 - 1e-5, abs=1e-7)
        assert a[-1] == pytest.approx(1e-5, abs=1e-7)
        assert np.all(np.diff(a) <= 0)

    def test_clip_noise_schedule(self):
        alphas2 = jnp.asarray([1.0, 0.5, 1e-9, 1e-9])
        out = np.asarray(clip_noise_schedule(alphas2))
        # step ratios clipped at 0.001
        assert out[1] == pytest.approx(0.5)
        assert out[2] == pytest.approx(0.5 * 0.001)


class TestRemoveMean:
    def test_unmasked(self, rng):
        x = jnp.asarray(rng.normal(size=(7, 3)), jnp.float32)
        out = remove_mean(x)
        np.testing.assert_allclose(np.asarray(out.mean(0)), 0.0, atol=1e-6)

    def test_masked_per_graph(self, rng):
        x = jnp.asarray(rng.normal(size=(2, 6, 3)), jnp.float32)
        mask = jnp.asarray([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 0]], jnp.float32)
        out = remove_mean(x, mask)
        # valid nodes have zero mean per graph
        for b in range(2):
            m = np.asarray(mask[b]) > 0
            np.testing.assert_allclose(
                np.asarray(out[b])[m].mean(0), 0.0, atol=1e-6
            )
            # padded nodes zeroed
            np.testing.assert_allclose(np.asarray(out[b])[~m], 0.0)

    def test_masked_mean_matches_loop(self, rng):
        x = jnp.asarray(rng.normal(size=(4, 5, 3)), jnp.float32)
        mask = jnp.asarray(rng.random((4, 5)) > 0.3, jnp.float32)
        got = np.asarray(masked_mean(x, mask))
        for b in range(4):
            m = np.asarray(mask[b]) > 0
            if m.sum() == 0:
                continue
            np.testing.assert_allclose(
                got[b, 0], np.asarray(x[b])[m].mean(0), rtol=1e-5
            )


class TestKabsch:
    def test_recovers_rigid_transform(self, rng):
        p = rng.normal(size=(10, 3)).astype(np.float32)
        # random rotation via QR
        q_mat, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q_mat) < 0:
            q_mat[:, 0] *= -1
        q = p @ q_mat.T + np.array([1.0, -2.0, 3.0], np.float32)
        rmsd = float(kabsch_rmsd(jnp.asarray(p), jnp.asarray(q)))
        assert rmsd < 1e-4

    def test_reflection_not_allowed(self, rng):
        p = rng.normal(size=(8, 3)).astype(np.float32)
        q = p.copy()
        q[:, 0] *= -1  # improper transform
        rmsd = float(kabsch_rmsd(jnp.asarray(p), jnp.asarray(q)))
        assert rmsd > 1e-3  # cannot be matched by a proper rotation

    def test_masked_ignores_padding(self, rng):
        p = rng.normal(size=(6, 3)).astype(np.float32)
        q = p.copy()
        q_pad = np.concatenate([q, rng.normal(size=(2, 3)).astype(np.float32)])
        p_pad = np.concatenate([p, rng.normal(size=(2, 3)).astype(np.float32)])
        mask = jnp.asarray([1, 1, 1, 1, 1, 1, 0, 0], jnp.float32)
        rmsd = float(kabsch_rmsd(jnp.asarray(p_pad), jnp.asarray(q_pad), mask))
        assert rmsd < 1e-4

    def test_batched(self, rng):
        p = jnp.asarray(rng.normal(size=(4, 10, 3)), jnp.float32)
        q = p + 0.01 * jnp.asarray(rng.normal(size=(4, 10, 3)), jnp.float32)
        rmsd = kabsch_rmsd(p, q)
        assert rmsd.shape == (4,)
        assert np.all(np.asarray(rmsd) < 0.05)


def numpy_reference_rdf(position, sigma=5, R=5.0, dR=0.01):
    """Independent numpy port of ref evaluate_RDF.py:39-60."""
    exO = position[0]
    lengths = [np.linalg.norm(position[i] - exO) for i in range(1, len(position))]
    num_atom = position.shape[0]
    ro = num_atom / (4 / 3 * np.pi * R**3)
    rs = np.arange(0 + dR, R + dR, dR)
    out = []
    for r in rs:
        c = sum(1 for d in lengths if r < d < r + dR)
        out.append(c / (4 * np.pi * ro * r**2 * dR))
    return gaussian_filter1d(out, sigma)


class TestRDF:
    def test_matches_reference_formula(self, rng):
        pos = rng.normal(size=(12, 3)).astype(np.float32) * 1.5
        want = numpy_reference_rdf(pos)
        got = np.asarray(rdf_from_exo(jnp.asarray(pos)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_gaussian_smooth_matches_scipy(self, rng):
        y = rng.normal(size=(500,)).astype(np.float32)
        got = np.asarray(gaussian_smooth_1d(jnp.asarray(y), 5.0))
        want = gaussian_filter1d(y, 5.0)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_masked_equals_unpadded(self, rng):
        pos = rng.normal(size=(8, 3)).astype(np.float32) * 1.5
        pad = np.concatenate([pos, 100 + rng.normal(size=(4, 3)).astype(np.float32)])
        mask = jnp.asarray([1] * 8 + [0] * 4, jnp.float32)
        got = np.asarray(rdf_from_exo(jnp.asarray(pad), mask))
        want = np.asarray(rdf_from_exo(jnp.asarray(pos)))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


class TestAngles:
    def test_right_angle(self):
        pos = jnp.asarray([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]])
        assert float(cn2_angle_deg(pos)) == pytest.approx(90.0, abs=1e-4)
        l1, l2 = cn2_bond_lengths(pos)
        assert float(l1) == pytest.approx(1.0)
        assert float(l2) == pytest.approx(1.0)

    def test_batched_angles(self, rng):
        pos = jnp.asarray(rng.normal(size=(5, 3, 3)), jnp.float32)
        a = cn2_angle_deg(pos)
        assert a.shape == (5,)
        assert np.all((np.asarray(a) >= 0) & (np.asarray(a) <= 180))

    def test_pairwise_sq_dist(self, rng):
        pos = rng.normal(size=(6, 3)).astype(np.float32)
        got = np.asarray(pairwise_sq_dist(jnp.asarray(pos)))
        want = ((pos[:, None] - pos[None]) ** 2).sum(-1)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


class TestEdges:
    def test_dense_pair_mask(self):
        mask = jnp.asarray([[1, 1, 0]], jnp.float32)
        pm = np.asarray(dense_pair_mask(mask))[0]
        assert pm[0, 1] == 1 and pm[1, 0] == 1
        assert pm[0, 0] == 0 and pm[1, 1] == 0  # no self edges
        assert pm[0, 2] == 0 and pm[2, 1] == 0  # padded excluded

    def test_knn(self, rng):
        pos = jnp.asarray(rng.normal(size=(10, 3)), jnp.float32)
        mask = jnp.ones((10,), jnp.float32)
        idx, emask = knn_edges(pos, mask, k=3)
        assert idx.shape == (10, 3) and emask.shape == (10, 3)
        assert np.all(np.asarray(emask) == 1)
        # nearest neighbour is correct for node 0
        d = np.linalg.norm(np.asarray(pos) - np.asarray(pos)[0], axis=-1)
        d[0] = np.inf
        assert int(idx[0, 0]) == int(np.argmin(d))

    def test_knn_masked(self, rng):
        pos = jnp.asarray(rng.normal(size=(6, 3)), jnp.float32)
        mask = jnp.asarray([1, 1, 1, 0, 0, 0], jnp.float32)
        idx, emask = knn_edges(pos, mask, k=4)
        em = np.asarray(emask)
        # only 2 valid neighbours exist per valid node
        assert np.all(em[:3].sum(-1) == 2)
        assert np.all(em[3:] == 0)
