"""Native C++ dataset-builder kernels vs the numpy oracle."""

import numpy as np
import pytest

from diffusion_model.data import native
from diffusion_model.data.cell import (
    CellStructure,
    distance_matrix,
    lattice_from_parameters,
    supercell_333,
)
from diffusion_model.data.shells import build_graph, shell_indices

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


def random_structure(rng, n=12, side=6.0):
    lattice = lattice_from_parameters(side, side, side, 90, 90, 90)
    frac = rng.random((n, 3))
    species = ["O" if i % 3 else "Si" for i in range(n)]
    return CellStructure(lattice=lattice, frac_coords=frac,
                         species=species, exo_index=0)


class TestNativeShells:
    @pytest.mark.parametrize("n_shells", [1, 2, 3])
    def test_matches_numpy(self, rng, n_shells):
        base = random_structure(rng)
        spectrum = rng.random(16).astype(np.float32)
        g_native = build_graph(base, n_shells, spectrum, "x",
                               use_native=True)
        g_numpy = build_graph(base, n_shells, spectrum, "x",
                              use_native=False)
        assert g_native["pos"].shape == g_numpy["pos"].shape
        np.testing.assert_allclose(g_native["pos"], g_numpy["pos"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(g_native["species"],
                                      g_numpy["species"])

    def test_distance_matrix(self, rng):
        pos = rng.normal(size=(20, 3))
        got = native.distance_matrix_native(pos)
        want = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)

    def test_knn(self, rng):
        pos = rng.normal(size=(15, 3))
        k = 4
        got = native.knn_indices_native(pos, k)
        d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        np.fill_diagonal(d, np.inf)
        want = np.argsort(d, axis=-1)[:, :k]
        np.testing.assert_array_equal(got, want)
