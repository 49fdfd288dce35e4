"""Smoke test for the structure-panel figure tool
(benchmarks/plot_structure_panel.py): drives main() on a tiny synthetic
positions npz and asserts the figure lands on disk."""

import os
import subprocess
import sys

import numpy as np

from diffusion_model.data.synthetic import amorphous_network_cell

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _positions_npz(path, num=3, n=48):
    cells = [amorphous_network_cell(seed=s, num_atoms=n, spectrum_size=32)
             for s in range(num)]
    pos = np.zeros((num, n, 3), np.float32)
    spec = np.zeros((num, n, 2), np.float32)
    mask = np.zeros((num, n), np.float32)
    for i, c in enumerate(cells):
        k = len(c["pos"])
        pos[i, :k] = c["pos"]
        spec[i, :k] = c["species"]
        mask[i, :k] = 1.0
    rng = np.random.default_rng(0)
    gen = pos + rng.normal(0, 0.05, pos.shape).astype(np.float32)
    np.savez(path, original_pos=pos, generated_pos=gen,
             original_species=spec, generated_species=spec, mask=mask,
             accepted=np.ones(num, bool))


def test_panel_figure_written(tmp_path):
    npz = str(tmp_path / "positions.npz")
    out = str(tmp_path / "panel.png")
    _positions_npz(npz)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "benchmarks", "plot_structure_panel.py"),
         npz, "--out", out, "--title", "test"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out) and os.path.getsize(out) > 10_000
