"""The plain-JAX networks against recorded outputs and the f32 reference.

``tests/data/flax_golden.npz`` holds, for a seeded 2 x 16-atom input, the
outputs that the flax implementation computed from both committed
checkpoints (``artifacts/*.npz``, f32 matmuls, dense and kNN-8 edges), the
learned gamma schedule on an 11-point t grid, and the parameter-tree paths
and shapes of each network at init. The plain-JAX networks must reproduce
all of it.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import (
    UNIT_ROUNDOFF,
    flagship,
    live_params,
    rel_err,
    tolerance,
)
from diffusion_model.config import Config
from diffusion_model.nn import CNPredictor, DiffusionDenoiser, GammaNetwork
from diffusion_model.nn.spectrum_latent import SpectrumDecoder, SpectrumEncoder
from diffusion_model.ops import dense_pair_mask
from diffusion_model.ops.edges import knn_edges
from diffusion_model.train.checkpoint import load_config_npz, load_params_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "flax_golden.npz")
ARTIFACTS = ("q_predef_r5", "q_learned_r5_s2025")


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return {k: z[k] for k in z.files}


def _inputs(g):
    return tuple(jnp.asarray(g[k]) for k in (
        "in_species", "in_pos", "in_spectrum", "in_exo", "in_t_norm",
        "in_mask"))


def _artifact(name):
    path = os.path.join(ROOT, "artifacts", f"{name}.npz")
    cfg = load_config_npz(path).replace(compute_dtype="float32", n_max=16)
    return cfg, load_params_npz(path)


@pytest.mark.parametrize("edges", ["dense", "knn8"])
@pytest.mark.parametrize("name", ARTIFACTS)
def test_checkpoint_reproduces_golden(golden, name, edges):
    cfg, params = _artifact(name)
    args = _inputs(golden)
    e = (dense_pair_mask(args[5]) if edges == "dense"
         else knn_edges(args[1], args[5], 8))
    eps_x, eps_h = jax.jit(DiffusionDenoiser(cfg).apply)(
        params["denoiser"], *args, e)
    for got, key in ((eps_x, "eps_x"), (eps_h, "eps_h")):
        want = golden[f"{name}/{edges}_{key}"]
        # f32 on one backend: only fusion order differs
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_learned_gamma_reproduces_golden(golden):
    _, params = _artifact("q_learned_r5_s2025")
    got = GammaNetwork().apply(params["gamma"],
                               jnp.asarray(golden["in_t_grid"]))
    np.testing.assert_allclose(np.asarray(got),
                               golden["q_learned_r5_s2025/gamma"],
                               rtol=1e-6, atol=1e-6)


def _tree_spec(tree):
    return [[jax.tree_util.keystr(k), list(v.shape)]
            for k, v in jax.tree_util.tree_leaves_with_path(tree)]


def _denoiser_spec(cfg):
    n = 4
    z = lambda *s: jnp.zeros(s)
    mask = jnp.ones((1, n))
    return _tree_spec(DiffusionDenoiser(cfg).init(
        jax.random.key(0), z(1, n, cfg.atom_type_size),
        jax.random.normal(jax.random.key(1), (1, n, 3)),
        z(1, n, cfg.spectrum_size), z(1, n, 1), z(1, n, 1), mask,
        dense_pair_mask(mask)))


SPEC_BUILDERS = {
    "flagship": lambda: _denoiser_spec(Config()),
    "flagship_all_levers": lambda: _denoiser_spec(Config(
        virtual_node=True, edge_rbf=8, global_radius_feature=True,
        h_residual=True)),
    "uncompressed": lambda: _denoiser_spec(Config(
        to_compress_spectrum=False, give_exO=False, L=2)),
    "gamma": lambda: _tree_spec(GammaNetwork().init(
        jax.random.key(0), jnp.zeros((1, 1)))),
    "cn": lambda: _tree_spec(CNPredictor().init(
        jax.random.key(0), jnp.zeros((1, 200)))),
    "encoder": lambda: _tree_spec(SpectrumEncoder().init(
        jax.random.key(0), jnp.zeros((1, 200)))),
    "decoder": lambda: _tree_spec(SpectrumDecoder().init(
        jax.random.key(0), jnp.zeros((1, 32)))),
}


@pytest.mark.parametrize("label", sorted(SPEC_BUILDERS))
def test_param_tree_paths_and_shapes(golden, label):
    want = json.loads(str(golden["param_specs_json"][()]))[label]
    assert SPEC_BUILDERS[label]() == want


def test_committed_checkpoints_match_flagship_tree():
    """The committed checkpoints load straight into the flagship tree."""
    want = dict(map(tuple, (
        (p, tuple(s)) for p, s in _denoiser_spec(Config()))))
    for name in ARTIFACTS:
        _, params = _artifact(name)
        got = {p: tuple(s) for p, s in _tree_spec(
            {"params": params["denoiser"]["params"]})}
        assert got == want, name


SMALL = dict(n_max=12, L=3, m_hidden_size=32, h_hidden_size=32,
             x_hidden_size=32, m_size=16, spectrum_size=24,
             compressed_spectrum_size=8, compressor_hidden_dim=(16,))


@pytest.mark.parametrize("virtual_node", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topology", ["dense", "knn"])
def test_default_path_vs_f32_highest(rng, topology, dtype, virtual_node):
    """The denoiser at its compute dtype against f32 at matmul precision
    "highest", within the bound the chip smoke test states
    (``chip_smoke.tolerance``). On the CPU f32 matmuls are exact f32, so
    the f32 case is held to the f32 roundoff."""
    cfg = flagship(compute_dtype=dtype, virtual_node=virtual_node,
                   neighbor_k=6 if topology == "knn" else 0, **SMALL)
    b, n = 2, cfg.n_max
    mask = np.ones((b, n), np.float32)
    mask[0, -3:] = 0
    mask = jnp.asarray(mask)
    m3 = mask[..., None]
    args = (jnp.asarray(rng.normal(size=(b, n, 2)), jnp.float32) * m3,
            jnp.asarray(rng.normal(size=(b, n, 3)) * 2, jnp.float32) * m3,
            jnp.asarray(np.abs(rng.normal(size=(b, n, 24))),
                        jnp.float32) * m3,
            jnp.zeros((b, n, 1)).at[:, 0].set(1.0), 0.5 * m3, mask)
    edges = (knn_edges(args[1], mask, cfg.neighbor_k) if cfg.neighbor_k
             else dense_pair_mask(mask))
    model = DiffusionDenoiser(cfg)
    params = live_params(cfg, jax.random.key(3), *args, edges)
    ref_model = DiffusionDenoiser(cfg.replace(compute_dtype="float32"))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(ref_model.apply)(params, *args, edges)
    got = jax.jit(model.apply)(params, *args, edges)
    tol = tolerance(cfg, UNIT_ROUNDOFF[dtype])
    for g, w in zip(got, want):
        assert g.dtype == jnp.float32
        assert np.isfinite(np.asarray(g)).all()
        assert rel_err(g, w) <= tol
    if dtype == "bfloat16":
        # the bf16 path really rounds: it is not the f32 program
        assert rel_err(got[1], want[1]) > UNIT_ROUNDOFF["float32"]
