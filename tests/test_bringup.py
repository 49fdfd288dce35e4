"""What the GPU machine needs: no flax, orbax or PyYAML on the main path,
the compile-cache rule, and a native library built from committed source."""

import os
import subprocess
import sys
import textwrap

import jax
import pytest

from diffusion_model import utils
from diffusion_model.data import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = textwrap.dedent("""
    import sys
    for name in ("flax", "orbax", "orbax.checkpoint", "yaml"):
        sys.modules[name] = None  # any import of them now fails
""")


def _python(code: str):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    proc = subprocess.run([sys.executable, "-c", BLOCK + code], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("module", [
    "diffusion_model.api", "diffusion_model.train.trainer",
    "diffusion_model.diffusion.sampler", "diffusion_model.train.checkpoint",
    "diffusion_model.serve", "chip_smoke", "bench",
])
def test_main_path_imports_without_optional_packages(module):
    _python(f"import importlib; importlib.import_module({module!r})")


def test_main_path_runs_without_optional_packages():
    """Train, checkpoint, resume, generate, export and serve, then restore
    both committed checkpoints, with flax, orbax and PyYAML blocked."""
    out = _python(textwrap.dedent("""
        import os, tempfile
        import numpy as np
        from diffusion_model import api
        from diffusion_model.config import Config
        from diffusion_model.data.synthetic import synthetic_sio2_dataset
        from diffusion_model.serve import ServedSampler, export_sampler
        from diffusion_model.train.checkpoint import (
            load_config_npz, load_params_npz)

        cfg = Config(n_max=8, L=2, m_hidden_size=32, h_hidden_size=32,
                     x_hidden_size=32, m_size=16, spectrum_size=32,
                     compressed_spectrum_size=8, compressor_hidden_dim=(16,),
                     num_diffusion_timestep=10, batch_size=4,
                     optimizer="Adam", lr=1e-3, noise_precision=0.05)
        data = synthetic_sio2_dataset(0, 12, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        with tempfile.TemporaryDirectory() as d:
            _, first, _ = api.train(cfg, data, d, num_epochs=1)
            trainer, state, (_, _, test) = api.train(
                cfg, data, d, num_epochs=2, resume=True)
            assert int(state.step) == 2 * int(first.step) > 0
            res = api.generate(cfg, trainer, state, test[:1],
                               gen_num_per_spectrum=2, batch_size=1)
            assert res["generated_pos"].shape == (2, 8, 3)
            path = os.path.join(d, "sampler.bin")
            export_sampler(cfg, trainer, state, path, batch_size=1,
                           platforms=("cpu",))
            pos, _, _ = ServedSampler(path)(
                0, np.zeros((1, 8, 32), np.float32),
                np.zeros((1, 8, 1), np.float32),
                np.ones((1, 8), np.float32))
            assert np.isfinite(pos).all()
        for name in ("q_predef_r5", "q_learned_r5_s2025"):
            path = os.path.join("artifacts", name + ".npz")
            assert load_config_npz(path).L == 5
            assert "denoiser" in load_params_npz(path)
        print("ran")
    """))
    assert out.strip().endswith("ran")


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_checkout(monkeypatch,
                                            restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = utils.setup_compile_cache()
    assert got == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_compile_cache_env_wins(monkeypatch, restore_cache_config,
                                tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert utils.setup_compile_cache() == str(tmp_path)
    # nothing set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir is None


def test_native_library_rebuilt_when_older_than_source(monkeypatch,
                                                       tmp_path):
    src = tmp_path / "graphbuild.cpp"
    lib = tmp_path / "libgraphbuild.so"
    monkeypatch.setattr(native, "_SRC_PATH", str(src))
    monkeypatch.setattr(native, "_LIB_PATH", str(lib))
    src.write_text("// source")
    assert native._is_stale()          # no library yet
    lib.write_bytes(b"lib")
    os.utime(src, (1_000, 1_000))
    os.utime(lib, (2_000, 2_000))
    assert not native._is_stale()      # built after the source
    os.utime(src, (3_000, 3_000))
    assert native._is_stale()          # source edited since the build
