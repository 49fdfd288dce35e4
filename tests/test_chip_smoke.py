"""chip_smoke.py's phases at tiny widths on the CPU, and its refusals.

On the card the script runs the same functions at full width; here each
phase runs end to end at a size the CPU handles, so a wrong path, argument
or check shows before a chip run.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs
from diffusion_model.parallel import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_max=16, L=2, m_hidden_size=32, h_hidden_size=32,
            x_hidden_size=32, m_size=16, spectrum_size=32,
            compressed_spectrum_size=8, compressor_hidden_dim=(16,),
            num_diffusion_timestep=20)


def tiny(**kw):
    return cs.flagship(**{**TINY, **kw})


def test_check_device_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.check_device()


def test_flagship_is_full_width_with_damped_init():
    cfg = cs.flagship()
    assert (cfg.L, cfg.m_hidden_size, cfg.n_max) == (5, 1024, 192)
    assert cfg.compute_dtype == "bfloat16"
    assert cfg.h_init_scale == pytest.approx(1 / 191 ** 2)
    assert cs.flagship(neighbor_k=32).h_init_scale == pytest.approx(
        1 / 32 ** 2)
    assert cs.flagship(h_init_scale=1.0).h_init_scale == 1.0


def test_tolerance_grows_with_depth_and_degree():
    base = cs.tolerance(tiny(), 2 ** -8)
    assert cs.tolerance(tiny(L=4), 2 ** -8) == pytest.approx(2 * base)
    assert cs.tolerance(tiny(n_max=64), 2 ** -8) > base
    assert cs.tolerance(tiny(neighbor_k=4), 2 ** -8) < base


def test_phase_generation():
    out = cs.phase_generation(tiny(), steps=(0, 5))
    assert set(out) == {"steps_20", "steps_5"}
    for r in out.values():
        assert r["finite"] == 1.0
        assert r["warm_call_s"] > 0


def test_phase_training(tmp_path):
    out = cs.phase_training(tiny(), str(tmp_path))
    assert out["steps_after_resume"] == 2 * out["steps_per_epoch"]
    assert len(out["train_loss"]) == 2
    assert out["train_step_memory"]["argument_size_in_bytes"] > 0


def test_phase_parity():
    out = cs.phase_parity(tiny())
    for r in out["forward"].values():
        assert r["eps_x"] <= r["tol"] and r["eps_h"] <= r["tol"]
    assert out["chain_10"]["h"] <= out["chain_10"]["tol"]
    assert set(out["golden"]) == {"q_predef_r5", "q_learned_r5_s2025"}


def test_phase_knn():
    out = cs.phase_knn(sizes=(48,), k=6, steps=3,
                       **{k: v for k, v in TINY.items() if k != "n_max"})
    r = out["48"]
    assert r["generate"]["finite"] == 1.0
    assert r["denoiser_call_ms"] > 0
    assert set(r["forward_parity"]) == {"tf32", "bfloat16"}


def test_phase_serving(tmp_path):
    out = cs.phase_serving(tiny(sample_steps=4), str(tmp_path),
                           batch_size=2, requests=2)
    assert out["platform"] == "cpu"
    assert len(out["request_s"]) == 2


@pytest.mark.parametrize("phase", ["dp", "ring"])
def test_four_device_phases(phase):
    mesh = make_mesh((4,), ("data",), devices=jax.devices()[:4])
    if phase == "dp":
        out = cs.phase_dp(tiny(), mesh)
        assert out["rel_err"]["loss"] <= out["tol"]
    else:
        out = cs.phase_ring(tiny(), mesh)
        assert out["pos"] <= out["tol"] and out["h"] <= out["tol"]


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_script_fails_on_cpu_without_result():
    proc = _run(["chip_smoke.py"], ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path),
                {"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_result_line_contract(monkeypatch, capsys):
    """With the device check passed, the last line is the result object
    and the phases run in order (phases stubbed out)."""
    ran = []
    monkeypatch.setattr(cs, "setup_compile_cache", lambda: None)
    monkeypatch.setattr(cs, "check_device", lambda cache_dir=None: {
        "platform": "gpu", "kind": "fake", "count": 1})
    for name in ("phase_generation", "phase_training", "phase_parity",
                 "phase_knn", "phase_serving"):
        monkeypatch.setattr(
            cs, name, lambda *a, _n=name, **k: ran.append(_n) or {})
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "fake",
                               "count": 1}}
    assert lines[-2].startswith("card: ")
    assert ran == ["phase_generation", "phase_training", "phase_parity",
                   "phase_knn", "phase_serving"]
