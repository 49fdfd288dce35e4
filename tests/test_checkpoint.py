"""Run-dir checkpoints: one ``<step>.npz`` of the TrainState's leaves plus
a ``<step>.json`` sidecar, the newest three kept."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffusion_model.config import Config
from diffusion_model.data.split import batch_iterator
from diffusion_model.data.synthetic import synthetic_sio2_dataset
from diffusion_model.train import Trainer
from diffusion_model.train.checkpoint import (
    MAX_TO_KEEP,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)


def tiny_cfg(**kw):
    base = dict(n_max=8, L=2, m_hidden_size=32, h_hidden_size=32,
                x_hidden_size=32, m_size=16, spectrum_size=32,
                compressed_spectrum_size=8, compressor_hidden_dim=(16,),
                num_diffusion_timestep=20, batch_size=4, lr=1e-3,
                noise_precision=0.05)
    base.update(kw)
    return Config(**base)


def _trained(cfg, steps=2):
    trainer = Trainer(cfg)
    graphs = synthetic_sio2_dataset(0, 8, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size)
    batch = next(batch_iterator(graphs, cfg.batch_size, cfg.n_max))
    state = trainer.init_state(jax.random.key(0), batch)
    for i in range(steps):
        state, _ = trainer.train_step(state, jax.random.key(10 + i), batch)
    return trainer, state, batch


@pytest.mark.parametrize("optimizer", ["RAdamScheduleFree", "AdamW"])
def test_roundtrip_with_optimizer_state_and_resume(tmp_path, optimizer):
    cfg = tiny_cfg(optimizer=optimizer)
    trainer, state, batch = _trained(cfg)
    d = str(tmp_path / "ck")
    save_checkpoint(d, state, cfg, step=2)
    assert latest_step(d) == 2
    with open(os.path.join(d, "2.json")) as f:
        side = json.load(f)
    assert side["config"]["optimizer"] == optimizer
    template = trainer.init_state(jax.random.key(5), batch)
    restored, cfg2 = restore_checkpoint(d, template)
    assert cfg2 == cfg
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert a.dtype == b.dtype
    # resume: the restored state steps exactly like the original
    s_a, m_a = trainer.train_step(state, jax.random.key(3), batch)
    s_b, m_b = trainer.train_step(restored, jax.random.key(3), batch)
    assert int(s_b.step) == 3
    np.testing.assert_array_equal(np.asarray(m_a["loss"]),
                                  np.asarray(m_b["loss"]))


def test_resumed_training_matches_uninterrupted(tmp_path):
    """api.train for two epochs equals one epoch, a checkpoint and a
    resumed second epoch: same losses, same final state."""
    from diffusion_model import api

    cfg = tiny_cfg(optimizer="Adam")
    data = synthetic_sio2_dataset(0, 12, cfg.n_max,
                                  spectrum_size=cfg.spectrum_size)

    def losses(run_dir):
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            return [r["train_loss"] for r in map(json.loads, f)
                    if "train_loss" in r]

    straight, resumed = str(tmp_path / "a"), str(tmp_path / "b")
    _, s_a, _ = api.train(cfg, data, straight, num_epochs=2)
    api.train(cfg, data, resumed, num_epochs=1)
    _, s_b, _ = api.train(cfg, data, resumed, num_epochs=2, resume=True)
    assert int(s_b.step) == int(s_a.step) > 0
    assert losses(resumed) == losses(straight)
    for a, b in zip(jax.tree.leaves(s_a), jax.tree.leaves(s_b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_keeps_newest_three(tmp_path):
    cfg = tiny_cfg(optimizer="Adam")
    trainer, state, _ = _trained(cfg, steps=0)
    d = str(tmp_path / "ck")
    for step in (1, 2, 3, 10, 11):
        save_checkpoint(d, state, cfg, step=step)
    assert MAX_TO_KEEP == 3
    assert sorted(os.listdir(d)) == sorted(
        f"{s}.{ext}" for s in (3, 10, 11) for ext in ("json", "npz"))
    assert latest_step(d) == 11
    # an older kept step restores on request
    _, _ = restore_checkpoint(d, state, step=3)


def test_incomplete_step_is_ignored(tmp_path):
    """The sidecar is written last: an npz without it is no checkpoint."""
    cfg = tiny_cfg(optimizer="Adam")
    _, state, _ = _trained(cfg, steps=0)
    d = tmp_path / "ck"
    save_checkpoint(str(d), state, cfg, step=1)
    (d / "2.npz").write_bytes((d / "1.npz").read_bytes())
    assert latest_step(str(d)) == 1
    assert latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "missing"), state)


def test_structure_mismatch_is_refused(tmp_path):
    cfg = tiny_cfg(optimizer="Adam")
    _, state, batch = _trained(cfg, steps=0)
    d = str(tmp_path / "ck")
    save_checkpoint(d, state, cfg, step=1)
    other = Trainer(tiny_cfg(optimizer="AdamW")).init_state(
        jax.random.key(0), batch)
    with pytest.raises(ValueError, match="structure"):
        restore_checkpoint(d, other)
    wider = Trainer(tiny_cfg(optimizer="Adam", m_hidden_size=48)).init_state(
        jax.random.key(0), batch)
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, wider)


def test_bfloat16_leaves_roundtrip(tmp_path):
    """numpy cannot store bfloat16: such leaves go to disk as float32 and
    come back in the template's dtype."""
    cfg = tiny_cfg(optimizer="Adam")
    _, state, _ = _trained(cfg, steps=0)
    state = dataclasses.replace(state, params=jax.tree.map(
        lambda a: a.astype(jnp.bfloat16), state.params))
    d = str(tmp_path / "ck")
    save_checkpoint(d, state, cfg, step=1)
    restored, _ = restore_checkpoint(d, state)
    for a, b in zip(jax.tree.leaves(state.params),
                    jax.tree.leaves(restored.params)):
        assert b.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
