"""Multi-device tests on the virtual 8-CPU mesh: DP training parity,
node-sharded EGNN parity, sharded sampling."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from diffusion_model.config import Config
from diffusion_model.data.split import batch_iterator
from diffusion_model.data.synthetic import synthetic_sio2_dataset
from diffusion_model.diffusion import predefined_schedule, sample
from diffusion_model.parallel import (
    make_mesh,
    replicate,
    shard_graph_batch,
)
from diffusion_model.train import Trainer


def tiny_cfg(**kw):
    base = dict(
        n_max=8, L=2, m_hidden_size=32, h_hidden_size=32, x_hidden_size=32,
        m_size=16, spectrum_size=32, compressed_spectrum_size=8,
        compressor_hidden_dim=(16,), num_diffusion_timestep=10,
        batch_size=8, lr=1e-3, optimizer="Adam", noise_precision=0.05,
    )
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must expose 8 CPU devices"
    return make_mesh()


class TestDataParallel:
    @pytest.mark.slow
    def test_dp_train_step_matches_single_device(self, mesh):
        cfg = tiny_cfg()
        trainer = Trainer(cfg)
        data = synthetic_sio2_dataset(3, 8, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        batch = next(batch_iterator(data, 8, cfg.n_max))
        state = trainer.init_state(jax.random.key(0), batch)

        s1, m1 = trainer.train_step(state, jax.random.key(1), batch)

        sharded = shard_graph_batch(batch, mesh, mode="dp")
        state_r = jax.device_put(state, replicate(mesh))
        s2, m2 = trainer.train_step(state_r, jax.random.key(1), sharded)

        assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
        for a, b in zip(jax.tree.leaves(s1.params),
                        jax.tree.leaves(s2.params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-6)

    def test_dp_batch_is_actually_sharded(self, mesh):
        cfg = tiny_cfg()
        data = synthetic_sio2_dataset(3, 8, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        batch = next(batch_iterator(data, 8, cfg.n_max))
        sharded = shard_graph_batch(batch, mesh, mode="dp")
        shard_shapes = [s.data.shape for s in sharded.pos.addressable_shards]
        assert len(shard_shapes) == 8
        assert all(s[0] == 1 for s in shard_shapes)

    def test_dp_respects_axis_on_non_hybrid_multi_axis_mesh(self):
        """A generic two-axis mesh (say ('model', 'data')) must keep the
        batch replicated on the non-data axis — only the hierarchical
        ('replica', 'data') hybrid mesh spans both axes with DP."""
        from jax.sharding import Mesh

        from diffusion_model.parallel import dp_batch_sharding

        mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4),
                    ("model", "data"))
        sh = dp_batch_sharding(mesh)
        x = jax.device_put(np.zeros((4, 3)), sh)
        # sharded 4-ways over 'data', replicated over 'model' -> every
        # shard holds one batch row, and each row appears on 2 devices
        shapes = [s.data.shape for s in x.addressable_shards]
        assert len(shapes) == 8
        assert all(s[0] == 1 for s in shapes)


class TestMultiEpochDPEquivalence:
    @pytest.mark.slow
    def test_training_trajectories_match(self, mesh, tmp_path):
        """Multi-epoch DP training equivalence: the same config/seed/
        effective-batch trained 10 epochs single-device and DP-sharded
        must give matching loss trajectories — the check that catches
        key-splitting or metric-accumulation drift across epochs (the
        one-step parity test above can't). Full 50-epoch artifact:
        docs/perf/dp_equivalence.json (examples/dp_equivalence.py)."""
        import json
        import os

        from diffusion_model import api

        cfg = tiny_cfg(n_max=16, num_diffusion_timestep=50,
                       optimizer="RAdamScheduleFree", num_epochs=10)
        data = synthetic_sio2_dataset(7, 64, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)

        def traj(run_dir):
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            return (
                np.asarray([r["train_loss"] for r in recs
                            if "train_loss" in r]),
                np.asarray([r["eval_loss"] for r in recs
                            if "eval_loss" in r]),
            )

        single = str(tmp_path / "single")
        api.train(cfg, data, single)
        dp = str(tmp_path / "dp8")
        api.train(cfg.replace(mesh_shape=(8,)), data, dp)
        tr_s, ev_s = traj(single)
        tr_d, ev_d = traj(dp)
        assert len(tr_s) == len(tr_d) == 10
        np.testing.assert_allclose(tr_d, tr_s, rtol=1e-5)
        np.testing.assert_allclose(ev_d, ev_s, rtol=1e-5)


class TestNodeSharding:
    @pytest.mark.slow
    def test_node_sharded_forward_matches(self, mesh):
        """Large-cell path: node axis sharded over devices, same numerics."""
        cfg = tiny_cfg(n_max=32)
        trainer = Trainer(cfg)
        data = synthetic_sio2_dataset(5, 1, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size,
                                      shells=2)
        batch = next(batch_iterator(data, 1, cfg.n_max))
        state = trainer.init_state(jax.random.key(0), batch)
        fn = trainer.denoise_fn(state.params)

        b, n = batch.mask.shape
        args = (
            batch.species, batch.pos, batch.spectrum, batch.exo,
            jnp.full((b, n, 1), 0.5) * batch.mask[..., None],
            batch.mask, batch.pair_mask(),
        )
        ex1, eh1 = jax.jit(fn)(*args)

        shardings = (
            P(None, "data", None), P(None, "data", None),
            P(None, "data", None), P(None, "data", None),
            P(None, "data", None), P(None, "data"),
            P(None, "data", None),
        )
        with jax.set_mesh(mesh):
            args_sharded = tuple(
                jax.device_put(
                    a, jax.sharding.NamedSharding(mesh, s)
                ) for a, s in zip(args, shardings)
            )
            ex2, eh2 = jax.jit(fn)(*args_sharded)
        np.testing.assert_allclose(np.asarray(ex1), np.asarray(ex2),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(eh1), np.asarray(eh2),
                                   rtol=1e-4, atol=1e-5)


class TestShardedSampling:
    @pytest.mark.slow
    def test_sampler_over_dp_mesh(self, mesh):
        cfg = tiny_cfg()
        trainer = Trainer(cfg)
        data = synthetic_sio2_dataset(4, 8, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        cond = next(batch_iterator(data, 8, cfg.n_max))
        state = trainer.init_state(jax.random.key(0), cond)
        s = predefined_schedule(cfg)
        fn = trainer.denoise_fn(state.params)

        r1 = sample(fn, s, cfg, jax.random.key(2), cond)
        cond_sharded = shard_graph_batch(cond, mesh, mode="dp")
        r2 = sample(fn, s, cfg, jax.random.key(2), cond_sharded)
        np.testing.assert_allclose(np.asarray(r1.pos), np.asarray(r2.pos),
                                   rtol=1e-4, atol=1e-5)


class TestApiMeshTraining:
    @pytest.mark.slow
    def test_train_over_mesh(self, mesh, tmp_path):
        from diffusion_model import api

        cfg = tiny_cfg(mesh_shape=(8,))
        data = synthetic_sio2_dataset(9, 40, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        trainer, state, splits = api.train(
            cfg, data, str(tmp_path / "run"), num_epochs=2
        )
        # replicated state, finite loss logged
        import json, os

        with open(os.path.join(tmp_path, "run", "metrics.jsonl")) as f:
            recs = [json.loads(l) for l in f]
        losses = [r for r in recs if "train_loss" in r]
        assert len(losses) == 2
        assert all(np.isfinite(r["train_loss"]) for r in losses)


class TestHybridMesh:
    """Multi-slice (DCN x ICI) mesh layouts on the 8-CPU fallback grid."""

    @pytest.mark.slow
    def test_hybrid_dp_matches_single_device(self):
        from diffusion_model.parallel import make_hybrid_mesh

        hmesh = make_hybrid_mesh(dcn_replicas=2)
        assert hmesh.axis_names == ("replica", "data")
        assert hmesh.devices.shape == (2, 4)

        cfg = tiny_cfg()
        trainer = Trainer(cfg)
        data = synthetic_sio2_dataset(3, 8, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        batch = next(batch_iterator(data, 8, cfg.n_max))
        state = trainer.init_state(jax.random.key(0), batch)
        s1, m1 = trainer.train_step(state, jax.random.key(1), batch)

        sharded = shard_graph_batch(batch, hmesh, mode="dp")
        # batch axis sharded over BOTH axes: 8 single-graph shards
        shards = [s.data.shape for s in sharded.pos.addressable_shards]
        assert len(shards) == 8 and all(s[0] == 1 for s in shards)
        state_r = jax.device_put(state, replicate(hmesh))
        s2, m2 = trainer.train_step(state_r, jax.random.key(1), sharded)
        assert float(m1["loss"]) == pytest.approx(float(m2["loss"]),
                                                  rel=1e-4)
        for a, b in zip(jax.tree.leaves(s1.params),
                        jax.tree.leaves(s2.params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-6)

    def test_dp_node_layout_forward_matches(self):
        """Batch over 'replica' (DCN), nodes over 'data' (ICI): the
        large-cell multi-slice layout. Forward parity vs unsharded."""
        from diffusion_model.parallel import make_hybrid_mesh

        hmesh = make_hybrid_mesh(dcn_replicas=2)
        cfg = tiny_cfg(batch_size=2, n_max=16)
        trainer = Trainer(cfg)
        data = synthetic_sio2_dataset(5, 2, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        batch = next(batch_iterator(data, 2, cfg.n_max))
        state = trainer.init_state(jax.random.key(0), batch)
        fn = trainer.denoise_fn(state.params)
        b, n = batch.mask.shape
        t_norm = jnp.full((b, n, 1), 0.5) * batch.mask[..., None]
        args = (batch.species, batch.pos, batch.spectrum, batch.exo,
                t_norm, batch.mask, batch.pair_mask())
        want_x, want_h = jax.jit(fn)(*args)

        sharded = shard_graph_batch(batch, hmesh, mode="dp_node")
        shards = [s.data.shape for s in sharded.pos.addressable_shards]
        assert len(shards) == 8 and all(s[:2] == (1, 4) for s in shards)
        t_s = jax.device_put(
            t_norm, jax.sharding.NamedSharding(hmesh, P("replica", "data")))
        pm_s = jax.device_put(
            batch.pair_mask(),
            jax.sharding.NamedSharding(hmesh, P("replica", "data")))
        got_x, got_h = jax.jit(fn)(
            sharded.species, sharded.pos, sharded.spectrum, sharded.exo,
            t_s, sharded.mask, pm_s)
        np.testing.assert_allclose(np.asarray(want_x), np.asarray(got_x),
                                   rtol=3e-4, atol=3e-5)
        np.testing.assert_allclose(np.asarray(want_h), np.asarray(got_h),
                                   rtol=3e-4, atol=3e-5)

    def test_dp_node_requires_hybrid_mesh(self):
        cfg = tiny_cfg()
        data = synthetic_sio2_dataset(3, 8, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        batch = next(batch_iterator(data, 8, cfg.n_max))
        with pytest.raises(ValueError):
            shard_graph_batch(batch, make_mesh(), mode="dp_node")
