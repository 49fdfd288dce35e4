"""AOT serving export: the serialized sampler must reproduce the live
sampler bit-for-bit and run without the trainer/model objects."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffusion_model.config import Config
from diffusion_model.data.batch import collate
from diffusion_model.data.synthetic import synthetic_sio2_dataset
from diffusion_model.diffusion import sample
from diffusion_model.serve import (
    ServedSampler,
    export_sampler,
    exported_signature,
)
from diffusion_model.train import Trainer


def tiny_cfg(**kw):
    base = dict(
        n_max=6, L=2, m_hidden_size=32, h_hidden_size=32, x_hidden_size=32,
        m_size=16, spectrum_size=32, compressed_spectrum_size=8,
        compressor_hidden_dim=(16,), num_diffusion_timestep=10,
        batch_size=4, lr=1e-3, optimizer="Adam",
        noise_precision=0.05,  # tame toy alpha tail (see test_distill.py)
    )  # zero_init_x default True: untrained noisy chains stay finite
    base.update(kw)
    return Config(**base)


class TestServe:
    @pytest.mark.slow
    def test_export_roundtrip_matches_live_sampler(self, tmp_path):
        cfg = tiny_cfg()
        data = synthetic_sio2_dataset(0, 8, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        cond = collate(data[:4], cfg.n_max)
        trainer = Trainer(cfg)
        # an init draw whose untrained chain stays at the cell's scale
        # (|x| ~ 10 A), where the absolute tolerance below is f32 noise
        state = trainer.init_state(jax.random.key(2), cond)
        state, _ = trainer.train_step(state, jax.random.key(1), cond)

        path = str(tmp_path / "sampler.bin")
        export_sampler(cfg, trainer, state, path, batch_size=4,
                       platforms=("cpu",))

        served = ServedSampler(path)
        assert served.meta["n_max"] == cfg.n_max
        pos, species, accepted = served(
            7, np.asarray(cond.spectrum), np.asarray(cond.exo),
            np.asarray(cond.mask),
        )
        assert pos.shape == (4, cfg.n_max, 3)
        assert species.shape == (4, cfg.n_max, cfg.atom_type_size)
        assert np.isfinite(pos).all()

        params = state.eval_params(cfg)
        res = sample(trainer.denoise_fn(params),
                     trainer.schedule_for(params), cfg,
                     jax.random.PRNGKey(jnp.uint32(7)), cond)
        # exported StableHLO and live jit may fuse differently -> ~1e-6
        # element noise; the program is the same
        np.testing.assert_allclose(pos, np.asarray(res.pos), atol=1e-4)
        np.testing.assert_array_equal(accepted, np.asarray(res.accepted))

    @pytest.mark.slow
    def test_export_respects_strided_deterministic_cfg(self, tmp_path):
        cfg = tiny_cfg(sample_steps=5, deterministic_sampling=True)
        data = synthetic_sio2_dataset(1, 4, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        cond = collate(data[:2], cfg.n_max)
        trainer = Trainer(cfg)
        state = trainer.init_state(jax.random.key(0), cond)
        path = str(tmp_path / "s.bin")
        export_sampler(cfg, trainer, state, path, batch_size=2,
                       platforms=("cpu",))
        served = ServedSampler(path)
        assert served.meta["sample_steps"] == 5
        p1, _, _ = served(3, np.asarray(cond.spectrum),
                          np.asarray(cond.exo), np.asarray(cond.mask))
        p2, _, _ = served(3, np.asarray(cond.spectrum),
                          np.asarray(cond.exo), np.asarray(cond.mask))
        np.testing.assert_array_equal(p1, p2)  # same seed -> same structure

    @pytest.mark.slow
    def test_export_cli_roundtrip(self, tmp_path):
        """cli.export turns a finished run dir into a served artifact."""
        import yaml

        from diffusion_model.cli import main as cli_main
        from diffusion_model.cli.export import main as export_main

        micro = dict(
            L=1, m_hidden_size=16, h_hidden_size=16, x_hidden_size=16,
            m_size=8, spectrum_size=16, compressed_spectrum_size=8,
            compressor_hidden_dim=[8], num_diffusion_timestep=4,
            batch_size=8, lr=1e-3, optimizer="Adam", noise_precision=0.05,
            gen_num_per_spectrum=1, num_epochs=2,
        )
        cfg_path = tmp_path / "micro.yaml"
        cfg_path.write_text(yaml.safe_dump(micro))
        rd = str(tmp_path / "run")
        cli_main.main(["--mode", "train_only", "--run_dir", rd,
                       "--config", str(cfg_path), "--synthetic", "16"])
        out = str(tmp_path / "sampler.bin")
        export_main(["--run_dir", rd, "--out", out, "--batch_size", "2",
                     "--sample_steps", "2", "--platforms", "cpu"])
        served = ServedSampler(out)
        assert served.meta["sample_steps"] == 2
        n, s = served.meta["n_max"], served.meta["spectrum_size"]
        pos, _, _ = served(1, np.zeros((2, n, s), np.float32),
                           np.zeros((2, n, 1), np.float32),
                           np.ones((2, n), np.float32))
        assert pos.shape == (2, n, 3)

    def test_in_graph_retry_recovers_rejected_rows(self):
        """retry_rounds compiles the redraw loop into the program: rows the
        first draw rejects (coords > 1000 A) are re-drawn with fresh keys
        while first-draw successes are kept bit-identical."""
        from diffusion_model.diffusion.process import Schedule
        from diffusion_model.ops.schedules import (
            polynomial_alpha_schedule,
        )
        from diffusion_model.serve import _sampler_fn

        cfg = tiny_cfg(n_max=4, num_diffusion_timestep=3)
        sched = Schedule(
            alphas=polynomial_alpha_schedule(3, s=0.05, power=2.0))

        # eps_x = 6 * pos amplifies the initial noise through the short
        # chain: whether a row blows past the 1000 A acceptance bound
        # depends on its initial draw -> a seed-dependent accept/reject mix
        def denoise(h, pos, spec, exo, t, mask, pm):
            return pos * 6.0, jnp.zeros_like(h)

        b, n = 8, 4
        inputs = (jnp.uint32(7), np.zeros((b, n, 8), np.float32),
                  np.zeros((b, n, 1), np.float32),
                  np.ones((b, n), np.float32),
                  np.zeros((b, n, 2), np.float32))
        raw = jax.jit(_sampler_fn(cfg, denoise, sched, retry_rounds=0))
        ret = jax.jit(_sampler_fn(cfg, denoise, sched, retry_rounds=8))
        p0, _, a0 = raw(*inputs)
        p1, _, a1 = ret(*inputs)
        a0, a1 = np.asarray(a0), np.asarray(a1)
        assert 0 < a0.sum() < b  # the constant produces a genuine mix
        assert a1.all()          # the in-graph loop recovered every row
        np.testing.assert_array_equal(  # first-draw successes untouched
            np.asarray(p0)[a0], np.asarray(p1)[a0])

    def test_in_graph_retry_bound_surfaces_residue(self):
        """Rows still rejected when the retry budget runs out must surface
        as accepted=False (the caller's contract covers only the residue)."""
        from diffusion_model.diffusion.process import Schedule
        from diffusion_model.ops.schedules import (
            polynomial_alpha_schedule,
        )
        from diffusion_model.serve import _sampler_fn

        cfg = tiny_cfg(n_max=4, num_diffusion_timestep=3)
        sched = Schedule(
            alphas=polynomial_alpha_schedule(3, s=0.05, power=2.0))

        def denoise(h, pos, spec, exo, t, mask, pm):
            return pos * 8.0, jnp.zeros_like(h)  # rejects every draw

        b, n = 8, 4
        ret = jax.jit(_sampler_fn(cfg, denoise, sched, retry_rounds=3))
        _, _, acc = ret(jnp.uint32(7), np.zeros((b, n, 8), np.float32),
                        np.zeros((b, n, 1), np.float32),
                        np.ones((b, n), np.float32),
                        np.zeros((b, n, 2), np.float32))
        assert not np.asarray(acc).any()

    def test_retry_export_matches_retry_free_when_all_accept(self, tmp_path):
        """For a model whose first draw is always accepted the retry export
        is bit-identical to the raw one (the loop body never runs), and the
        sidecar records the retry budget + calibration stats."""
        cfg = tiny_cfg()
        data = synthetic_sio2_dataset(3, 4, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        cond = collate(data[:2], cfg.n_max)
        trainer = Trainer(cfg)
        state = trainer.init_state(jax.random.key(0), cond)
        raw_path = str(tmp_path / "raw.bin")
        ret_path = str(tmp_path / "retry.bin")
        export_sampler(cfg, trainer, state, raw_path, batch_size=2,
                       platforms=("cpu",))
        export_sampler(cfg, trainer, state, ret_path, batch_size=2,
                       platforms=("cpu",), retry_rounds=5,
                       acceptance_stats={
                           "single_draw_accepted_fraction": 1.0})
        raw, ret = ServedSampler(raw_path), ServedSampler(ret_path)
        assert raw.meta["in_graph_retry_rounds"] == 0
        assert ret.meta["in_graph_retry_rounds"] == 5
        assert ret.meta["acceptance"][
            "single_draw_accepted_fraction"] == 1.0
        args = (5, np.asarray(cond.spectrum), np.asarray(cond.exo),
                np.asarray(cond.mask))
        p0, _, a0 = raw(*args)
        p1, _, a1 = ret(*args)
        assert a0.all() and a1.all()
        np.testing.assert_array_equal(p0, p1)

    def test_learned_schedule_export(self, tmp_path):
        """A learned-schedule (GammaNetwork) model exports with its trained
        gamma table baked in and reproduces the live sampler."""
        cfg = tiny_cfg(noise_schedule="learned")
        data = synthetic_sio2_dataset(4, 8, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        cond = collate(data[:4], cfg.n_max)
        trainer = Trainer(cfg)
        state = trainer.init_state(jax.random.key(0), cond)
        state, _ = trainer.train_step(state, jax.random.key(1), cond)

        path = str(tmp_path / "learned.bin")
        export_sampler(cfg, trainer, state, path, batch_size=4,
                       platforms=("cpu",))
        served = ServedSampler(path)
        pos, _, accepted = served(
            9, np.asarray(cond.spectrum), np.asarray(cond.exo),
            np.asarray(cond.mask),
        )
        params = state.eval_params(cfg)
        res = sample(trainer.denoise_fn(params),
                     trainer.schedule_for(params), cfg,
                     jax.random.PRNGKey(jnp.uint32(9)), cond)
        np.testing.assert_allclose(pos, np.asarray(res.pos), atol=1e-4)
        np.testing.assert_array_equal(accepted, np.asarray(res.accepted))

    def test_legacy_four_input_artifact_still_callable(self, tmp_path):
        """Artifacts exported before the species input existed take 4
        args; ServedSampler must detect that from in_avals and call them
        compatibly (clear error if a composition is requested)."""
        import json

        import pytest

        b, n, a = 2, 4, 2

        def legacy_fn(seed, spectrum, exo, mask):
            pos = jnp.zeros((b, n, 3)) + spectrum[..., :1].sum()
            species = jnp.tile(jnp.eye(a)[0], (b, n, 1))
            return pos, species, jnp.ones((b,), bool)

        path = str(tmp_path / "legacy.bin")
        args = (
            jax.ShapeDtypeStruct((), jnp.uint32),
            jax.ShapeDtypeStruct((b, n, 8), jnp.float32),
            jax.ShapeDtypeStruct((b, n, 1), jnp.float32),
            jax.ShapeDtypeStruct((b, n), jnp.float32),
        )
        exp = jax.export.export(jax.jit(legacy_fn),
                                platforms=["cpu"])(*args)
        with open(path, "wb") as f:
            f.write(exp.mlir_module_serialized)
        with open(path + ".json", "w") as f:
            json.dump({"batch_size": b, "n_max": n, "spectrum_size": 8,
                       "atom_type_size": a,  # pre-change sidecar
                       "exported": exported_signature(exp)}, f)

        served = ServedSampler(path)
        spectrum = np.zeros((b, n, 8), np.float32)
        exo = np.zeros((b, n, 1), np.float32)
        mask = np.ones((b, n), np.float32)
        pos, species, accepted = served(1, spectrum, exo, mask)
        assert pos.shape == (b, n, 3) and accepted.all()
        with pytest.raises(ValueError, match="predates the species input"):
            served(1, spectrum, exo, mask,
                   species=np.zeros((b, n, a), np.float32))

    def test_position_only_export_uses_request_species(self, tmp_path):
        """A diffuse_species=False artifact keeps the requested composition
        fixed through the chain (ref E3diffusion_new.py pos-only mode) and
        refuses a call that omits it."""
        import pytest

        cfg = tiny_cfg(diffuse_species=False)
        data = synthetic_sio2_dataset(2, 4, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        cond = collate(data[:2], cfg.n_max)
        trainer = Trainer(cfg)
        state = trainer.init_state(jax.random.key(0), cond)
        path = str(tmp_path / "posonly.bin")
        export_sampler(cfg, trainer, state, path, batch_size=2,
                       platforms=("cpu",))
        served = ServedSampler(path)
        assert served.meta["diffuse_species"] is False
        with pytest.raises(ValueError, match="position-only"):
            served(3, np.asarray(cond.spectrum), np.asarray(cond.exo),
                   np.asarray(cond.mask))
        pos, species, _ = served(3, np.asarray(cond.spectrum),
                                 np.asarray(cond.exo),
                                 np.asarray(cond.mask),
                                 species=np.asarray(cond.species))
        np.testing.assert_array_equal(species, np.asarray(cond.species))
        assert np.isfinite(pos).all()

    def test_h_residual_export_roundtrip(self, tmp_path):
        """config.h_residual flows through the AOT export: the artifact
        reproduces the live sampler with the residual node update on."""
        cfg = tiny_cfg(h_residual=True)
        data = synthetic_sio2_dataset(0, 4, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        cond = collate(data[:2], cfg.n_max)
        trainer = Trainer(cfg)
        state = trainer.init_state(jax.random.key(0), cond)

        path = str(tmp_path / "sampler_hres.bin")
        export_sampler(cfg, trainer, state, path, batch_size=2,
                       platforms=("cpu",))
        served = ServedSampler(path)
        pos, species, accepted = served(
            3, np.asarray(cond.spectrum), np.asarray(cond.exo),
            np.asarray(cond.mask),
        )
        assert np.isfinite(pos).all()

        params = state.eval_params(cfg)
        res = sample(trainer.denoise_fn(params),
                     trainer.schedule_for(params), cfg,
                     jax.random.PRNGKey(jnp.uint32(3)), cond)
        np.testing.assert_allclose(pos, np.asarray(res.pos), atol=1e-4)

    def test_virtual_node_export_roundtrip(self, tmp_path):
        """config.virtual_node flows through the AOT export: the per-layer
        pooled global channel is plain XLA, so the artifact reproduces the
        live sampler with the channel enabled."""
        cfg = tiny_cfg(virtual_node=True)
        data = synthetic_sio2_dataset(0, 4, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        cond = collate(data[:2], cfg.n_max)
        trainer = Trainer(cfg)
        state = trainer.init_state(jax.random.key(0), cond)

        path = str(tmp_path / "sampler_vn.bin")
        export_sampler(cfg, trainer, state, path, batch_size=2,
                       platforms=("cpu",))
        served = ServedSampler(path)
        pos, species, accepted = served(
            3, np.asarray(cond.spectrum), np.asarray(cond.exo),
            np.asarray(cond.mask),
        )
        assert np.isfinite(pos).all()

        params = state.eval_params(cfg)
        res = sample(trainer.denoise_fn(params),
                     trainer.schedule_for(params), cfg,
                     jax.random.PRNGKey(jnp.uint32(3)), cond)
        np.testing.assert_allclose(pos, np.asarray(res.pos), atol=1e-4)

    def test_knn_topology_export_roundtrip(self, tmp_path):
        """neighbor_k > 0 flows through the AOT export: the per-step kNN
        rebuild (top_k over masked distances) is plain XLA, so the
        large-cell topology — the class the 512-atom quality models use —
        serves from the same artifact format as the dense path."""
        cfg = tiny_cfg(neighbor_k=3, h_residual=True, virtual_node=True)
        data = synthetic_sio2_dataset(0, 4, cfg.n_max,
                                      spectrum_size=cfg.spectrum_size)
        cond = collate(data[:2], cfg.n_max)
        trainer = Trainer(cfg)
        state = trainer.init_state(jax.random.key(0), cond)

        path = str(tmp_path / "sampler_knn.bin")
        export_sampler(cfg, trainer, state, path, batch_size=2,
                       platforms=("cpu",))
        served = ServedSampler(path)
        pos, species, accepted = served(
            3, np.asarray(cond.spectrum), np.asarray(cond.exo),
            np.asarray(cond.mask),
        )
        assert np.isfinite(pos).all()

        params = state.eval_params(cfg)
        res = sample(trainer.denoise_fn(params),
                     trainer.schedule_for(params), cfg,
                     jax.random.PRNGKey(jnp.uint32(3)), cond)
        np.testing.assert_allclose(pos, np.asarray(res.pos), atol=1e-4)
