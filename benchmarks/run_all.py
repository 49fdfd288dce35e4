"""Benchmark suite over seven workload configs.

Each config prints one JSON line. ``python benchmarks/run_all.py --configs
1,2,3`` selects a subset; config #5 (mesh DP) uses all visible devices —
run with XLA_FLAGS=--xla_force_host_platform_device_count=8 on CPU or on
several GPUs.

  1. small cell (~72 atoms): short train + 100-step sample
  2. joint (x,h) 192-atom cell, 1000-step sampling   (same as bench.py)
  3. batched generation: 256 structures per call + on-device RDF eval
  4. large cell (1024 atoms) via fixed-degree kNN lists
  5. data-parallel train step + sharded generation over the device mesh
  6. 1024-atom topology comparison: dense vs kNN vs ring peak-memory/time
  7. atom-count scale sweep through the kNN path (1024/2048/4096)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def _flagship_cfg(**kw):
    from diffusion_model.config import Config

    base = dict(compute_dtype="bfloat16")
    base.update(kw)
    return Config(**base)


def _setup(cfg, graphs):
    from diffusion_model.data.split import batch_iterator
    from diffusion_model.train import Trainer

    trainer = Trainer(cfg)
    batch = next(batch_iterator(graphs, cfg.batch_size, cfg.n_max))
    state = trainer.init_state(jax.random.key(0), batch)
    return trainer, state, batch


def _time(fn, *args, repeats=3):
    jax.block_until_ready(fn(*args))  # compile + warm-up
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t)
    return min(times)


def _emit(name, **kw):
    print(json.dumps({"config": name, **kw}), flush=True)


def config1():
    """Small cell, short train + 100-step sample."""
    from diffusion_model.data.synthetic import amorphous_cell
    from diffusion_model.diffusion import sample

    cfg = _flagship_cfg(n_max=72, num_diffusion_timestep=100, batch_size=1)
    cell = amorphous_cell(seed=0, num_atoms=72,
                          spectrum_size=cfg.spectrum_size)
    trainer, state, batch = _setup(cfg, [cell])
    step = lambda s, k: trainer.train_step(s, k, batch)
    t_train = _time(lambda: step(state, jax.random.key(1)))
    fn = trainer.denoise_fn(state.params)
    schedule = trainer.schedule_for(state.params)
    run = jax.jit(lambda k: sample(fn, schedule, cfg, k, batch))
    t_sample = _time(run, jax.random.key(2))
    _emit("1_small_cell_72atoms",
          train_step_ms=round(t_train * 1000, 2),
          sample_100step_s=round(t_sample, 3))


def config2():
    """Headline: 192-atom 1000-step generation."""
    from diffusion_model.data.synthetic import amorphous_cell
    from diffusion_model.diffusion import sample

    cfg = _flagship_cfg(n_max=192, num_diffusion_timestep=1000)
    cell = amorphous_cell(seed=0, num_atoms=192,
                          spectrum_size=cfg.spectrum_size)
    trainer, state, batch = _setup(cfg, [cell])
    fn = trainer.denoise_fn(state.params)
    schedule = trainer.schedule_for(state.params)
    run = jax.jit(lambda k: sample(fn, schedule, cfg, k, batch))
    t = _time(run, jax.random.key(2))
    _emit("2_joint_192atoms_1000steps",
          seconds_per_structure=round(t, 3),
          atoms_steps_per_sec=round(192 * 1000 / t, 1))


def config3():
    """Batched generation: 256 structures per call + on-device RDF."""
    from diffusion_model.data.split import batch_iterator
    from diffusion_model.data.synthetic import synthetic_sio2_dataset
    from diffusion_model.diffusion import sample
    from diffusion_model.ops.rdf import rdf_from_exo
    from diffusion_model.ops.angles import cn2_angle_deg

    cfg = _flagship_cfg(n_max=16, num_diffusion_timestep=100,
                        batch_size=256)
    graphs = synthetic_sio2_dataset(0, 256, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=2)
    trainer, state, batch = _setup(cfg, graphs)
    fn = trainer.denoise_fn(state.params)
    schedule = trainer.schedule_for(state.params)

    def run(k):
        res = sample(fn, schedule, cfg, k, batch)
        rdf = jax.vmap(rdf_from_exo)(res.pos, batch.mask)
        ang = cn2_angle_deg(res.pos)
        return res.pos, rdf, ang

    t = _time(jax.jit(run), jax.random.key(3))
    _emit("3_batched_generation_256",
          seconds_per_call=round(t, 3),
          structures_per_sec=round(256 / t, 1))


def config4():
    """Large 1024-atom cell via kNN lists."""
    from diffusion_model.data.synthetic import amorphous_cell
    from diffusion_model.diffusion import sample

    cfg = _flagship_cfg(n_max=1024, neighbor_k=32,
                        num_diffusion_timestep=50, batch_size=1)
    cell = amorphous_cell(seed=0, num_atoms=1024,
                          spectrum_size=cfg.spectrum_size)
    trainer, state, batch = _setup(cfg, [cell])
    fn = trainer.denoise_fn(state.params)
    schedule = trainer.schedule_for(state.params)
    run = jax.jit(lambda k: sample(fn, schedule, cfg, k, batch))
    t = _time(run, jax.random.key(4))
    per_step = t / cfg.num_diffusion_timestep
    _emit("4_large_cell_1024atoms_knn32",
          ms_per_denoise_step=round(per_step * 1000, 2),
          projected_1000step_s=round(per_step * 1000_0 / 10, 2),
          atoms_steps_per_sec=round(1024 / per_step, 1))


def config7():
    """Atom-count scale sweep through the kNN path (N = 1024/2048/4096).

    N with its N^2 pair set is this model's "sequence length" (SURVEY §5);
    the fixed-degree kNN edge list keeps per-step cost and peak memory
    O(N*K), so one chip absorbs cells well past the reference's operating
    envelope. Reports ms/denoise-step, atoms*steps/s and compiled peak
    memory per size.
    """
    from diffusion_model.data.synthetic import amorphous_cell
    from diffusion_model.diffusion import sample

    for n in (1024, 2048, 4096):
        cfg = _flagship_cfg(n_max=n, neighbor_k=32,
                            num_diffusion_timestep=10, batch_size=1)
        cell = amorphous_cell(seed=0, num_atoms=n,
                              spectrum_size=cfg.spectrum_size)
        trainer, state, batch = _setup(cfg, [cell])
        fn = trainer.denoise_fn(state.params)
        schedule = trainer.schedule_for(state.params)
        lowered = jax.jit(lambda k: sample(fn, schedule, cfg, k, batch))
        compiled = lowered.lower(jax.random.key(4)).compile()
        peak_mb = compiled.memory_analysis().peak_memory_in_bytes / 2**20
        row = {"peak_memory_mb": round(peak_mb, 1)}
        # like config6: the CPU mesh is for memory analysis only — flagship
        # kNN samples at these sizes take minutes of host compute each
        if jax.default_backend() != "cpu":
            t = _time(compiled, jax.random.key(4))
            per_step = t / cfg.num_diffusion_timestep
            row["ms_per_denoise_step"] = round(per_step * 1000, 2)
            row["atoms_steps_per_sec"] = round(n / per_step, 1)
        _emit(f"7_scale_{n}atoms_knn32", **row)


def config5():
    """DP train step + sharded generation over the device mesh."""
    from diffusion_model.data.split import batch_iterator
    from diffusion_model.data.synthetic import synthetic_sio2_dataset
    from diffusion_model.diffusion import sample
    from diffusion_model.parallel import make_mesh, replicate, \
        shard_graph_batch

    ndev = len(jax.devices())
    cfg = _flagship_cfg(n_max=16, num_diffusion_timestep=100,
                        batch_size=8 * ndev)
    graphs = synthetic_sio2_dataset(0, cfg.batch_size, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size)
    trainer, state, batch = _setup(cfg, graphs)
    mesh = make_mesh()
    sharded = shard_graph_batch(batch, mesh, mode="dp")
    state_r = jax.device_put(state, replicate(mesh))
    t_train = _time(
        lambda: trainer.train_step(state_r, jax.random.key(1), sharded)
    )
    fn = trainer.denoise_fn(state_r.params)
    schedule = trainer.schedule_for(state_r.params)
    run = jax.jit(lambda k: sample(fn, schedule, cfg, k, sharded))
    t_gen = _time(run, jax.random.key(2))
    _emit("5_mesh_dp", devices=ndev,
          dp_train_step_ms=round(t_train * 1000, 2),
          sharded_gen_100step_s=round(t_gen, 3),
          structures_per_sec=round(cfg.batch_size / t_gen, 1))


def config6():
    """N=1024 topology comparison: dense vs kNN-32 vs ring (SURVEY §2.6).

    Demonstrates the large-cell story: the dense pair tensor is O(N^2 * F)
    per chip while the ring shards it O(N * N/D * F) per device. Peak
    memory comes from the compiled executable's buffer assignment
    (``memory_analysis``), timing from the usual warm loop. The ring row
    appears when >1 device is visible (8-CPU mesh or a real slice); dense
    is compile-analysed only when its peak fits the chip.
    """
    from diffusion_model.data.synthetic import amorphous_cell
    from diffusion_model.parallel import make_mesh
    from diffusion_model.parallel.ring import ring_denoise_fn

    n = 1024
    cell = amorphous_cell(seed=0, num_atoms=n, spectrum_size=200)
    out = {}

    def mem_and_time(fn, *args, run_if_mb=10_000):
        lowered = jax.jit(fn).lower(*args)
        compiled = lowered.compile()
        stats = compiled.memory_analysis()
        peak_mb = stats.peak_memory_in_bytes / 2**20
        t = None
        # time only on real hardware (the CPU mesh is for memory analysis;
        # a 1024-atom dense forward takes minutes of host compute)
        if peak_mb < run_if_mb and jax.default_backend() != "cpu":
            t = _time(compiled, *args)
        return peak_mb, t

    def fwd_args(cfg, batch):
        b, nn_ = batch.mask.shape
        t_norm = jnp.full((b, nn_, 1), 0.5) * batch.mask[..., None]
        return (batch.species, batch.pos, batch.spectrum, batch.exo,
                t_norm, batch.mask)

    # dense (reference topology): peak is the O(N^2 * F1) edge tensor
    cfg_d = _flagship_cfg(n_max=n, batch_size=1)
    trainer, state, batch = _setup(cfg_d, [cell])
    args_d = fwd_args(cfg_d, batch) + (batch.pair_mask(),)
    peak, t = mem_and_time(trainer.denoise_fn(state.params), *args_d)
    out["dense_peak_mb"] = round(peak, 1)
    if t is not None:
        out["dense_forward_ms"] = round(t * 1000, 2)

    # kNN-32 (single-chip large-cell mode)
    cfg_k = _flagship_cfg(n_max=n, neighbor_k=32, batch_size=1)
    trainer_k, state_k, batch_k = _setup(cfg_k, [cell])
    from diffusion_model.ops.edges import knn_edges

    def knn_fwd(species, pos, spectrum, exo, t_norm, mask):
        edges = knn_edges(pos, mask, cfg_k.neighbor_k)
        return trainer_k.denoise_fn(state_k.params)(
            species, pos, spectrum, exo, t_norm, mask, edges)

    peak, t = mem_and_time(knn_fwd, *fwd_args(cfg_k, batch_k))
    out["knn32_peak_mb"] = round(peak, 1)
    if t is not None:
        out["knn32_forward_ms"] = round(t * 1000, 2)

    # ring over the mesh (explicit ppermute; O(N * N/D * F1) per device)
    ndev = len(jax.devices())
    if ndev > 1:
        mesh = make_mesh()
        ring = ring_denoise_fn(cfg_d, state.params["denoiser"], mesh)
        a = fwd_args(cfg_d, batch)
        ring_args = tuple(x[0] for x in a)
        peak, t = mem_and_time(ring, *ring_args)
        out["ring_devices"] = ndev
        out["ring_peak_mb_per_device"] = round(peak / ndev, 1)
        if t is not None:
            out["ring_forward_ms"] = round(t * 1000, 2)
    _emit("6_topology_1024atoms", **out)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--configs", type=str, default="1,2,3,4,5,6,7")
    args = p.parse_args()
    from diffusion_model.utils import setup_compile_cache

    setup_compile_cache()
    fns = {"1": config1, "2": config2, "3": config3, "4": config4,
           "5": config5, "6": config6, "7": config7}
    for c in args.configs.split(","):
        fns[c.strip()]()


if __name__ == "__main__":
    main()
