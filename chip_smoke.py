#!/usr/bin/env python3
"""Smoke test of the main path on the GPU, through the user entry points.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: DP train step + ring sampling

One card runs, at the full flagship width (L=5, 1024-wide MLPs), with
random weights made from a seed:

  device      platform, device kind, count, JAX version, XLA_FLAGS, compile
              cache and the card's name and power limit; refuses any backend
              but the GPU
  generation  ``api.generate`` of one 192-atom cell, 1000-step and 250-step
              samplers, bf16
  training    ``api.train`` on synthetic 192-atom cells with a checkpoint,
              a resume and a restore; the train step's memory analysis
  parity      the denoiser forward (bf16 and f32/TF32) and a 10-step sampler
              chain against the f32 reference at matmul precision "highest";
              the committed checkpoints against their recorded outputs
  knn         ``api.generate`` at 2048 and 4096 atoms with kNN-32 edges,
              residual node updates and the virtual node, a short strided
              sampler, the time per denoiser call and a forward parity check
  serving     ``serve.export_sampler`` for CUDA, answered by ``ServedSampler``

Every phase raises on a failed check, so the script exits non-zero and
prints no result line. The last line of a passing run is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from diffusion_model import api
from diffusion_model.config import Config
from diffusion_model.data.batch import collate
from diffusion_model.data.synthetic import amorphous_cell
from diffusion_model.diffusion import sample
from diffusion_model.nn import DiffusionDenoiser
from diffusion_model.ops.edges import dense_pair_mask, knn_edges
from diffusion_model.train import Trainer
from diffusion_model.utils import setup_compile_cache

ROOT = os.path.dirname(os.path.abspath(__file__))

# Unit roundoff of the matmul inputs: bf16 keeps 8 significant bits, TF32
# 11 (f32 matmuls on the GPU run as TF32 unless precision says otherwise).
UNIT_ROUNDOFF = {"bfloat16": 2.0 ** -8, "tf32": 2.0 ** -11,
                 "float32": 2.0 ** -24}


def neighbours(cfg: Config) -> int:
    """K: messages per node (n_max - 1 dense, neighbor_k with kNN)."""
    return cfg.neighbor_k or cfg.n_max - 1


def tolerance(cfg: Config, unit_roundoff: float) -> float:
    """Relative error bound of one denoiser forward against the f32
    reference. Per layer, about four roundings in sequence (the cast
    inputs of the edge MLP's two matmuls, of the node MLP, and the output)
    cost ~4 u, and the sum of messages over K neighbours a random walk of
    sqrt(K) u; the L layers add up: L (4 + sqrt(K)) u."""
    return cfg.L * (4 + math.sqrt(neighbours(cfg))) * unit_roundoff


def reorder_tolerance(cfg: Config) -> float:
    """Relative bound for two f32 runs of the same math that differ only in
    summation order, fusion or the backend's transcendental functions:
    :func:`tolerance` at the f32 roundoff 2^-24, with a 2^6 margin for the
    few ulps of exp/sigmoid implementations and, in sampler chains, the
    growth over their steps."""
    return tolerance(cfg, UNIT_ROUNDOFF["float32"]) * 2 ** 6


def rel_err(a, b) -> float:
    """``|a - b| / |b|`` in the Frobenius norm, in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    """``name, power.limit`` of the card(s), as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def memory(compiled) -> dict:
    """The byte counts of ``compiled.memory_analysis()``."""
    m = compiled.memory_analysis()
    if m is None:
        return {}
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(m, k)}


def peak_bytes() -> int | None:
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def check_device(cache_dir: str | None = None) -> dict:
    """Describe the accelerator; refuse anything but the GPU."""
    d = jax.devices()[0]
    info = {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
        "jax": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "compile_cache": cache_dir,
    }
    if d.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found platform {d.platform!r}; this smoke test "
            "measures and checks the GPU path only")
    return info


def flagship(**overrides) -> Config:
    """The flagship configuration: full width, bf16 matmuls, 192 atoms.

    The weights are random, so two settings keep an untrained network's
    chain finite and single: the node-MLP output kernel starts at variance
    1/K^2 (``h_init_scale``; at 1.0 the untrained features grow ~0.2 K per
    layer and a 1000-step chain overflows), and no redraws
    (``max_nan_retries=0``): an untrained coordinate head predicts zero
    noise, so its structures are finite but scaled past the 1000 A
    acceptance bound, and a redraw would only repeat the chain.
    """
    kw = dict(n_max=192, compute_dtype="bfloat16", max_nan_retries=0)
    kw.update(overrides)
    cfg = Config(**kw)
    if "h_init_scale" in overrides:
        return cfg
    return cfg.replace(h_init_scale=1.0 / neighbours(cfg) ** 2)


def live_params(cfg: Config, key, *args) -> dict:
    """Random denoiser parameters with a live coordinate head: zero_init_x
    off and the head's kernel scaled by 1/K^2, like the node-MLP output
    (``flagship``). Unscaled, each layer multiplies the positions by ~K
    times a random weight and the distances fed to the next layer grow
    with their square, so a 5-layer forward overflows."""
    params = DiffusionDenoiser(cfg.replace(zero_init_x=False)).init(
        key, *args)
    scale = 1.0 / neighbours(cfg) ** 2
    for lp in params["params"]["egnn"].values():
        lp["mlp_x_dense2"]["kernel"] = lp["mlp_x_dense2"]["kernel"] * scale
    return params


def _cell(cfg: Config, seed: int) -> dict:
    return amorphous_cell(seed=seed, num_atoms=cfg.n_max,
                          spectrum_size=cfg.spectrum_size)


def _noisy_inputs(cfg: Config, seed: int):
    """Denoiser inputs of a mid-chain state: a cell's positions and
    species half-way to noise, t/T = 0.5."""
    cond = collate([_cell(cfg, seed)], cfg.n_max)
    kx, kh = jax.random.split(jax.random.key(seed))
    m3 = cond.mask[..., None]
    pos = (0.7 * cond.pos + 0.7 * jax.random.normal(kx, cond.pos.shape)) * m3
    species = (0.7 * cond.species
               + 0.7 * jax.random.normal(kh, cond.species.shape)) * m3
    t_norm = 0.5 * m3
    edges = (knn_edges(pos, cond.mask, cfg.neighbor_k) if cfg.neighbor_k
             else dense_pair_mask(cond.mask))
    return (species, pos, cond.spectrum, cond.exo, t_norm, cond.mask,
            edges)


def _generate(cfg: Config, trainer, state, cell, seed: int) -> dict:
    t0 = time.perf_counter()
    res = api.generate(cfg, trainer, state, [cell],
                       key=jax.random.key(seed), gen_num_per_spectrum=1,
                       batch_size=1)
    wall = time.perf_counter() - t0
    n = cfg.n_max
    require(res["generated_pos"].shape == (1, n, 3),
            f"generated shape {res['generated_pos'].shape}")
    finite = float(np.mean(res["finite"]))
    accepted = float(np.mean(res["accepted"]))
    require(finite == 1.0 and np.isfinite(res["generated_pos"]).all(),
            f"finite fraction {finite} (want 1.0)")
    return {"finite": finite, "accepted": accepted, "wall_s": wall}


def phase_generation(cfg: Config, steps=(0, 250), seed: int = 0) -> dict:
    """``api.generate`` of one cell per sampler length in ``steps`` (0 =
    the full chain). Each length runs twice: the first call compiles, the
    second is the warm wall time of one structure."""
    trainer = Trainer(cfg)
    cell = _cell(cfg, seed)
    state = trainer.init_state(jax.random.key(seed),
                               collate([cell], cfg.n_max))
    out = {}
    for s in steps:
        c = cfg.replace(sample_steps=s)
        first = _generate(c, trainer, state, cell, seed + 1)
        warm = _generate(c, trainer, state, cell, seed + 2)
        out[f"steps_{s or cfg.num_diffusion_timestep}"] = {
            "finite": warm["finite"], "accepted": warm["accepted"],
            "first_call_s": first["wall_s"], "warm_call_s": warm["wall_s"],
        }
    return out


def phase_training(cfg: Config, work_dir: str, n_cells: int = 5,
                   seed: int = 0) -> dict:
    """``api.train`` for one epoch, then a resumed second epoch: the loss
    stays finite, the step count continues across the resume, and the
    restored checkpoint equals the state training returned."""
    from diffusion_model.train.checkpoint import (
        latest_step,
        restore_checkpoint,
    )

    cells = [_cell(cfg, seed + i) for i in range(n_cells)]
    run_dir = os.path.join(work_dir, "train")
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    t0 = time.perf_counter()
    _, s1, (train_set, _, _) = api.train(cfg, cells, run_dir, num_epochs=1)
    t1 = time.perf_counter()
    steps1 = int(s1.step)
    require(steps1 == len(train_set) // cfg.batch_size and steps1 > 0,
            f"epoch 1 took {steps1} steps")
    require(latest_step(ckpt_dir) == 1, "checkpoint of epoch 1 missing")
    trainer, s2, _ = api.train(cfg, cells, run_dir, num_epochs=2,
                               resume=True)
    t2 = time.perf_counter()
    steps2 = int(s2.step)
    require(steps2 == 2 * steps1,
            f"resume did not continue the step count ({steps1} -> {steps2})")
    require(latest_step(ckpt_dir) == 2, "checkpoint of epoch 2 missing")

    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        losses = [r["train_loss"] for r in map(json.loads, f)
                  if "train_loss" in r]
    require(len(losses) == 2 and all(np.isfinite(losses)),
            f"train losses {losses}")

    example = collate(train_set[:cfg.batch_size], cfg.n_max)
    template = trainer.init_state(jax.random.key(1), example,
                                  skip_gamma_fit=True)
    restored, _ = restore_checkpoint(ckpt_dir, template)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(s2)):
        require(np.array_equal(np.asarray(a), np.asarray(b)),
                "restored checkpoint differs from the trained state")

    compiled = trainer._train_step.lower(
        s2, jax.random.key(2), example).compile()
    return {"steps_per_epoch": steps1, "steps_after_resume": steps2,
            "train_loss": losses, "epoch1_s": t1 - t0, "epoch2_s": t2 - t1,
            "train_step_memory": memory(compiled)}


def _forward_parity(cfg: Config, seed: int) -> dict:
    """The denoiser forward at ``cfg.compute_dtype`` and at f32 default
    precision (TF32 on the GPU) against f32 at precision "highest", on one
    set of random parameters with a live coordinate head."""
    args = _noisy_inputs(cfg, seed)
    params = live_params(cfg, jax.random.key(seed), *args)
    f32 = DiffusionDenoiser(cfg.replace(compute_dtype="float32"))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(f32.apply)(params, *args)
    runs = {"tf32": jax.jit(f32.apply)(params, *args)}
    if cfg.compute_dtype == "bfloat16":
        runs["bfloat16"] = jax.jit(DiffusionDenoiser(cfg).apply)(
            params, *args)
    out = {}
    for name, (ex, eh) in runs.items():
        tol = tolerance(cfg, UNIT_ROUNDOFF[name])
        err_x, err_h = rel_err(ex, ref[0]), rel_err(eh, ref[1])
        require(err_x <= tol and err_h <= tol,
                f"{name} forward off the f32 reference: eps_x {err_x:.3g}, "
                f"eps_h {err_h:.3g}, tolerance {tol:.3g}")
        out[name] = {"eps_x": err_x, "eps_h": err_h, "tol": tol}
    return out


def _chain_parity(cfg: Config, seed: int, steps: int = 10) -> dict:
    """A ``steps``-step sampler chain on the default path against the f32
    "highest" chain, same parameters, condition and key. The untrained
    coordinate head is zero, so the species channel ``h`` carries the
    network's error through the chain; ``pos`` checks the plumbing."""
    c = cfg.replace(sample_steps=steps)
    cond = collate([_cell(cfg, seed)], cfg.n_max)
    params = Trainer(c).init_state(jax.random.key(seed), cond).params

    def run(c_run):
        t = Trainer(c_run)
        return jax.jit(lambda k: sample(
            t.denoise_fn(params), t.schedule_for(params), c_run, k, cond))(
                jax.random.key(seed + 1))

    with jax.default_matmul_precision("highest"):
        ref = run(c.replace(compute_dtype="float32"))
    got = run(c)
    require(bool(np.all(ref.finite)) and bool(np.all(got.finite)),
            "non-finite sampler chain")
    u = UNIT_ROUNDOFF["bfloat16" if c.compute_dtype == "bfloat16"
                      else "tf32"]
    tol = tolerance(c, u)
    errs = {"pos": rel_err(got.pos, ref.pos), "h": rel_err(got.h, ref.h)}
    require(max(errs.values()) <= tol,
            f"{steps}-step chain off the f32 reference: {errs}, "
            f"tolerance {tol:.3g}")
    return {**errs, "tol": tol}


def _golden_parity() -> dict:
    """Both committed checkpoints reproduce the outputs recorded for them
    (tests/data/flax_golden.npz) at f32, precision "highest"."""
    from diffusion_model.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )

    g = np.load(os.path.join(ROOT, "tests", "data", "flax_golden.npz"))
    args = tuple(jnp.asarray(g[k]) for k in (
        "in_species", "in_pos", "in_spectrum", "in_exo", "in_t_norm",
        "in_mask"))
    out = {}
    for name in ("q_predef_r5", "q_learned_r5_s2025"):
        path = os.path.join(ROOT, "artifacts", f"{name}.npz")
        cfg = load_config_npz(path).replace(compute_dtype="float32")
        params = load_params_npz(path)["denoiser"]
        model = DiffusionDenoiser(cfg)
        with jax.default_matmul_precision("highest"):
            ex, eh = jax.jit(model.apply)(params, *args,
                                          dense_pair_mask(args[5]))
        tol = reorder_tolerance(cfg.replace(n_max=args[1].shape[1]))
        err_x = rel_err(ex, g[f"{name}/dense_eps_x"])
        err_h = rel_err(eh, g[f"{name}/dense_eps_h"])
        require(err_x <= tol and err_h <= tol,
                f"{name} off its recorded outputs: {err_x:.3g}, "
                f"{err_h:.3g} > {tol:.3g}")
        out[name] = {"eps_x": err_x, "eps_h": err_h, "tol": tol}
    return out


def phase_parity(cfg: Config, seed: int = 0, golden: bool = True) -> dict:
    out = {"forward": _forward_parity(cfg, seed),
           "chain_10": _chain_parity(cfg, seed)}
    if golden:
        out["golden"] = _golden_parity()
    return out


def time_denoiser(cfg: Config, seed: int = 0, reps: int = 5) -> dict:
    """Warm time of one jitted denoiser call (kNN edges included) and its
    compiled memory analysis."""
    species, pos, spec, exo, t_norm, mask, _ = _noisy_inputs(cfg, seed)
    model = DiffusionDenoiser(cfg)

    def call(p, species, pos, spec, exo, t_norm, mask):
        edges = (knn_edges(pos, mask, cfg.neighbor_k) if cfg.neighbor_k
                 else dense_pair_mask(mask))
        return model.apply(p, species, pos, spec, exo, t_norm, mask, edges)

    args = (species, pos, spec, exo, t_norm, mask)
    params = model.init(jax.random.key(seed), *args,
                        knn_edges(pos, mask, cfg.neighbor_k)
                        if cfg.neighbor_k else dense_pair_mask(mask))
    fn = jax.jit(call)
    compiled = fn.lower(params, *args).compile()
    jax.block_until_ready(fn(params, *args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(params, *args)
    jax.block_until_ready(out)
    return {"denoiser_call_ms": (time.perf_counter() - t0) / reps * 1e3,
            "memory": memory(compiled)}


def phase_knn(sizes=(2048, 4096), k: int = 32, steps: int = 10,
              seed: int = 0, **overrides) -> dict:
    """The large-cell kNN route at each size in ``sizes``."""
    out = {}
    for n in sizes:
        cfg = flagship(n_max=n, neighbor_k=k, h_residual=True,
                       virtual_node=True, sample_steps=steps, **overrides)
        trainer = Trainer(cfg)
        cell = _cell(cfg, seed)
        state = trainer.init_state(jax.random.key(seed),
                                   collate([cell], n))
        gen = _generate(cfg, trainer, state, cell, seed + 1)
        timing = time_denoiser(cfg, seed)
        out[str(n)] = {"generate": gen, **timing,
                       "forward_parity": _forward_parity(cfg, seed),
                       "peak_bytes_in_use": peak_bytes()}
    return out


def phase_serving(cfg: Config, work_dir: str, batch_size: int = 2,
                  requests: int = 3, seed: int = 0) -> dict:
    """Export the sampler for this device's platform and answer
    ``requests`` calls through the deserialized artifact alone."""
    from diffusion_model.serve import ServedSampler, export_sampler

    platform = {"gpu": "cuda"}.get(jax.devices()[0].platform,
                                   jax.devices()[0].platform)
    cells = [_cell(cfg, seed + i) for i in range(batch_size)]
    cond = collate(cells, cfg.n_max)
    trainer = Trainer(cfg)
    state = trainer.init_state(jax.random.key(seed), cond)
    path = os.path.join(work_dir, "sampler.bin")
    t0 = time.perf_counter()
    export_sampler(cfg, trainer, state, path, batch_size=batch_size,
                   platforms=(platform,))
    export_s = time.perf_counter() - t0
    served = ServedSampler(path)
    times, accepted = [], []
    for r in range(requests):
        t0 = time.perf_counter()
        pos, species, acc = served(r, cond.spectrum, cond.exo, cond.mask)
        times.append(time.perf_counter() - t0)
        require(pos.shape == (batch_size, cfg.n_max, 3)
                and species.shape == (batch_size, cfg.n_max,
                                      cfg.atom_type_size),
                f"served shapes {pos.shape}, {species.shape}")
        require(bool(np.isfinite(pos).all()), "served non-finite positions")
        accepted.append(float(np.mean(acc)))
    return {"platform": platform, "export_s": export_s,
            "request_s": times, "accepted": accepted}


def phase_dp(cfg: Config, mesh, seed: int = 0) -> dict:
    """One data-parallel train step over ``mesh`` against the same step on
    one device, f32 at precision "highest"."""
    from diffusion_model.parallel import replicate, shard_graph_batch

    c = cfg.replace(compute_dtype="float32", batch_size=mesh.devices.size,
                    optimizer="Adam")
    batch = collate([_cell(c, seed + i) for i in range(c.batch_size)],
                    c.n_max)
    trainer = Trainer(c)
    with jax.default_matmul_precision("highest"):
        state = trainer.init_state(jax.random.key(seed), batch)
        key = jax.random.key(seed + 1)
        _, one = trainer.train_step(state, key, batch)
        _, dp = trainer.train_step(jax.device_put(state, replicate(mesh)),
                                   key, shard_graph_batch(batch, mesh, "dp"))
    tol = reorder_tolerance(c)
    errs = {k: rel_err(dp[k], one[k]) for k in ("loss", "grad_norm")}
    require(max(errs.values()) <= tol and np.isfinite(float(one["loss"])),
            f"DP step off the one-device step: {errs}, tolerance {tol:.3g}")
    return {"loss_one": float(one["loss"]), "loss_dp": float(dp["loss"]),
            "rel_err": errs, "tol": tol}


def phase_ring(cfg: Config, mesh, steps: int = 10, seed: int = 0) -> dict:
    """``api.generate_ring`` over ``mesh`` against ``api.generate`` on one
    device, same key, f32 at precision "highest"."""
    c = cfg.replace(compute_dtype="float32", sample_steps=steps)
    cell = _cell(c, seed)
    trainer = Trainer(c)
    with jax.default_matmul_precision("highest"):
        state = trainer.init_state(jax.random.key(seed),
                                   collate([cell], c.n_max))
        key = jax.random.key(seed + 1)
        dense = api.generate(c, trainer, state, [cell], key=key,
                             gen_num_per_spectrum=1, batch_size=1)
        ring = api.generate_ring(c, trainer, state, [cell], mesh=mesh,
                                 key=key, gen_num_per_spectrum=1)
    require(bool(np.all(dense["finite"])) and bool(np.all(ring["finite"])),
            "non-finite ring or dense chain")
    tol = reorder_tolerance(c)
    errs = {k: rel_err(ring[f"generated_{k}"], dense[f"generated_{k}"])
            for k in ("pos", "h")}
    require(max(errs.values()) <= tol,
            f"ring chain off the dense chain: {errs}, tolerance {tol:.3g}")
    return {**errs, "tol": tol}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card phases (DP train step, "
                        "ring sampling)")
    args = p.parse_args(argv)

    cache_dir = setup_compile_cache()
    info = check_device(cache_dir)
    card = nvidia_smi()
    print(json.dumps({"phase": "device", **info}), flush=True)
    print(f"card: {card}", flush=True)

    def report(name, fn, *a, **kw):
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        print(json.dumps({"phase": name, "seconds": time.perf_counter() - t0,
                          "card": card, **res}), flush=True)

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir=build)
    try:
        if args.four:
            from diffusion_model.parallel import make_mesh

            if info["count"] < 4:
                raise RuntimeError(f"--four needs 4 devices, "
                                   f"found {info['count']}")
            mesh = make_mesh((4,), ("data",), devices=jax.devices()[:4])
            report("dp_train_step", phase_dp, flagship(), mesh)
            report("ring_sampling", phase_ring, flagship(), mesh)
        else:
            cfg = flagship()
            report("generation", phase_generation, cfg)
            report("training", phase_training, cfg, work_dir)
            report("parity", phase_parity, cfg)
            report("knn", phase_knn)
            report("serving", phase_serving, cfg.replace(sample_steps=250),
                   work_dir)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
