"""Probe: does batched generation raise per-chip sampler throughput?

The headline metric is atoms*denoise_steps/sec/chip (bench.py), measured
at batch 1. Larger batched matmuls may amortise per-step overheads, and
the reference's own operating point generates 5 samples per condition
(ref parts/train_per_iretation.py:264,295), so a batched number is the
honest serving-throughput readout, not a trick.

Times jit(sample) at the bench workload (192 atoms, 1000 steps, bf16
dense path, random-init params) for batch sizes 1/2/4, one jit per call.
Writes docs/perf/batch_throughput.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    from diffusion_model.config import Config
    from diffusion_model.data.split import batch_iterator
    from diffusion_model.data.synthetic import amorphous_cell
    from diffusion_model.diffusion import predefined_schedule, sample
    from diffusion_model.nn import DiffusionDenoiser

    n_atoms, steps = 192, 1000
    cfg = Config(n_max=n_atoms, num_diffusion_timestep=steps,
                 compute_dtype="bfloat16")
    cells = [amorphous_cell(seed=s, num_atoms=n_atoms,
                            spectrum_size=cfg.spectrum_size)
             for s in range(4)]

    model = DiffusionDenoiser(cfg)
    cond1 = next(batch_iterator(cells[:1], 1, cfg.n_max))
    b, n = cond1.mask.shape
    t0 = jnp.full((b, n, 1), 0.5) * cond1.mask[..., None]
    params = model.init(
        jax.random.key(0), cond1.species, cond1.pos, cond1.spectrum,
        cond1.exo, t0, cond1.mask, cond1.pair_mask(),
    )
    fn = lambda *a: model.apply(params, *a)
    schedule = predefined_schedule(cfg)

    out = {"workload": f"{n_atoms} atoms x {steps} steps, bf16 dense",
           "params": "random-init", "batches": {}}
    for bs in (1, 2, 4):
        cond = next(batch_iterator(cells[:bs], bs, cfg.n_max))
        run = jax.jit(lambda key, c=cond: sample(fn, schedule, cfg, key, c))
        jax.block_until_ready(run(jax.random.key(1)))  # compile + warm-up
        times = []
        for i in range(3):
            t_start = time.perf_counter()
            jax.block_until_ready(run(jax.random.key(2 + i)))
            times.append(time.perf_counter() - t_start)
        best = min(times)
        row = {
            "seconds_per_call": round(best, 3),
            "seconds_per_structure": round(best / bs, 3),
            "atoms_steps_per_sec": round(bs * n_atoms * steps / best, 1),
        }
        out["batches"][str(bs)] = row
        print(f"B={bs}: {row}", flush=True)

    r1 = out["batches"]["1"]["atoms_steps_per_sec"]
    r4 = out["batches"]["4"]["atoms_steps_per_sec"]
    out["batch4_speedup"] = round(r4 / r1, 3)
    os.makedirs("docs/perf", exist_ok=True)
    with open("docs/perf/batch_throughput.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
