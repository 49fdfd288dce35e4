"""Headline benchmark: 1000-step generation of a 192-atom SiO2 cell.

Prints one JSON line:
  {"metric": "atoms*denoise_steps/sec/chip", "value": N, "unit": "...",
   "seconds_per_structure": ..., "device": {...}, "card": "..."}

``device`` is the accelerator as JAX reports it and ``card`` the card's
name and power limit from nvidia-smi. The benchmark runs on the GPU only:
on any other backend it exits non-zero without a result.

``--run_dir <dir>`` benches a *trained* checkpoint instead of random-init
parameters (same architecture — EGNN parameters are independent of the
padded node count, so quality-run checkpoints load directly); the JSON
line then carries "params": "trained:<dir>".
"""

import argparse
import json
import os
import sys
import time

import jax


def main():
    from diffusion_model.data.split import batch_iterator
    from diffusion_model.data.synthetic import amorphous_cell
    from diffusion_model.diffusion import sample
    from diffusion_model.train import Trainer

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", type=str, default=None,
                   help="bench a trained checkpoint from this run dir")
    args = p.parse_args()

    from chip_smoke import check_device, flagship, nvidia_smi
    from diffusion_model.utils import setup_compile_cache

    setup_compile_cache()
    info = check_device()

    n_atoms = 192
    steps = 1000
    cfg = flagship(n_max=n_atoms, num_diffusion_timestep=steps)
    if args.run_dir:
        # Take the run's persisted config (architecture, noise schedule —
        # a learned-schedule run carries a gamma subtree the bench default
        # would not build) but keep the bench workload shapes.
        from diffusion_model.utils.logging import load_run_config

        cfg = load_run_config(args.run_dir).replace(
            n_max=n_atoms, num_diffusion_timestep=steps,
            compute_dtype="bfloat16", sample_steps=0)

    cell = amorphous_cell(seed=0, num_atoms=n_atoms,
                          spectrum_size=cfg.spectrum_size)
    cond = next(batch_iterator([cell], 1, cfg.n_max))

    trainer = Trainer(cfg)
    state = trainer.init_state(jax.random.key(0), cond)
    params_src = "random-init"
    if args.run_dir:
        from diffusion_model.train.checkpoint import restore_checkpoint

        state, _ = restore_checkpoint(
            os.path.join(os.path.abspath(args.run_dir), "checkpoints"),
            state)
        params_src = f"trained:{args.run_dir}"
    eval_params = state.eval_params(cfg)
    fn = trainer.denoise_fn(eval_params)
    schedule = trainer.schedule_for(eval_params)

    def timed(cfg_v):
        run = jax.jit(lambda key: sample(fn, schedule, cfg_v, key, cond))
        jax.block_until_ready(run(jax.random.key(1)))  # compile + warm-up
        times = []
        for i in range(3):
            t_start = time.perf_counter()
            jax.block_until_ready(run(jax.random.key(2 + i)))
            times.append(time.perf_counter() - t_start)
        return min(times)

    best = timed(cfg)
    # fast mode: 250-step strided sampler (RDF parity within noise of the
    # full 1000-step chain — docs/quality/strided_eval.json)
    strided = timed(cfg.replace(sample_steps=250))

    rate = n_atoms * steps / best  # atoms * denoise-steps per second
    print(json.dumps({
        "metric": "atoms*denoise_steps/sec/chip (192-atom cell, 1000-step sampler)",
        "value": rate,
        "unit": "atoms*steps/s",
        "seconds_per_structure": best,
        "structures_per_hour": 3600.0 / best,
        "strided_250_seconds_per_structure": strided,
        "strided_250_structures_per_hour": 3600.0 / strided,
        "params": params_src,
        "device": {k: info[k] for k in ("platform", "kind", "count")},
        "card": nvidia_smi(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
