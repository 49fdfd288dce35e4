"""Export a trained run's sampler as a serving artifact (serve.py).

The reference's deployment story is "clone the repo, reload the .pth,
re-run the Python loop" (ref generate_amorphous.py:25-147); here one
command turns a finished run directory into a single StableHLO artifact a
serving process can call without any model code::

    python -m diffusion_model.cli.export \
        --run_dir runs/flagship --out runs/flagship/sampler.bin \
        --batch_size 16 --sample_steps 250 --deterministic
"""

from __future__ import annotations

import argparse

import numpy as np

from diffusion_model import api
from diffusion_model.data.batch import GraphBatch
from diffusion_model.serve import export_sampler
from diffusion_model.utils.logging import load_run_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--out", type=str, required=True,
                   help="artifact path (metadata sidecar at <out>.json)")
    p.add_argument("--batch_size", type=int, default=16,
                   help="conditions per call (one compiled program per "
                        "shape bucket)")
    p.add_argument("--sample_steps", type=int, default=None,
                   help="override: strided sampler step count (0 = full)")
    p.add_argument("--deterministic", action="store_true",
                   help="override: DDIM eta=0 sampling")
    p.add_argument("--platforms", type=str, default="cpu,cuda",
                   help="comma-separated lowering targets")
    p.add_argument("--retry_rounds", type=int, default=0,
                   help="bake a bounded in-graph redraw loop into the "
                        "artifact (0 = caller owns the redraw contract)")
    p.add_argument("--calibrate", type=int, default=0,
                   help="measure single-draw acceptance over this many "
                        "sampling calls on synthetic conditions and record "
                        "it in the sidecar")
    return p


def _calibrate_acceptance(cfg, trainer, state, batch_size: int,
                          calls: int) -> dict:
    """Measured single-draw acceptance rate of the live sampler at the
    export shape, over synthetic SiO2 conditions — the number a serving
    operator needs to size the redraw budget (artifact-side retry rounds
    or caller-side re-calls)."""
    from functools import partial

    import jax

    from diffusion_model.data.batch import collate
    from diffusion_model.data.synthetic import synthetic_sio2_dataset
    from diffusion_model.diffusion import sample

    params = state.eval_params(cfg)
    jitted = jax.jit(partial(sample, trainer.denoise_fn(params),
                             trainer.schedule_for(params), cfg))
    graphs = synthetic_sio2_dataset(cfg.seed + 99, batch_size, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size)
    cond = collate(graphs, cfg.n_max)
    accepted = total = 0
    for i in range(calls):
        res = jitted(jax.random.key(1000 + i), cond)
        accepted += int(np.asarray(res.accepted).sum())
        total += batch_size
    return {
        "single_draw_accepted_fraction": accepted / max(total, 1),
        "calls": calls,
        "samples": total,
        "conditions": "synthetic_sio2",
    }


def main(argv=None):
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    args = build_parser().parse_args(argv)
    cfg = load_run_config(args.run_dir)
    if args.sample_steps is not None:
        cfg = cfg.replace(sample_steps=args.sample_steps)
    if args.deterministic:
        cfg = cfg.replace(deterministic_sampling=True)

    # a dummy condition batch fixes the restore template's shapes
    b, n = args.batch_size, cfg.n_max
    example = GraphBatch(
        pos=np.zeros((1, n, 3), np.float32),
        species=np.zeros((1, n, cfg.atom_type_size), np.float32),
        spectrum=np.zeros((1, n, cfg.spectrum_size), np.float32),
        exo=np.zeros((1, n, 1), np.float32),
        mask=np.ones((1, n), np.float32),
    )
    trainer, state = api.load_trained(args.run_dir, cfg, example)
    stats = None
    if args.calibrate:
        stats = _calibrate_acceptance(cfg, trainer, state, b,
                                      args.calibrate)
        print(f"calibrated acceptance: {stats}")
    export_sampler(cfg, trainer, state, args.out, batch_size=b,
                   platforms=tuple(args.platforms.split(",")),
                   retry_rounds=args.retry_rounds,
                   acceptance_stats=stats)
    print(f"exported sampler ({b}x{n} atoms, "
          f"{cfg.sample_steps or cfg.num_diffusion_timestep} steps, "
          f"{args.retry_rounds} in-graph retry rounds) to {args.out}")


if __name__ == "__main__":
    main()
