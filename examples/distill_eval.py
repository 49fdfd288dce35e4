"""Progressive-distillation evaluation: distill a trained flagship into a
few-step student and compare three sampling regimes on the held-out set —

  * full ancestral sampling (T steps, the reference's regime,
    ref parts/train_per_iretation.py:335-389)
  * strided ancestral sampling (``sample_steps=K``, no retraining)
  * the distilled K-step deterministic student

reporting RDF cosine parity and wall-clock per structure for each, into
``--out_dir/distill_summary.json``.

Run on the GPU after a quality run:
  python examples/distill_eval.py --run_dir runs/q_predef_r2 \
      --final_steps 125 --out_dir docs/quality
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np


def main():
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, default="runs/distill_eval")
    p.add_argument("--final_steps", type=int, default=125)
    p.add_argument("--epochs_per_phase", type=int, default=60)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--num", type=int, default=256)
    p.add_argument("--n_max", type=int, default=16)
    p.add_argument("--shells", type=int, default=2)
    p.add_argument("--epochs", type=int, default=3000,
                   help="must match the run's config (for records only)")
    args = p.parse_args()

    from diffusion_model import api
    from diffusion_model.config import Config
    from diffusion_model.data.batch import collate
    from diffusion_model.data.split import split_dataset
    from diffusion_model.data.synthetic import synthetic_sio2_dataset
    from diffusion_model.evals import evaluate_rdf_lists

    cfg = Config(
        n_max=args.n_max,
        batch_size=64,
        num_diffusion_timestep=1000,
        optimizer="RAdamScheduleFree",
        compute_dtype="bfloat16",
    )
    print(f"devices: {jax.devices()}", flush=True)
    graphs = synthetic_sio2_dataset(cfg.seed, args.num, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=args.shells)
    graphs = api.prepare_dataset(graphs, cfg)
    train_set, val_set, test_set = split_dataset(graphs, cfg.seed)
    example = collate(train_set[: cfg.batch_size], cfg.n_max)
    trainer, state = api.load_trained(args.run_dir, cfg, example)

    t0 = time.time()
    student_cfg, student_state = api.distill(
        cfg, trainer, state, train_set,
        final_steps=args.final_steps,
        epochs_per_phase=args.epochs_per_phase,
        lr=args.lr,
    )
    distill_s = time.time() - t0
    print(f"distilled to {args.final_steps} steps in {distill_s:.0f}s",
          flush=True)

    def run(tag, run_cfg, run_state):
        t0 = time.time()
        results = api.generate(run_cfg, trainer, run_state, test_set)
        gen_s = time.time() - t0
        keep = np.nonzero(results["accepted"])[0]
        rows = evaluate_rdf_lists(
            results["original_pos"][keep], results["mask"][keep],
            results["generated_pos"][keep], results["mask"][keep],
        )
        cos = np.asarray([r["cos"] for r in rows])
        out = {
            "generate_seconds": round(gen_s, 1),
            "seconds_per_structure": round(gen_s / len(results["ids"]), 3),
            "finite_fraction": float(results["finite"].mean()),
            "accepted": int(results["accepted"].sum()),
            "rdf_cos_mean": float(cos.mean()),
            "rdf_cos_median": float(np.median(cos)),
        }
        print(tag, json.dumps(out), flush=True)
        return out

    summary = {
        "run_dir": args.run_dir,
        "final_steps": args.final_steps,
        "distill_seconds": round(distill_s, 1),
        "epochs_per_phase": args.epochs_per_phase,
        "full_1000": run("full_1000", cfg, state),
        "strided": run(
            f"strided_{args.final_steps}",
            cfg.replace(sample_steps=args.final_steps), state,
        ),
        "distilled": run(
            f"distilled_{args.final_steps}", student_cfg, student_state
        ),
    }
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "distill_summary.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
