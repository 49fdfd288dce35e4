"""Quality-parity demonstration (the notebook analogue of the reference's
model_flex.ipynb walkthrough).

Trains the full reference architecture (L=5, 1024-wide MLPs, schedule-free
RAdam, polynomial schedule, T=1000) on synthetic SiO2 local environments,
generates 5 structures per held-out condition with the 1000-step scan
sampler, and reports the reference's acceptance metrics: RDF cosine
similarity, Si-exO-Si angle R^2, Kabsch RMSD and O-density accuracy,
writing figures + a JSON summary under --out_dir.

Run on GPU:   python examples/quality_demo.py --out_dir docs/quality
Quick check:  python examples/quality_demo.py --epochs 100 --num 64
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
    p.add_argument("--out_dir", type=str, default="runs/quality_demo")
    p.add_argument("--num", type=int, default=256)
    p.add_argument("--epochs", type=int, default=1500)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--noise_schedule", type=str, default="predefined",
                   choices=("predefined", "learned"))
    p.add_argument("--gamma_init", type=str, default="reference",
                   choices=("reference", "polynomial"),
                   help="learned-schedule gamma init; 'polynomial' "
                        "(pre-fit to this config's schedule) is the "
                        "measured-better recipe (docs/quality/"
                        "learned_origin_test.json: 0.860/0.928 vs "
                        "0.829/0.900 rdf_cos)")
    p.add_argument("--n_max", type=int, default=8)
    p.add_argument("--shells", type=int, default=1,
                   help="1 = CN Si neighbours only; 2 = + bridging O shell")
    p.add_argument("--h_residual", action="store_true",
                   help="opt-in residual node update (config.h_residual)")
    p.add_argument("--tag", type=str, default=None,
                   help="config label recorded in the summary JSON")
    p.add_argument("--seed", type=int, default=2024,
                   help="config seed (init + data split + sampling keys) — "
                        "the seed-variance knob for the learned-schedule "
                        "recipe characterisation (VERDICT r4 #3)")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="periodic checkpoint cadence in epochs (0 = only "
                        "the final checkpoint) — set ~300 under the "
                        "watchdog so a wedge kill+resume loses little")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in out_dir "
                        "(api.train resume) — a relaunched run keeps "
                        "its trained epochs")
    args = p.parse_args()

    from diffusion_model import api
    from diffusion_model.config import Config
    from diffusion_model.data.synthetic import synthetic_sio2_dataset
    from diffusion_model.evals import (
        evaluate_rdf_lists,
        per_graph_group_means,
        r2score,
    )
    from diffusion_model.ops.angles import cn2_angle_deg
    from diffusion_model.utils.logging import RunLogger

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cfg = Config(
        n_max=args.n_max,
        batch_size=args.batch_size,
        lr=args.lr,
        num_diffusion_timestep=args.timesteps,
        num_epochs=args.epochs,
        optimizer="RAdamScheduleFree",
        compute_dtype="bfloat16",
        noise_schedule=args.noise_schedule,
        gamma_init=args.gamma_init,
        h_residual=args.h_residual,
        seed=args.seed,
        checkpoint_every=args.checkpoint_every,
    )
    print(f"devices: {jax.devices()}", flush=True)
    graphs = synthetic_sio2_dataset(cfg.seed, args.num, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=args.shells)
    logger = RunLogger(args.out_dir, cfg)

    t0 = time.time()
    trainer, state, (train_set, val_set, test_set) = api.train(
        cfg, graphs, args.out_dir, logger, resume=args.resume
    )
    train_s = time.time() - t0
    print(f"trained {args.epochs} epochs in {train_s:.0f}s", flush=True)

    t0 = time.time()
    results = api.generate(cfg, trainer, state, test_set)
    gen_s = time.time() - t0
    finite = float(results["finite"].mean())
    print(f"generated {len(results['ids'])} structures in {gen_s:.0f}s "
          f"(finite fraction {finite:.3f})", flush=True)

    np.savez_compressed(
        os.path.join(args.out_dir, "generated.npz"),
        **{k: v for k, v in results.items() if k != "ids"},
        ids=np.asarray(results["ids"]),
    )
    logger.register_artifact(
        "generated_graph_save_path",
        os.path.join(args.out_dir, "generated.npz"),
    )

    summary = api.evaluate(results, args.out_dir, logger, create_xyz=True)

    keep = np.nonzero(results["accepted"])[0]
    rdf_rows = evaluate_rdf_lists(
        results["original_pos"][keep], results["mask"][keep],
        results["generated_pos"][keep], results["mask"][keep],
    )
    rdf_cos = np.asarray([r["cos"] for r in rdf_rows])

    # Angle parity the reference's way (ref CN2_evaluate.py:176-286),
    # shell-agnostic: CN2 conditions are 3 atoms on 1-shell data, 5 on
    # 2-shell; generated Si are located by species argmax
    # (evals.conditional_angle_parity — the fixed-row readout this
    # replaces silently measured exO-Si-O angles on 2-shell data).
    from diffusion_model.evals import conditional_angle_parity

    g = cfg.gen_num_per_spectrum
    angle_r2 = None
    angle_mae = None
    avg_o, avg_g = conditional_angle_parity(results, g)
    if len(avg_o) >= 3:
        angle_r2 = r2score(avg_o, avg_g)
        angle_mae = float(np.mean(np.abs(avg_o - avg_g)))
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.plot([0, 180], [0, 180], "-", color="red", alpha=0.5)
        ax.plot(avg_o, avg_g, "o", alpha=0.6)
        ax.set_xlabel("original Si-exO-Si angle [deg]")
        ax.set_ylabel("generated Si-exO-Si angle [deg]")
        ax.set_title(f"CN2 angle parity (R^2 = {angle_r2:.3f})")
        logger.log_figure("cn2_angle_parity", fig)
        plt.close(fig)

    # Information ceiling: a 1-NN regressor in spectrum space bounds what
    # any conditional model can extract (evals/baseline.py). Computed on
    # TRUE angles of the CN2 conditions, train -> test.
    angle_nn_ceiling = None
    tr2 = [gr for gr in train_set if gr.get("cn") == 2]
    te2 = [gr for gr in test_set if gr.get("cn") == 2]
    if angle_r2 is not None and len(tr2) >= 3 and len(te2) >= 3:
        from diffusion_model.evals import nn_ceiling_r2

        angle_nn_ceiling = nn_ceiling_r2(
            np.stack([gr["spectrum"][0] for gr in tr2]),
            np.asarray(cn2_angle_deg(
                np.stack([gr["pos"][:3] for gr in tr2]))),
            np.stack([gr["spectrum"][0] for gr in te2]),
            np.asarray(cn2_angle_deg(
                np.stack([gr["pos"][:3] for gr in te2]))),
        )

    out = {
        "config": args.tag or f"{args.epochs}ep_{args.shells}shell_n{args.n_max}",
        "noise_schedule": cfg.noise_schedule,
        "train_seconds": round(train_s, 1),
        "generate_seconds": round(gen_s, 1),
        "num_conditions": len(test_set),
        "finite_fraction": finite,
        "num_accepted": int(summary["num_accepted"]),
        "rdf_cos_mean": float(rdf_cos.mean()),
        "rdf_cos_median": float(np.median(rdf_cos)),
        "cn2_angle_r2": angle_r2,
        "cn2_angle_mae_deg": angle_mae,
        "cn2_angle_r2_nn_ceiling": angle_nn_ceiling,
        "rmsd_best": float(summary["sorted_rmsd"][0][1]),
        "rmsd_median": float(
            summary["sorted_rmsd"][len(summary["sorted_rmsd"]) // 2][1]
        ),
        "atom_type_accuracy": summary["atom_type_accuracy"],
    }
    with open(os.path.join(args.out_dir, "quality_summary.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
