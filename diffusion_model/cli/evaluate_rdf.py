"""RDF evaluator CLI — equivalent of ref evaluate_RDF.py.

Computes exO-centred RDFs for original vs generated structures, the four
similarity metrics (cosine/euclidean/MSE/Wasserstein), metric histograms,
and best/median/worst RDF comparison panels.
"""

from __future__ import annotations

import argparse

import numpy as np

from diffusion_model.cli.common import load_results
from diffusion_model.evals import evaluate_rdf_lists
from diffusion_model.utils.logging import RunLogger


def main(argv=None):
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--metric", type=str, default="cos",
                   choices=["cos", "euclidean", "mse", "wasserstein"])
    args = p.parse_args(argv)

    results = load_results(args.run_dir)
    logger = RunLogger(args.run_dir)
    rows = evaluate_rdf_lists(
        results["original_pos"], results["mask"],
        results["generated_pos"], results["mask"],
    )
    values = np.asarray([r[args.metric] for r in rows])
    if values.size == 0:
        # e.g. every sample rejected on an undertrained run: there is
        # nothing to histogram/panel — report explicitly instead of
        # crashing on the empty argsort (same class of guard as the CN2
        # empty-bond case)
        logger.log({f"rdf_{args.metric}_mean": float("nan"),
                    f"rdf_{args.metric}_std": float("nan")})
        print(f"rdf {args.metric}: no accepted samples to evaluate")
        return

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.hist(values, bins=40)
    ax.set_xlabel(args.metric)
    ax.set_ylabel("count")
    ax.set_title(f"RDF {args.metric} distribution")
    logger.log_figure(f"rdf_{args.metric}_hist", fig)
    plt.close(fig)

    # best / median / worst panels (cos: higher better; others lower better)
    order = np.argsort(values)
    if args.metric == "cos":
        order = order[::-1]
    picks = {"best": order[0], "mid": order[len(order) // 2],
             "worst": order[-1]}
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    r_axis = np.arange(len(rows[0]["rdf_original"])) * 0.01 + 0.01
    for ax, (name, idx) in zip(axes, picks.items()):
        ax.plot(r_axis, rows[idx]["rdf_original"], label="original")
        ax.plot(r_axis, rows[idx]["rdf_generated"], label="generated")
        ax.set_title(f"{name} ({args.metric}={values[idx]:.4f})")
        ax.set_xlabel("r [A]")
        ax.legend()
    logger.log_figure(f"rdf_{args.metric}_panels", fig)
    plt.close(fig)

    logger.log({
        f"rdf_{args.metric}_mean": float(values.mean()),
        f"rdf_{args.metric}_std": float(values.std()),
    })
    print(f"rdf {args.metric}: mean {values.mean():.5f} "
          f"std {values.std():.5f} over {len(values)} pairs")


if __name__ == "__main__":
    main()
