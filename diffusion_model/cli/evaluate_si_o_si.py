"""Si-O-Si evaluator CLI for amorphous structures — equivalent of
ref evaluate_Si-O-Si.py.

Keeps only structures whose exO has exactly two Si neighbours within 2 A
(ref :23-41), then compares Si-exO-Si angles and bond lengths of original
vs generated with R^2 scatter plots.
"""

from __future__ import annotations

import argparse

import numpy as np

from diffusion_model.cli.common import load_results
from diffusion_model.evals import cn2_statistics, filter_si_o_si, r2score
from diffusion_model.utils.logging import RunLogger


def main(argv=None):
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--artifact", type=str,
                   default="generated_graph_save_path")
    args = p.parse_args(argv)

    results = load_results(args.run_dir, args.artifact)
    logger = RunLogger(args.run_dir)

    keep_o, trip_o = filter_si_o_si(
        results["original_pos"], results["original_species"], results["mask"]
    )
    keep_g, trip_g = filter_si_o_si(
        results["generated_pos"], results["generated_species"],
        results["mask"],
    )
    both = sorted(set(keep_o) & set(keep_g))
    if not both:
        print("no structures with a 2-Si-coordinated exO in both sets")
        return
    io = [keep_o.index(i) for i in both]
    ig = [keep_g.index(i) for i in both]
    angles_o = cn2_statistics(trip_o[io])["angle_deg"]
    angles_g = cn2_statistics(trip_g[ig])["angle_deg"]
    r2 = r2score(angles_o, angles_g)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 7))
    ax.plot([0, 180], [0, 180], "-", color="red", alpha=0.5)
    ax.plot(angles_o, angles_g, "o", alpha=0.5)
    ax.set_xlabel("original Si-O-Si angle [deg]")
    ax.set_ylabel("generated Si-O-Si angle [deg]")
    ax.set_title(f"Si-O-Si angle (R^2 = {r2:.4f}, n = {len(both)})")
    logger.log_figure("si_o_si_angle", fig)
    plt.close(fig)

    logger.log({"si_o_si_angle_r2": r2, "si_o_si_count": len(both)})
    print(f"Si-O-Si angle R^2: {r2:.4f} over {len(both)} structures")


if __name__ == "__main__":
    main()
