"""CN2 angle/bond evaluator CLI — equivalent of ref CN2_evaluate.py.

For 2-coordinated exO structures: Si-exO-Si angles and bond lengths,
averaged per condition over the gen_num_per_spectrum samples, scatter with
marginal histograms and the hand-rolled R^2 score
(ref CN2_evaluate.py:176-286).
"""

from __future__ import annotations

import argparse

import numpy as np

from diffusion_model.cli.common import load_results
from diffusion_model.evals import r2score
from diffusion_model.evals.cn2 import (
    _cn2_sample_geometry,
    conditional_angle_parity,
    conditional_bond_parity,
)
from diffusion_model.utils.logging import RunLogger, load_run_config


def main(argv=None):
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", type=str, required=True)
    args = p.parse_args(argv)

    cfg = load_run_config(args.run_dir)
    # accepted_only=False: group means need the contiguous groups-of-g
    # layout; rejected/invalid rows are NaN-filled so their groups drop
    # out of per_graph_group_means instead of shifting later groups
    results = load_results(args.run_dir, accepted_only=False)
    logger = RunLogger(args.run_dir)
    g = cfg.gen_num_per_spectrum

    # shell-agnostic CN2 readout (evals/cn2: originals from rows 1,2,
    # generated Si located by species argmax); extract the per-sample
    # geometry ONCE and share it across both parity readouts and the raw
    # bond scatter (it is the dominant cost on large result sets)
    geo = _cn2_sample_geometry(results)
    avg_theta, avg_phi = conditional_angle_parity(results, g, geo=geo)
    n = len(avg_theta)
    r2 = r2score(avg_theta, avg_phi)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.gridspec import GridSpec

    gs = GridSpec(2, 2, height_ratios=[1, 4], width_ratios=[4, 1])
    fig = plt.figure(figsize=(10, 10))
    ax_sc = fig.add_subplot(gs[1, 0])
    ax_hx = fig.add_subplot(gs[0, 0], sharex=ax_sc)
    ax_hy = fig.add_subplot(gs[1, 1], sharey=ax_sc)
    ax_sc.plot([0, 180], [0, 180], zorder=3, alpha=0.7)
    ax_sc.plot(avg_theta, avg_phi, "o", alpha=0.5)
    ax_sc.set_xlabel("original angle [deg]")
    ax_sc.set_ylabel("generated angle [deg]")
    ax_hx.hist(avg_theta, bins=50, range=(70, 180))
    ax_hy.hist(avg_phi, bins=50, range=(70, 180),
               orientation="horizontal")
    ax_sc.set_title(f"Si-exO-Si angle (R^2 = {r2:.4f})")
    logger.log_figure("cn2_angle_scatter", fig)
    plt.close(fig)

    avg_bo, avg_bg = conditional_bond_parity(results, g, geo=geo)
    r2_bond = r2score(avg_bo, avg_bg)
    bonds_orig = np.concatenate([geo["bond1_o"], geo["bond2_o"]])
    bonds_gen = np.concatenate([geo["bond1_g"], geo["bond2_g"]])
    rejected2 = np.concatenate([geo["invalid"], geo["invalid"]])
    fig, ax = plt.subplots(figsize=(7, 7))
    bonds_orig = np.where(rejected2, np.nan, bonds_orig)
    bonds_gen = np.where(rejected2, np.nan, bonds_gen)
    ax.plot(bonds_orig, bonds_gen, "o", alpha=0.4)
    # empty-bond guard: with no valid 2-coordinated samples every bond is
    # NaN and nanmax would emit an All-NaN-axis RuntimeWarning — fall back
    # to a fixed 2 A axis so the (empty) figure still renders cleanly
    finite_bonds = np.concatenate([bonds_orig, bonds_gen])
    finite_bonds = finite_bonds[np.isfinite(finite_bonds)]
    lims = [0, (finite_bonds.max() * 1.1) if finite_bonds.size else 2.0]
    ax.plot(lims, lims, "-", color="red", alpha=0.5)
    ax.set_xlabel("original bond length [A]")
    ax.set_ylabel("generated bond length [A]")
    ax.set_title(f"exO-Si bond length (R^2 = {r2_bond:.4f})")
    logger.log_figure("cn2_bond_scatter", fig)
    plt.close(fig)

    logger.log({"cn2_angle_r2": r2, "cn2_bond_r2": r2_bond})
    print(f"cn2 angle R^2: {r2:.4f}; bond R^2: {r2_bond:.4f} "
          f"over {n} conditions")


if __name__ == "__main__":
    main()
