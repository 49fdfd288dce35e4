"""Render the large-cell structure panel as one figure.

Consumes the positions ``.npz`` written by ``examples/size_generalization.py``
(``positions_n<size>.npz``) or ``examples/eval_512_checkpoint.py``
(``eval_*_positions.npz``) and draws the four distribution overlays behind
the headline numbers in ``evals.amorphous.structure_panel``:

  (a) aggregate exO-RDF (the reference readout, ref evaluate_RDF.py:48-60),
  (b) its envelope-subtracted excess — the discriminative score at dense
      cells (docs/quality/size512net_eval.json),
  (c) the Si-O bond-peak zoom of the all-pairs distance density (the
      round-3d blur readout, docs/quality/size512net_bond_peak.json),
  (d) O-Si-O / Si-O-Si bond-angle densities.

Ground truth draws in neutral ink, generated in blue; angle families are
separated by linestyle so identity is never color-alone.

Usage:
    python benchmarks/plot_structure_panel.py runs/size_gen_512r3e/positions_n512.npz \
        --out docs/quality/size512r3e_panel.png --title "512-atom CRN silica"
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

INK = "#52514e"      # ground truth / original
BLUE = "#2a78d6"     # generated (categorical slot 1)


def _accepted(data):
    keep = np.nonzero(data["accepted"])[0]
    return {
        "op": data["original_pos"][keep], "gp": data["generated_pos"][keep],
        "os": data["original_species"][keep],
        "gs": data["generated_species"][keep],
        "m": data["mask"][keep],
    }


def main():
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("npz", type=str)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--title", type=str, default="")
    p.add_argument("--bond_zoom", type=str, default="1.2,2.2",
                   help="r-window of the bond-peak panel, Angstrom")
    args = p.parse_args()

    from diffusion_model.evals.amorphous import (
        _highpass,
        aggregate_exo_rdf,
        bond_angle_samples,
        pair_distances,
    )

    d = _accepted(np.load(args.npz))
    if not len(d["m"]):
        raise SystemExit("no accepted structures in " + args.npz)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dr = 0.01
    rdf_o = aggregate_exo_rdf(d["op"], d["m"])
    rdf_g = aggregate_exo_rdf(d["gp"], d["m"])
    r = np.arange(len(rdf_o)) * dr
    sb = 0.5 / dr  # the excess readout's envelope sigma (excess_rdf_cos)
    ex_o = _highpass(rdf_o, sb)
    ex_g = _highpass(rdf_g, sb)

    lo, hi = (float(x) for x in args.bond_zoom.split(","))
    bins = np.linspace(lo, hi, 81)
    pd_o = np.concatenate([pair_distances(p_, m_, r_max=hi + 0.5)
                           for p_, m_ in zip(d["op"], d["m"])])
    pd_g = np.concatenate([pair_distances(p_, m_, r_max=hi + 0.5)
                           for p_, m_ in zip(d["gp"], d["m"])])

    def pooled_angles(pos, species, mask):
        osio, siosi = [], []
        for p_, s_, m_ in zip(pos, species, mask):
            a, b = bond_angle_samples(p_, s_, m_)
            osio.append(a)
            siosi.append(b)
        return np.concatenate(osio), np.concatenate(siosi)

    ang_o = pooled_angles(d["op"], d["os"], d["m"])
    ang_g = pooled_angles(d["gp"], d["gs"], d["m"])

    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    (ax_rdf, ax_ex), (ax_bond, ax_ang) = axes

    ax_rdf.plot(r, rdf_o, color=INK, lw=2, label="ground truth")
    ax_rdf.plot(r, rdf_g, color=BLUE, lw=2, label="generated")
    ax_rdf.set_xlabel("r from exO [$\\mathrm{\\AA}$]")
    ax_rdf.set_ylabel("aggregate exO-RDF")
    ax_rdf.set_title("(a) exO-RDF (reference readout)", fontsize=10)
    ax_rdf.legend(frameon=False)

    ax_ex.plot(r, ex_o, color=INK, lw=2, label="ground truth")
    ax_ex.plot(r, ex_g, color=BLUE, lw=2, label="generated")
    ax_ex.axhline(0.0, color="#c8c7c2", lw=1)
    ax_ex.set_xlabel("r from exO [$\\mathrm{\\AA}$]")
    ax_ex.set_ylabel("excess (envelope-subtracted) RDF")
    ax_ex.set_title("(b) excess RDF — the discriminative score",
                    fontsize=10)
    ax_ex.legend(frameon=False)

    ax_bond.hist(pd_o[(pd_o >= lo) & (pd_o <= hi)], bins=bins,
                 density=True, histtype="step", color=INK, lw=2,
                 label="ground truth")
    ax_bond.hist(pd_g[(pd_g >= lo) & (pd_g <= hi)], bins=bins,
                 density=True, histtype="step", color=BLUE, lw=2,
                 label="generated")
    ax_bond.set_xlabel("pair distance [$\\mathrm{\\AA}$]")
    ax_bond.set_ylabel("density")
    ax_bond.set_title("(c) Si-O bond-peak zoom", fontsize=10)
    ax_bond.legend(frameon=False)

    abins = np.linspace(60, 180, 61)
    for (osio, siosi), color, who in ((ang_o, INK, "ground truth"),
                                      (ang_g, BLUE, "generated")):
        if len(osio):
            ax_ang.hist(osio, bins=abins, density=True, histtype="step",
                        color=color, lw=2, linestyle="-",
                        label=f"O-Si-O {who}")
        if len(siosi):
            ax_ang.hist(siosi, bins=abins, density=True, histtype="step",
                        color=color, lw=2, linestyle="--",
                        label=f"Si-O-Si {who}")
    ax_ang.set_xlabel("bond angle [deg]")
    ax_ang.set_ylabel("density")
    ax_ang.set_title("(d) bond angles (solid O-Si-O, dashed Si-O-Si)",
                     fontsize=10)
    ax_ang.legend(frameon=False, fontsize=8)

    n_struct = len(d["m"])
    n_atoms = int(d["m"][0].sum())
    fig.suptitle(args.title or
                 f"{os.path.basename(args.npz)} — {n_struct} structures, "
                 f"~{n_atoms} atoms", fontsize=12)
    fig.tight_layout()
    out = args.out or args.npz.replace(".npz", "_panel.png")
    fig.savefig(out, dpi=130)
    print(f"wrote {out} ({n_struct} accepted structures)")


if __name__ == "__main__":
    main()
