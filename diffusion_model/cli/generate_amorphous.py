"""Amorphous/unconditional generation driver — equivalent of
ref generate_amorphous.py:25-147, with flags instead of interactive stdin.

Loads a trained run, generates for an arbitrary dataset's conditions, and
logs the O-density accuracy scatter.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from diffusion_model import api
from diffusion_model.data.batch import collate
from diffusion_model.data.io import load_dataset
from diffusion_model.data.synthetic import synthetic_sio2_dataset
from diffusion_model.evals import density_accuracy, o_density
from diffusion_model.utils.logging import RunLogger, load_run_config


def main(argv=None):
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", type=str, required=True,
                   help="trained run directory (checkpoints + config)")
    p.add_argument("--dataset_path", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--amorphous", type=int, default=0,
                   help="generate for N amorphous-cell conditions drawn "
                        "from --generator at --num_atoms atoms each")
    p.add_argument("--num_atoms", type=int, default=None,
                   help="atoms per amorphous condition (default: cfg.n_max)")
    p.add_argument("--generator", type=str, default="packing",
                   choices=("packing", "network"),
                   help="'packing' = hard-sphere amorphous_cell; "
                        "'network' = CRN silica amorphous_network_cell "
                        "(real Si-O chemical order)")
    p.add_argument("--gen_num_per_spectrum", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None,
                   help="conditions per jitted sampling call "
                        "(batch_size * gen_num_per_spectrum concurrent "
                        "chains)")
    p.add_argument("--ring", action="store_true",
                   help="sample through the ppermute ring "
                        "(api.generate_ring): one dense-topology graph "
                        "node-sharded over the device mesh — the route "
                        "for cells whose [N, N] pair grid exceeds one "
                        "chip's HBM (requires neighbor_k == 0; drives "
                        "conditions sequentially at B=1)")
    p.add_argument("--panel", action="store_true",
                   help="emit the structural-quality panel + the "
                        "in-protocol RDF resampling ceiling "
                        "(evals.amorphous) into run_dir/amorphous_panel.json")
    args = p.parse_args(argv)

    cfg = load_run_config(args.run_dir)
    make_cell = None
    if args.amorphous:
        from diffusion_model.data.synthetic import (
            amorphous_cell,
            amorphous_network_cell,
        )

        n_atoms = args.num_atoms or cfg.n_max
        gen_fn = (amorphous_network_cell if args.generator == "network"
                  else amorphous_cell)

        def make_cell(seed):
            return gen_fn(seed=seed, num_atoms=n_atoms,
                          spectrum_size=cfg.spectrum_size)

        graphs = [make_cell(cfg.seed + 10_000 + i)
                  for i in range(args.amorphous)]
        if n_atoms > cfg.n_max:
            cfg = cfg.replace(n_max=n_atoms)
    elif args.synthetic:
        graphs = synthetic_sio2_dataset(cfg.seed + 1, args.synthetic,
                                        cfg.n_max,
                                        spectrum_size=cfg.spectrum_size)
    elif args.dataset_path:
        graphs = load_dataset(args.dataset_path)
    else:
        raise SystemExit(
            "provide --dataset_path, --synthetic N or --amorphous N")
    graphs = api.prepare_dataset(graphs, cfg)

    logger = RunLogger(args.run_dir)
    example = collate(graphs[:1], cfg.n_max)
    trainer, state = api.load_trained(args.run_dir, cfg, example)
    if args.ring:
        results = api.generate_ring(
            cfg, trainer, state, graphs,
            gen_num_per_spectrum=args.gen_num_per_spectrum)
    else:
        gen_kwargs = {}
        if args.batch_size is not None:
            gen_kwargs["batch_size"] = args.batch_size
        results = api.generate(
            cfg, trainer, state, graphs,
            gen_num_per_spectrum=args.gen_num_per_spectrum, **gen_kwargs)

    out = os.path.join(args.run_dir, "generated_amorphous.npz")
    np.savez_compressed(out, **{k: v for k, v in results.items()
                                if k != "ids"},
                        ids=np.asarray(results["ids"]))
    logger.register_artifact("generated_amorphous_save_path", out)

    d_orig = o_density(results["original_species"], results["mask"])
    d_gen = o_density(results["generated_species"], results["mask"])
    acc = density_accuracy(d_orig, d_gen)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.plot([0, 1], [0, 1], linestyle="-", color="red")
    ax.plot(d_orig, d_gen, linestyle="None", marker="o")
    ax.set_xlabel("density of O in original")
    ax.set_ylabel("density of O in generated")
    ax.set_title(f"density of O (accuracy {acc:.5f})")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    logger.log_figure("atom_type_eval_amorphous", fig)
    plt.close(fig)
    summary = (f"generated {len(results['ids'])} structures; "
               f"O-density accuracy {acc:.5f}; saved at {out}")

    if args.panel:
        import json

        from diffusion_model.evals.amorphous import (
            exo_rdf_resampling_ceiling,
            structure_panel,
        )

        keep = np.nonzero(results["accepted"])[0]
        panel = {"accepted": int(len(keep)),
                 "finite_fraction": float(results["finite"].mean())}
        if len(keep):
            panel["panel"] = structure_panel(
                results["original_pos"][keep],
                results["original_species"][keep],
                results["generated_pos"][keep],
                results["generated_species"][keep],
                results["mask"][keep])
            if make_cell is not None:
                # ceiling is only defined against a resampleable source.
                # num_cells = DISTINCT accepted conditions, not samples:
                # each condition repeats gen_num_per_spectrum times in the
                # aggregate, and repeats don't reduce sample noise the way
                # independent cells do — counting samples would inflate
                # the ceiling beyond what any generator can reach.
                ids = results["ids"]
                distinct = len({ids[i] for i in keep})
                panel["rdf_ceiling"] = exo_rdf_resampling_ceiling(
                    lambda s: make_cell(int(s)), num_cells=distinct,
                    pairs=3)
        panel_path = os.path.join(args.run_dir, "amorphous_panel.json")
        with open(panel_path, "w") as f:
            json.dump(panel, f, indent=1)
        logger.register_artifact("amorphous_panel", panel_path)
        summary += f"; panel at {panel_path}"

    print(summary)


if __name__ == "__main__":
    main()
