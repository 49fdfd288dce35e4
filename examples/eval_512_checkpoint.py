"""Evaluate a trained 512-atom checkpoint with a small compiled program.

Round-2 left ``runs/size_gen_512k32`` trained (2000 epochs, kNN-32) but
unevaluated: its 512-atom/1000-step/16-sample sampling program reproducibly
crashed the accelerator worker it first ran on. This driver shrinks the
compiled program until it survives — strided sampling (``--sample_steps``, default 250,
RDF-parity-validated in docs/quality/strided_eval.json) and a small
per-call condition batch (``--chunk``, default 2 conditions x
gen_num_per_spectrum samples per jitted call) — then scores the checkpoint
with the same distribution-level metrics as examples/size_generalization.py
(aggregate RDF cosine, NN-distance medians, O-density MAE).

Reference capability being matched: amorphous generation at large cell
sizes (ref generate_amorphous.py:25-147).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np


def nn_distances(pos, mask):
    n = int(mask.sum())
    p = pos[:n]
    d = np.linalg.norm(p[:, None] - p[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    return d.min(1)


def main():
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", type=str, default="runs/size_gen_512k32")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--gen_cells", type=int, default=8)
    p.add_argument("--chunk", type=int, default=2,
                   help="conditions per jitted sampling call")
    p.add_argument("--sample_steps", type=int, default=250)
    p.add_argument("--sample_grid", type=str, default="uniform")
    p.add_argument("--sample_noise_scale", type=float, default=1.0,
                   help="sampling temperature (config.sample_noise_scale): "
                        "< 1 sharpens distributions at zero training cost "
                        "— probes how much of a large-cell RDF deficit is "
                        "ancestral sampling jitter vs model error")
    p.add_argument("--generator", type=str, default="packing",
                   choices=("packing", "network"))
    p.add_argument("--out", type=str, default="")
    args = p.parse_args()

    from diffusion_model import api
    from diffusion_model.config import from_dict
    from diffusion_model.data.batch import collate
    from diffusion_model.data.synthetic import (
        amorphous_cell,
        amorphous_network_cell,
    )
    from diffusion_model.evals import rdf_metrics
    from diffusion_model.evals.amorphous import (
        exo_rdf_resampling_ceiling,
        structure_panel,
    )
    from diffusion_model.evals.density import o_density
    from diffusion_model.ops.rdf import rdf_from_exo

    with open(os.path.join(args.run_dir, "config.json")) as f:
        cfg = from_dict(json.load(f))
    print(f"devices: {jax.devices()}", flush=True)
    print(f"loaded cfg: n_max={cfg.n_max} k={cfg.neighbor_k}", flush=True)

    # template batch only shapes the parameter tree; content is irrelevant
    example_cells = [
        amorphous_cell(seed=1, num_atoms=cfg.n_max,
                       spectrum_size=cfg.spectrum_size)
    ]
    example = collate(example_cells, cfg.n_max)
    trainer, state = api.load_trained(args.run_dir, cfg, example)
    print("checkpoint restored", flush=True)

    cfg_s = cfg.replace(
        n_max=args.size,
        sample_steps=args.sample_steps,
        sample_grid=args.sample_grid,
        sample_noise_scale=args.sample_noise_scale,
    )
    def make_cell(seed, num_atoms):
        if args.generator == "network":
            return amorphous_network_cell(
                seed=seed, num_atoms=num_atoms,
                spectrum_size=cfg.spectrum_size)
        return amorphous_cell(seed=seed, num_atoms=num_atoms,
                              spectrum_size=cfg.spectrum_size)

    cells = [
        make_cell(10_000 + args.size + i, args.size)
        for i in range(args.gen_cells)
    ]
    t0 = time.time()
    res = api.generate(cfg_s, trainer, state, cells,
                       batch_size=args.chunk)
    gen_s = time.time() - t0
    keep = np.nonzero(res["accepted"])[0]
    finite = float(res["finite"].mean())
    row = {"finite_fraction": finite, "accepted": int(len(keep)),
           "generate_seconds": round(gen_s, 1),
           "sample_steps": args.sample_steps,
           "sample_grid": args.sample_grid,
           "sample_noise_scale": args.sample_noise_scale,
           "chunk": args.chunk}
    if len(keep):
        gp = res["generated_pos"][keep]
        op = res["original_pos"][keep]
        m = res["mask"][keep]
        rdf_g = np.mean([np.asarray(rdf_from_exo(p_, m_))
                         for p_, m_ in zip(gp, m)], axis=0)
        rdf_o = np.mean([np.asarray(rdf_from_exo(p_, m_))
                         for p_, m_ in zip(op, m)], axis=0)
        row["aggregate_rdf_cos"] = round(
            float(rdf_metrics(rdf_o, rdf_g)["cos"]), 4)
        row["nn_dist_median_generated"] = round(float(np.median(
            np.concatenate([nn_distances(p_, m_)
                            for p_, m_ in zip(gp, m)]))), 3)
        row["nn_dist_median_original"] = round(float(np.median(
            np.concatenate([nn_distances(p_, m_)
                            for p_, m_ in zip(op, m)]))), 3)
        dens_g = o_density(res["generated_species"][keep], m)
        dens_o = o_density(res["original_species"][keep], m)
        row["o_density_mae"] = round(
            float(np.mean(np.abs(dens_o - dens_g))), 4)
    # radial density envelope around the cell CoM: distinguishes "locally
    # right but globally blobby" failures (a local kNN score cannot shape
    # the global box envelope) from genuinely matched mid-range order
    if len(keep):
        def radial_profile(pos, mask):
            rows = []
            for p_, m_ in zip(pos, mask):
                n = int(m_.sum())
                p = p_[:n]
                c = p.mean(0)
                rows.append(np.linalg.norm(p - c, axis=-1))
            r = np.concatenate(rows)
            qs = [5, 25, 50, 75, 95]
            return {f"p{q}": round(float(np.percentile(r, q)), 2)
                    for q in qs}

        row["radius_profile_generated"] = radial_profile(gp, m)
        row["radius_profile_original"] = radial_profile(op, m)
        row["panel"] = structure_panel(
            op, res["original_species"][keep], gp,
            res["generated_species"][keep], m)
        # num_cells = distinct accepted conditions (samples repeat each
        # condition gen_num_per_spectrum times — counting them would
        # inflate the ceiling past any reachable score)
        ids = res["ids"]
        distinct = len({ids[i] for i in keep})
        row["rdf_ceiling"] = exo_rdf_resampling_ceiling(
            lambda s: make_cell(s, args.size), num_cells=distinct,
            pairs=3)

    out = {"config": f"{os.path.basename(args.run_dir)}_eval_n{args.size}",
           "result": row}
    ns_tag = (f"_ns{args.sample_noise_scale:g}"
              if args.sample_noise_scale != 1.0 else "")
    out_path = args.out or os.path.join(
        args.run_dir, f"eval_n{args.size}_s{args.sample_steps}{ns_tag}.json")
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    np.savez_compressed(
        out_path.replace(".json", "") + "_positions.npz",
        generated_pos=res["generated_pos"], original_pos=res["original_pos"],
        mask=res["mask"], accepted=res["accepted"],
        generated_species=res["generated_species"],
        original_species=res["original_species"],
    )
    print(json.dumps(out, indent=1), flush=True)


if __name__ == "__main__":
    main()
