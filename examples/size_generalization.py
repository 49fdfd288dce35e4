"""Size generalization: train on 48-72-atom amorphous cells, sample bigger.

The reference only ever samples at the condition's own size (ref
parts/train_per_iretation.py:291-292). Because the EGNN is size-agnostic
(shared per-node/per-edge parameters) and the kNN path bounds each node's
neighborhood, a model trained on small amorphous cells can be ASKED for
larger ones — this driver quantifies how far that extrapolation holds:
train at 48-72 atoms, generate at 72/96/144/192, and score each size with
distribution-level metrics (aggregate RDF cosine vs same-size originals,
nearest-neighbour distance median, O-site density MAE).
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
    """Nearest-neighbour distance per real atom of one structure."""
    n = int(mask.sum())
    p = pos[:n]
    d = np.linalg.norm(p[:, None] - p[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    return d.min(1)


def main():
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out_dir", type=str, default="runs/size_gen")
    p.add_argument("--epochs", type=int, default=800)
    p.add_argument("--train_cells", type=int, default=96)
    p.add_argument("--train_min", type=int, default=48,
                   help="smallest training-cell atom count")
    p.add_argument("--train_max", type=int, default=72,
                   help="largest training-cell atom count (inclusive)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--neighbor_k", type=int, default=16)
    p.add_argument("--timesteps", type=int, default=1000)
    p.add_argument("--L", type=int, default=5,
                   help="EGCL stack depth (5 = reference). Shrinking L "
                        "with small neighbor_k makes receptive-field "
                        "locality binding at CPU-ablation scales")
    p.add_argument("--hidden", type=int, default=1024,
                   help="MLP hidden width for m/h/x (1024 = reference)")
    p.add_argument("--m_size", type=int, default=256,
                   help="message width (256 = reference)")
    p.add_argument("--sizes", type=str, default="72,96,144,192")
    p.add_argument("--gen_cells", type=int, default=8,
                   help="conditions per evaluation size")
    p.add_argument("--chunk", type=int, default=4,
                   help="conditions per jitted sampling call — keep "
                        "512-atom programs small")
    p.add_argument("--sample_steps", type=int, default=0,
                   help="strided sampling step count (0 = full chain)")
    p.add_argument("--virtual_node", action="store_true",
                   help="per-layer global-context channel "
                        "(config.virtual_node) — O(1)-hop global "
                        "communication for kNN topologies; zero-init, "
                        "exact no-op at initialisation")
    p.add_argument("--global_radius", action="store_true",
                   help="append the |x - CoM| global-envelope feature "
                        "(config.global_radius_feature) — the mid-range-"
                        "order fix for kNN topologies")
    p.add_argument("--h_init_scale", type=float, default=1.0,
                   help="variance multiplier for the EGCL node-MLP output "
                        "init (config.h_init_scale); ~1/K^2 tames the "
                        "non-residual h-update blowup at large cells")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in out_dir "
                        "(api.train resume) — a relaunched run keeps "
                        "its trained epochs")
    p.add_argument("--h_residual", action="store_true",
                   help="residual node update h + mlp_h(...) "
                        "(config.h_residual) — the conditioning fix for "
                        "the non-residual blowup at large cells")
    p.add_argument("--remat", action="store_true",
                   help="rematerialise each EGCL layer in the train step "
                        "(config.remat_egcl) — required at 512-atom "
                        "kNN-32 batch-32, whose un-remat'ed backward "
                        "holds many GiB (per-layer edge-MLP "
                        "activations are ~1 GiB each)")
    p.add_argument("--edge_rbf", type=int, default=0,
                   help="Gaussian radial-basis features of the edge "
                        "distance injected into both edge MLPs "
                        "(config.edge_rbf; zero-init = exact no-op at "
                        "init) — targets the measured bond-peak blur / "
                        "CN deficit on network data")
    p.add_argument("--t_bias_frac", type=float, default=0.0,
                   help="fraction of per-graph timesteps drawn from the "
                        "mid-noise band (config.t_bias_frac) — targets "
                        "the structure-formation underfit, docs/quality/"
                        "size512net_per_t_profile.json")
    p.add_argument("--t_loss_weight", type=float, default=1.0,
                   help="per-graph LOSS multiplier for t in the "
                        "[t_bias_lo, t_bias_hi] band, analytically "
                        "normalised (config.t_loss_weight) — the "
                        "gradient-emphasis variant of t_bias_frac that "
                        "keeps uniform t coverage (VERDICT-r4 candidate "
                        "for the 512-atom structure-formation underfit)")
    p.add_argument("--x_parameterization", type=str, default="eps",
                   choices=("eps", "x0", "v"),
                   help="coordinate-head meaning (config.py): 'x0' makes "
                        "the network predict a displacement toward the "
                        "clean structure (converted to eps at every "
                        "consumer) — the round-5 candidate for the "
                        "large-cell mid-t structure-formation deficit")
    p.add_argument("--init_from", type=str, default="",
                   help="curriculum initialisation: run dir whose latest "
                        "checkpoint's eval params seed this run (fresh "
                        "optimizer, epoch 0). The EGNN is size-agnostic, "
                        "so a 192-atom checkpoint initialises a 512-atom "
                        "run; architecture flags must match. A checkpoint "
                        "in --out_dir + --resume wins over this (watchdog "
                        "relaunch semantics).")
    p.add_argument("--optimizer", type=str, default="RAdamScheduleFree",
                   choices=("RAdamScheduleFree", "Adam", "AdamW"),
                   help="RAdamScheduleFree is the reference default; EMA "
                        "requires Adam/AdamW (schedule-free's own "
                        "averaging would shadow it, train/trainer.py)")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="parameter EMA decay (config.ema_decay, e.g. "
                        "0.999); evaluation/sampling uses the average — "
                        "the still-unmeasured candidate lever for the "
                        "bond-peak blur (docs/ROADMAP.md round-4 list)")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--max_grad_norm", type=float, default=1.0,
                   help="global-norm gradient clip. Network-data runs at "
                        "192+/kNN-32 sit in the always-clipping regime "
                        "(grad norms 1e4-1e5), so the effective step size "
                        "is lr*clip: 2e-4*100=0.02 reignites the non-"
                        "residual h-update blowup after ONE optimizer "
                        "step (f32 too — not a bf16 numerics issue); "
                        "lr*clip<=2e-3 is stable "
                        "(benchmarks/probe_network_nan.py)")
    p.add_argument("--checkpoint_every", type=int, default=500,
                   help="checkpoint cadence in epochs (a killed run "
                        "loses the epochs since the last checkpoint)")
    p.add_argument("--cell_cache", type=str, default="runs/cell_cache",
                   help="disk-memoise generated cells here (atomic npz "
                        "per cell) so --resume relaunches skip the ~6 min "
                        "host-side regeneration; '' disables")
    p.add_argument("--generator", type=str, default="packing",
                   choices=("packing", "network"),
                   help="'packing' = hard-sphere amorphous_cell (no "
                        "chemical order, exO-RDF ceiling ~0.76 at 8x512 "
                        "cells); 'network' = amorphous_network_cell CRN "
                        "silica (real Si-O bonds/angles, ceiling ~0.92+; "
                        "see docs/quality/rdf_resampling_ceilings.json)")
    args = p.parse_args()
    # queued-run escape hatch: a pre-launched chained job can have its
    # epoch budget trimmed without editing its frozen command line
    override = "/tmp/size_gen_epochs_override"
    if os.path.exists(override):
        with open(override) as f:
            args.epochs = int(f.read().strip())
        os.unlink(override)  # one-shot: a stale file must not silently
        # trim every future run's budget
        print(f"epochs overridden to {args.epochs} via {override} "
              f"(consumed)", flush=True)

    from diffusion_model import api
    from diffusion_model.config import Config
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
    from diffusion_model.utils.logging import RunLogger

    def make_cell(seed, num_atoms):
        maker = (amorphous_network_cell if args.generator == "network"
                 else amorphous_cell)
        kw = dict(seed=seed, num_atoms=num_atoms,
                  spectrum_size=cfg.spectrum_size)
        if args.cell_cache:
            from diffusion_model.data.synthetic import cached_cell
            return cached_cell(maker, args.cell_cache, **kw)
        return maker(**kw)

    cfg = Config(
        n_max=args.train_max, neighbor_k=args.neighbor_k,
        L=args.L, m_hidden_size=args.hidden, h_hidden_size=args.hidden,
        x_hidden_size=args.hidden, m_size=args.m_size,
        batch_size=args.batch_size,
        num_diffusion_timestep=args.timesteps, num_epochs=args.epochs,
        lr=args.lr, max_grad_norm=args.max_grad_norm,
        optimizer=args.optimizer, ema_decay=args.ema_decay,
        compute_dtype="bfloat16",
        gen_num_per_spectrum=2,
        global_radius_feature=args.global_radius,
        virtual_node=args.virtual_node,
        h_init_scale=args.h_init_scale,
        h_residual=args.h_residual,
        remat_egcl=args.remat,
        edge_rbf=args.edge_rbf,
        t_bias_frac=args.t_bias_frac,
        t_loss_weight=args.t_loss_weight,
        x_parameterization=args.x_parameterization,
        checkpoint_every=args.checkpoint_every,  # long runs survive kills
    )
    print(f"devices: {jax.devices()}", flush=True)
    rng = np.random.default_rng(cfg.seed)
    train_graphs = [
        make_cell(
            int(s),
            int(rng.integers(args.train_min, args.train_max + 1)))
        for s in rng.integers(0, 2**31, args.train_cells)
    ]
    logger = RunLogger(args.out_dir, cfg)
    t0 = time.time()
    trainer, state, _ = api.train(cfg, train_graphs, args.out_dir, logger,
                                  resume=args.resume,
                                  init_params_from=args.init_from or None)
    print(f"trained {args.epochs} epochs in {time.time()-t0:.0f}s",
          flush=True)

    results = {}
    for size in [int(s) for s in args.sizes.split(",")]:
        cfg_s = cfg.replace(n_max=size, sample_steps=args.sample_steps)
        cells = [
            make_cell(10_000 + size + i, size)
            for i in range(args.gen_cells)
        ]
        t0 = time.time()
        res = api.generate(cfg_s, trainer, state, cells,
                           batch_size=args.chunk)
        gen_s = time.time() - t0
        keep = np.nonzero(res["accepted"])[0]
        finite = float(res["finite"].mean())
        row = {"finite_fraction": finite, "accepted": int(len(keep)),
               "generate_seconds": round(gen_s, 1)}
        if len(keep):
            gp = res["generated_pos"][keep]
            op = res["original_pos"][keep]
            m = res["mask"][keep]
            # aggregate RDF over all accepted structures of this size
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
            # full structural panel (all-pairs W1, CN, angles, envelope)
            row["panel"] = structure_panel(
                op, res["original_species"][keep], gp,
                res["generated_species"][keep], m)
            # ground-truth resampling ceiling of the aggregate-RDF metric
            # at THIS protocol size — compare aggregate_rdf_cos to this,
            # not to 1.0 (single-site RDF aggregates are sample-noise
            # limited; docs/quality/rdf_resampling_ceilings.json).
            # num_cells = DISTINCT accepted conditions (each repeats
            # gen_num_per_spectrum times in the aggregate; repeats don't
            # reduce sample noise like independent cells would)
            ids = res["ids"]
            distinct = len({ids[i] for i in keep})
            row["rdf_ceiling"] = exo_rdf_resampling_ceiling(
                lambda s: make_cell(s, size), num_cells=distinct,
                pairs=3)
            np.savez_compressed(
                os.path.join(args.out_dir, f"positions_n{size}.npz"),
                generated_pos=res["generated_pos"],
                original_pos=res["original_pos"],
                generated_species=res["generated_species"],
                original_species=res["original_species"],
                mask=res["mask"], accepted=res["accepted"])
        results[f"n{size}"] = row
        print(f"size {size}: {row}", flush=True)

    out = {"config": f"size_gen_knn{args.neighbor_k}_train"
                     f"{args.train_min}-{args.train_max}_{args.epochs}ep"
                     f"_{args.generator}"
                     f"_lr{args.lr:g}_clip{args.max_grad_norm:g}"
                     + ("_hres" if args.h_residual else "")
                     + (f"_{args.optimizer}" if args.optimizer
                        != "RAdamScheduleFree" else "")
                     + (f"_ema{args.ema_decay:g}" if args.ema_decay else "")
                     + (f"_rbf{args.edge_rbf}" if args.edge_rbf else "")
                     + (f"_tb{args.t_bias_frac:g}" if args.t_bias_frac else "")
                     + (f"_tw{args.t_loss_weight:g}"
                        if args.t_loss_weight != 1.0 else "")
                     + (f"_L{args.L}" if args.L != 5 else "")
                     + (f"_{args.x_parameterization}"
                        if args.x_parameterization != "eps" else "")
                     + (f"_curr" if args.init_from else "")
                     + ("_gr" if args.global_radius else "")
                     + ("_vn" if args.virtual_node else ""),
           "sizes": results}
    with open(os.path.join(args.out_dir, "size_gen_summary.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1), flush=True)


if __name__ == "__main__":
    main()
