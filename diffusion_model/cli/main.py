"""Main orchestrator CLI — the equivalent of the reference's ``main.py``.

Modes (ref main.py:39,55): train_and_generate | train_only | generate_only |
evaluate_only. Config comes from a reference-style parameters.yaml; run
state (config, metrics, figures, artifacts, checkpoints) lives in
``--run_dir`` instead of wandb.

Data: ``--dataset`` takes the framework's .npz dataset (see
cli/make_dataset.py); ``--synthetic N`` generates N schema-identical
synthetic SiO2 environments (the reference's raw data is private); and
``--test_by_provided_data QM9`` loads raw GDB-9 .xyz files from
``--dataset_path`` (ref main.py:43,90-95,145-152: atom_type_size widens
to 5 and a seeded 10k subset is drawn; parsed natively by data/qm9.py —
torch_geometric is absent in this stack).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from diffusion_model import api
from diffusion_model.config import Config, load_config
from diffusion_model.data.batch import collate
from diffusion_model.data.io import load_dataset
from diffusion_model.data.split import split_dataset
from diffusion_model.data.synthetic import synthetic_sio2_dataset
from diffusion_model.utils.logging import RunLogger, load_run_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--project_name", type=str,
                   default="diffusion_first_nearest_loss_per_atom")
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--run_dir", type=str, default="runs/latest")
    p.add_argument("--config", type=str, default=None,
                   help="parameters.yaml (reference-compatible)")
    p.add_argument("--dataset_path", type=str, default=None,
                   help=".npz dataset from cli/make_dataset.py")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic SiO2 environments instead")
    p.add_argument("--mode", type=str, default="train_and_generate",
                   choices=["train_and_generate", "train_only",
                            "generate_only", "evaluate_only"])
    p.add_argument("--num_epochs", type=int, default=None,
                   help="override config num_epochs")
    p.add_argument("--resume", action="store_true",
                   help="continue training from the latest checkpoint")
    p.add_argument("--record_schedule", action="store_true")
    p.add_argument("--create_xyz_file", action="store_true")
    p.add_argument("--note", type=str, default=None)
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--test_by_provided_data", type=str, default=None)
    return p


def load_graphs(args, cfg: Config) -> list:
    if args.test_by_provided_data:
        if args.test_by_provided_data != "QM9":
            raise SystemExit(
                f"unknown provided dataset {args.test_by_provided_data!r}; "
                "only QM9 is supported (ref main.py:43)"
            )
        if not args.dataset_path:
            raise SystemExit(
                "--test_by_provided_data QM9 needs --dataset_path pointing "
                "at a directory of raw GDB-9 .xyz files"
            )
        from diffusion_model.data.qm9 import load_qm9_dataset

        # ref main.py:146-148: seeded 10k random subset
        return load_qm9_dataset(args.dataset_path,
                                spectrum_size=cfg.spectrum_size,
                                limit=10_000, seed=cfg.seed)
    if args.synthetic:
        return synthetic_sio2_dataset(
            cfg.seed, args.synthetic, cfg.n_max,
            spectrum_size=cfg.spectrum_size, shells=2,
        )
    if args.dataset_path:
        return load_dataset(args.dataset_path)
    raise SystemExit("provide --dataset_path or --synthetic N")


def main(argv=None):
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    args = build_parser().parse_args(argv)

    if args.mode in ("generate_only", "evaluate_only"):
        # resume from the run directory's persisted config (the reference
        # recovers it from wandb, ref main.py:58-61)
        cfg = load_run_config(args.run_dir)
    else:
        cfg = load_config(args.config) if args.config else Config()

    if args.test_by_provided_data == "QM9":
        # ref main.py:92-95 widens atom_type_size to 5; QM9 Data objects
        # carry no spectrum/exO for the conditioning code to read, so the
        # QM9 smoke run is unconditional (see data/qm9.py docstring).
        cfg = cfg.replace(atom_type_size=5, conditional=False,
                          give_exO=False)

    graphs = load_graphs(args, cfg)
    graphs = api.prepare_dataset(graphs, cfg)
    n_max = api.fit_n_max(graphs)
    if n_max != cfg.n_max:
        cfg = cfg.replace(n_max=n_max)

    logger = RunLogger(args.run_dir, cfg, project=args.project_name,
                       run_name=args.run_name, use_wandb=args.use_wandb,
                       notes=args.note)

    results = None
    if "train" in args.mode:
        trainer, state, (train_set, val_set, test_set) = api.train(
            cfg, graphs, args.run_dir, logger, num_epochs=args.num_epochs,
            resume=args.resume,
        )
        print(f"model checkpoints saved under {args.run_dir}/checkpoints")
    else:
        _, _, test_set = split_dataset(graphs, cfg.seed)
        example = collate(test_set[:1], cfg.n_max)
        trainer, state = api.load_trained(args.run_dir, cfg, example)

    if "generate" in args.mode:
        results = api.generate(cfg, trainer, state, test_set)
        out = os.path.join(args.run_dir, "generated.npz")
        np.savez_compressed(out, **{
            k: v for k, v in results.items() if k != "ids"
        }, ids=np.asarray(results["ids"]))
        logger.register_artifact("generated_graph_save_path", out)
        print(f"generated structures saved at {out}")

    if args.mode == "evaluate_only":
        from diffusion_model.cli.common import load_results

        # accepted_only=False: api.evaluate applies its own accept filter
        results = load_results(args.run_dir, accepted_only=False)

    if results is not None and cfg.conditional:
        summary = api.evaluate(results, args.run_dir, logger,
                               create_xyz=args.create_xyz_file)
        print(f"atom_type_accuracy: {summary['atom_type_accuracy']:.5f}")

    if args.record_schedule:
        api.record_schedule(cfg, trainer, state, args.run_dir, logger)
        print("noise_schedule saved")

    logger.finish()


if __name__ == "__main__":
    main()
