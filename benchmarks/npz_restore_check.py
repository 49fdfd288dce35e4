"""Prove a committed .npz snapshot restores to a working quality model.

The npz artifacts (artifacts/*.npz) are the durable half of the quality
claims; this closes the loop by driving the FULL api.generate + eval
path from one — rebuild the dataset/split from the embedded config,
sample every test condition, and score rdf_cos + conditional CN2 angle
R² the same way examples/quality_demo.py does (ref parts/
train_per_iretation.py:264-444, CN2_evaluate.py:176-286). Writes a
small JSON next to the other quality artifacts.

Runs anywhere: JAX_PLATFORMS=cpu for a chip-free check (flagship-size
n_max=16 is cheap on host), or on the GPU.

    JAX_PLATFORMS=cpu python benchmarks/npz_restore_check.py \
        artifacts/q_learned_r5_s2025.npz --shells 2 \
        --out docs/quality/learned_npz_restore_check.json
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class _SnapshotState:
    """Duck-types the one Trainer-state method api.generate uses."""

    def __init__(self, params):
        self._params = params

    def eval_params(self, cfg):
        return self._params


def main(argv=None):
    from diffusion_model.utils import setup_compile_cache

    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("npz")
    p.add_argument("--num", type=int, default=256,
                   help="dataset size the run trained on (not in config)")
    p.add_argument("--shells", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import jax
    import numpy as np

    from diffusion_model import api
    from diffusion_model.data.split import split_dataset
    from diffusion_model.data.synthetic import synthetic_sio2_dataset
    from diffusion_model.evals import (
        conditional_angle_parity,
        evaluate_rdf_lists,
        r2score,
    )
    from diffusion_model.train import Trainer
    from diffusion_model.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )

    cfg = load_config_npz(args.npz)
    params = load_params_npz(args.npz)
    trainer = Trainer(cfg)
    graphs = synthetic_sio2_dataset(cfg.seed, args.num, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=args.shells)
    _, _, test_set = split_dataset(graphs, cfg.seed)

    t0 = time.time()
    results = api.generate(cfg, trainer, _SnapshotState(params), test_set)
    gen_s = time.time() - t0

    keep = np.nonzero(results["accepted"])[0]
    rdf_rows = evaluate_rdf_lists(
        results["original_pos"][keep], results["mask"][keep],
        results["generated_pos"][keep], results["mask"][keep],
    )
    rdf_cos = np.asarray([r["cos"] for r in rdf_rows])
    avg_o, avg_g = conditional_angle_parity(
        results, cfg.gen_num_per_spectrum)
    angle_r2 = r2score(avg_o, avg_g) if len(avg_o) >= 3 else None

    summary = {
        "npz": args.npz,
        "platform": jax.devices()[0].platform,
        "n_test_conditions": len(test_set),
        "finite_fraction": float(results["finite"].mean()),
        "accepted_fraction": float(results["accepted"].mean()),
        "rdf_cos_mean": float(rdf_cos.mean()),
        "rdf_cos_median": float(np.median(rdf_cos)),
        "cn2_angle_r2": None if angle_r2 is None else float(angle_r2),
        "gen_seconds": round(gen_s, 1),
        "note": "full api.generate + eval driven from the committed "
                "npz snapshot alone (no run dir) — the durable-artifact "
                "restore path, end to end",
    }
    print(json.dumps(summary))
    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
