"""Strided-sampler quality/speed sweep over a trained run.

Loads a trained run directory (from examples/quality_demo.py), generates
with different reverse-step counts (full T vs strided), and reports RDF
parity + wall time per setting — the measurement behind the fast-sampling
mode (SURVEY.md hard-part #3: "possibly fewer-step compat samplers").

  python examples/strided_eval.py --run_dir /tmp/quality_demo2 \
      --steps 1000,250,100,50
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
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--steps", type=str, default="1000,250,100,50")
    p.add_argument("--num", type=int, default=256)
    args = p.parse_args()

    from diffusion_model import api
    from diffusion_model.data.batch import collate
    from diffusion_model.data.split import split_dataset
    from diffusion_model.data.synthetic import synthetic_sio2_dataset
    from diffusion_model.evals import evaluate_rdf_lists
    from diffusion_model.utils.logging import load_run_config

    cfg = load_run_config(args.run_dir)
    graphs = synthetic_sio2_dataset(cfg.seed, args.num, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size)
    graphs = api.prepare_dataset(graphs, cfg)
    _, _, test_set = split_dataset(graphs, cfg.seed)
    example = collate(test_set[:1], cfg.n_max)
    trainer, state = api.load_trained(args.run_dir, cfg, example)

    rows = []
    for steps in [int(s) for s in args.steps.split(",")]:
        cfg_s = cfg.replace(sample_steps=steps)
        t0 = time.time()
        results = api.generate(cfg_s, trainer, state, test_set)
        dt = time.time() - t0
        keep = np.nonzero(results["accepted"])[0]
        rdf_rows = evaluate_rdf_lists(
            results["original_pos"][keep], results["mask"][keep],
            results["generated_pos"][keep], results["mask"][keep],
        )
        cos = np.asarray([r["cos"] for r in rdf_rows])
        row = {
            "steps": steps,
            "seconds": round(dt, 1),
            "finite_fraction": float(results["finite"].mean()),
            "rdf_cos_mean": round(float(cos.mean()), 4),
            "rdf_cos_median": round(float(np.median(cos)), 4),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    out = os.path.join(args.run_dir, "strided_eval.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=2)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
