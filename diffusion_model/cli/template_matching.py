"""Template matching CLI — equivalent of ref template_matching.py.

Best-3 spectrum-MSE neighbours of each target graph in a reference dataset,
scored by local-descriptor cosine similarity, saved as JSON.
"""

from __future__ import annotations

import argparse
import json
import os

from diffusion_model import api
from diffusion_model.config import Config
from diffusion_model.data.io import load_dataset
from diffusion_model.evals import template_match


def main(argv=None):
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reference_dataset_path", type=str, required=True)
    p.add_argument("--target_dataset_path", type=str, required=True)
    p.add_argument("--save_dir", type=str, required=True)
    args = p.parse_args(argv)

    cfg = Config()
    reference = api.prepare_dataset(
        load_dataset(args.reference_dataset_path), cfg
    )
    target = api.prepare_dataset(load_dataset(args.target_dataset_path), cfg)
    result = template_match(target, reference)
    os.makedirs(args.save_dir, exist_ok=True)
    out = os.path.join(args.save_dir, "template_matching_result.json")
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    print(f"saved best-3 matches for {len(result)} targets to {out}")


if __name__ == "__main__":
    main()
