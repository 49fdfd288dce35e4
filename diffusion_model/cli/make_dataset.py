"""Dataset builder CLI — equivalent of ref make_dataset.py:60-308.

Walks sample directories containing CASTEP ``coreloss.cell`` +
``coreloss_core_edge.dat``, extracts the requested NN shell around the
excited oxygen, and writes one .npz dataset.
"""

from __future__ import annotations

import argparse
import os

from diffusion_model.data.io import save_dataset
from diffusion_model.data.shells import RANGE_TO_SHELLS, build_dataset


def main(argv=None):
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--range", type=str, default="2NN",
                   choices=sorted(RANGE_TO_SHELLS))
    p.add_argument("--cell_dir_path", type=str, required=True)
    p.add_argument("--save_dir_path", type=str, required=True)
    args = p.parse_args(argv)

    dataset = build_dataset(args.cell_dir_path, nn_range=args.range)
    os.makedirs(args.save_dir_path, exist_ok=True)
    out = os.path.join(args.save_dir_path, "dataset.npz")
    save_dataset(dataset, out)
    print(f"saved {len(dataset)} graphs to {out}")


if __name__ == "__main__":
    main()
