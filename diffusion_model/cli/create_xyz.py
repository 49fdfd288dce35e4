"""Aligned xyz-pair export CLI — equivalent of ref create_xyz.py.

Small graphs (<6 atoms): exhaustive permutation alignment; larger graphs:
Kabsch on the 5 nearest-to-exO atoms then Hungarian global matching
(ref create_xyz.py:82-196). Writes original/generated xyz pairs per sample.
"""

from __future__ import annotations

import argparse
import os

from diffusion_model.cli.common import load_results, trim
from diffusion_model.data.xyz import write_xyz
from diffusion_model.evals import hungarian_align, permutation_min_rmsd


def main(argv=None):
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, default=None)
    args = p.parse_args(argv)

    results = load_results(args.run_dir)
    out_root = args.out_dir or os.path.join(args.run_dir, "xyz_pairs")
    os.makedirs(out_root, exist_ok=True)

    seen: dict = {}
    for i in range(len(results["ids"])):
        o = trim(results["original_pos"], results["mask"], i)
        g = trim(results["generated_pos"], results["mask"], i)
        sp_o = trim(results["original_species"], results["mask"], i)
        sp_g = trim(results["generated_species"], results["mask"], i)
        base = results["ids"][i]
        seen[base] = seen.get(base, 0) + 1
        uid = f"{base}_{seen[base]}"
        d = os.path.join(out_root, uid)
        os.makedirs(d, exist_ok=True)
        if o.shape[0] < 6:
            res = permutation_min_rmsd(o, g, max_atoms=o.shape[0])
            rmsd, order, aligned = res
            sp_g = sp_g[order]
            o_out = o - o[0]
        else:
            rmsd, row_ind, col_ind, aligned_full = hungarian_align(o, g)
            aligned = aligned_full[col_ind]
            sp_g = sp_g[col_ind]
            o_out = (o - o[0])[row_ind]
            sp_o = sp_o[row_ind]
        comment = f"{uid} {rmsd}"
        write_xyz(os.path.join(d, "original.xyz"), o_out, sp_o, comment)
        write_xyz(os.path.join(d, "generated.xyz"), aligned, sp_g, comment)
    print(f"wrote xyz pairs for {len(results['ids'])} samples to {out_root}")


if __name__ == "__main__":
    main()
