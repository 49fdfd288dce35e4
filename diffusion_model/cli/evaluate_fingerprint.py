"""Fingerprint similarity CLI — equivalent of ref evaluate_fingerprint.py.

Atom-pair topological fingerprints + count Tanimoto between original and
generated structures (native implementation; RDKit not in this image).
"""

from __future__ import annotations

import argparse

import numpy as np

from diffusion_model.cli.common import load_results, trim
from diffusion_model.evals import fingerprint_similarity
from diffusion_model.utils.logging import RunLogger


def _symbols(species):
    """One-hot rows -> element symbols by column order: the SiO2 layout
    O=[1,0]/Si=[0,1] (ref make_dataset.py:112-118) or QM9's H/C/N/O/F
    5-wide layout (data/qm9.py)."""
    width = np.asarray(species).shape[1]
    if width == 2:
        names = ("O", "Si")
    elif width == 5:
        from diffusion_model.data.qm9 import QM9_SPECIES

        names = QM9_SPECIES
    else:
        raise SystemExit(f"no element mapping for {width}-wide one-hots")
    return [names[int(np.argmax(s))] for s in species]


def main(argv=None):
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run_dir", type=str, required=True)
    p.add_argument("--method", type=str, default="atom_pair",
                   choices=("atom_pair", "morgan"),
                   help="fingerprint family: atom_pair (ref "
                        "GetAtomPairFingerprint) or morgan (ref "
                        "GetMorganGenerator radius=2 circular/ECFP)")
    args = p.parse_args(argv)

    results = load_results(args.run_dir)
    logger = RunLogger(args.run_dir)
    sims = []
    for i in range(len(results["ids"])):
        o = trim(results["original_pos"], results["mask"], i)
        g = trim(results["generated_pos"], results["mask"], i)
        sp_o = _symbols(trim(results["original_species"], results["mask"], i))
        sp_g = _symbols(trim(results["generated_species"], results["mask"], i))
        sims.append(fingerprint_similarity(o, sp_o, g, sp_g,
                                           method=args.method))
    sims = np.asarray(sims)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.hist(sims, bins=30, range=(0, 1))
    ax.set_xlabel("tanimoto similarity")
    ax.set_ylabel("count")
    ax.set_title(f"{args.method} fingerprint similarity "
                 f"(mean {sims.mean():.4f})")
    logger.log_figure("fingerprint_similarity", fig)
    plt.close(fig)
    logger.log({"fingerprint_similarity_mean": float(sims.mean())})
    print(f"fingerprint similarity: mean {sims.mean():.4f} "
          f"std {sims.std():.4f} over {len(sims)} pairs")


if __name__ == "__main__":
    main()
