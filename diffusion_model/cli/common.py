"""Shared helpers for evaluator CLIs: load a run's generated results."""

from __future__ import annotations

import numpy as np

from diffusion_model.utils.logging import RunLogger


def load_results(run_dir: str, artifact: str = "generated_graph_save_path",
                 accepted_only: bool = True) -> dict:
    """Load a run's generated results.

    ``accepted_only`` drops non-finite / rejected samples — the reference's
    generate() never returned those (ref parts/train_per_iretation.py:
    431-436); here rejects are persisted with their mask and filtered at
    load time.
    """
    logger = RunLogger(run_dir)
    path = logger.artifact(artifact)
    z = np.load(path, allow_pickle=False)
    results = {k: z[k] for k in z.files if k != "ids"}
    results["ids"] = [str(i) for i in z["ids"]]
    if accepted_only and "accepted" in results:
        keep = np.nonzero(results["accepted"])[0]
        results["ids"] = [results["ids"][i] for i in keep]
        for k, v in results.items():
            if k == "ids":
                continue
            if k.startswith("trajectory"):
                # [snapshots, samples, ...] — the sample axis is axis 1
                results[k] = np.asarray(v)[:, keep]
            else:
                results[k] = np.asarray(v)[keep]
    return results


def trim(pos, mask, i):
    n = int(mask[i].sum())
    return np.asarray(pos[i][:n])
