"""Checkpointing with optimizer state and true resume.

The reference only saves model state-dicts (never optimizer state) and has
no mid-training resume (ref main.py:219-228, SURVEY.md §5). Here a
checkpoint is the full TrainState (params + optimizer state + step) plus the
config dict, so training resumes exactly.

Layout: ``<dir>/<step>.npz`` holds the state's flattened leaves
(``leaf_00000`` ...) and ``<dir>/<step>.json`` the config plus the leaf
paths. The sidecar is written last, so a step counts only once both files
are complete. The newest three steps are kept.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from diffusion_model.config import Config, from_dict
from diffusion_model.nn.gamma import GammaNetwork

MAX_TO_KEEP = 3
_STEP_FILE = re.compile(r"^(\d+)\.json$")


def _steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(directory))
        if m and os.path.isfile(os.path.join(directory, f"{m.group(1)}.npz"))
    )


def _leaf_paths(tree) -> list:
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_leaves_with_path(tree)]


def save_checkpoint(directory: str, state, cfg: Config, step: int) -> None:
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    # Schema stamp: GammaNetwork stores its trainable endpoints PRE-SCALED
    # by endpoint_scale (nn/gamma.py). Recording the scale the checkpoint
    # was written under lets restore_checkpoint rescale (or detect) learned
    # -schedule checkpoints written under a different reparameterisation
    # instead of silently loading garbage endpoints.
    meta = cfg.to_dict()
    meta["gamma_endpoint_scale"] = float(GammaNetwork.endpoint_scale)
    leaves = {}
    for i, leaf in enumerate(jax.tree.leaves(state)):
        a = np.asarray(leaf)
        if a.dtype.kind == "V":  # bfloat16 & co: numpy cannot store them
            a = a.astype(np.float32)
        leaves[f"leaf_{i:05d}"] = a
    base = os.path.join(directory, str(step))
    with open(base + ".npz.tmp", "wb") as f:
        np.savez(f, **leaves)
    os.replace(base + ".npz.tmp", base + ".npz")
    with open(base + ".json.tmp", "w") as f:
        json.dump({"config": meta, "leaf_paths": _leaf_paths(state)}, f)
    os.replace(base + ".json.tmp", base + ".json")
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        for ext in (".json", ".npz"):
            os.remove(os.path.join(directory, f"{old}{ext}"))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, abstract_state: Any,
                       step: int | None = None):
    """Restore (state, cfg). ``abstract_state`` is a TrainState template
    (e.g. from ``Trainer.init_state``) defining the pytree structure; the
    stored leaves fill its treedef in order, cast to its leaf dtypes."""
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    base = os.path.join(directory, str(step))
    with open(base + ".json") as f:
        side = json.load(f)
    templ_leaves, treedef = jax.tree.flatten(abstract_state)
    if side["leaf_paths"] != _leaf_paths(abstract_state):
        raise ValueError(
            f"checkpoint {base} does not match the template's structure "
            f"({len(side['leaf_paths'])} stored leaves, "
            f"{len(templ_leaves)} in the template)")
    with np.load(base + ".npz") as z:
        leaves = []
        for i, t in enumerate(templ_leaves):
            a = z[f"leaf_{i:05d}"]
            if a.shape != tuple(t.shape):
                raise ValueError(
                    f"checkpoint {base}: {side['leaf_paths'][i]} has shape "
                    f"{a.shape}, template {tuple(t.shape)}")
            leaves.append(jnp.asarray(a, dtype=t.dtype))
    state = jax.tree.unflatten(treedef, leaves)
    state = _rescale_gamma_endpoints(state, side["config"])
    return state, from_dict(side["config"])


def _rescale_gamma_endpoints(state, saved_config: dict):
    """Convert stored gamma endpoints to the current reparameterisation.

    Checkpoints written before the endpoint_scale reparameterisation (no
    ``gamma_endpoint_scale`` stamp => raw endpoints, scale 1.0) or under a
    different scale hold ``gamma_0``/``gamma_1`` arrays whose semantic
    value is ``stored * stored_scale``; rescale them so
    ``new_raw * current_scale`` preserves the semantic schedule.

    The optimizer state holds parameter COPIES that evaluation reads back
    out — schedule-free's ``z`` iterate (``eval_params`` interpolates y/z)
    and the EMA average — which must be rescaled identically or the
    rescue is defeated for the default optimizer. Adam moments track
    GRADIENTS, which transform inversely to the parameter (g_raw =
    g_semantic * scale, so new/old = 1/ratio): mu scales by 1/ratio, nu
    by 1/ratio**2. (The mu/sqrt(nu) update direction is invariant to a
    common rescale, so this only matters near eps — kept exact anyway.)
    """
    stored_scale = float(saved_config.get("gamma_endpoint_scale", 1.0))
    current_scale = float(GammaNetwork.endpoint_scale)
    if stored_scale == current_scale:
        return state
    params = getattr(state, "params", None)
    if not isinstance(params, dict) or "gamma" not in params:
        return state
    ratio = stored_scale / current_scale
    gamma = jax.tree.map(lambda a: a, params["gamma"])  # shallow-safe copy
    for name in ("gamma_0", "gamma_1"):
        gamma["params"][name] = gamma["params"][name] * ratio
    new_params = dict(params)
    new_params["gamma"] = gamma

    import jax.tree_util as jtu

    def fix(path, leaf):
        keys = [getattr(k, "name", None) or getattr(k, "key", None)
                for k in path]
        if "gamma" not in keys or keys[-1] not in ("gamma_0", "gamma_1"):
            return leaf
        if "z" in keys or "ema" in keys:   # parameter copies
            return leaf * ratio
        if "mu" in keys:                   # first gradient moment
            return leaf / ratio
        if "nu" in keys:                   # second gradient moment
            return leaf / ratio**2
        return leaf

    new_opt_state = jtu.tree_map_with_path(fix, state.opt_state)
    return dataclasses.replace(state, params=new_params,
                               opt_state=new_opt_state)


# -- portable parameter snapshots (npz) ---------------------------------
#
# Run-dir checkpoints carry the optimizer state and are tied to a
# TrainState template; a flat .npz snapshot of the EVAL parameters is a few MB,
# loads anywhere numpy does, and survives environments where run dirs
# get recycled. The reference's closest analogue is its torch.save
# state-dict (ref main.py:219-228) — this is the same idea with a
# portable container and an explicit storage dtype.

def _flatten_params(params, prefix=""):
    out = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten_params(v, key))
        else:
            out[key] = v
    return out


def save_params_npz(params, path: str, dtype="float16",
                    cfg: Optional[Config] = None) -> int:
    """Save a (nested-dict) parameter tree as a compressed flat .npz.

    ``dtype`` is the STORAGE dtype — float16 halves the artifact for a
    ~1e-3 relative rounding, below the bf16 compute noise every
    production path already runs at. Pass ``cfg`` to embed the run
    config (JSON) so the snapshot is a single self-describing file.
    Returns the number of parameter arrays.
    """
    import json as _json

    import numpy as np

    flat = {k: np.asarray(v).astype(dtype)
            for k, v in _flatten_params(params).items()}
    n = len(flat)
    if cfg is not None:
        # unicode scalar, NOT dtype=object: keeps the artifact loadable
        # with allow_pickle=False (a committed file should never require
        # unpickling to read)
        flat["__config_json__"] = np.array(_json.dumps(cfg.to_dict()))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)
    return n


def load_params_npz(path: str, dtype="float32"):
    """Load a ``save_params_npz`` snapshot back into a nested dict."""
    import numpy as np

    with np.load(path) as z:  # parameter arrays are plain numerics;
        # the (possibly legacy object-dtype) config key is never read
        flat = {k: z[k].astype(dtype) for k in z.files
                if k != "__config_json__"}
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_config_npz(path: str) -> Optional[Config]:
    """Recover the Config embedded by ``save_params_npz(..., cfg=...)``."""
    import json as _json

    import numpy as np

    try:
        with np.load(path) as z:
            if "__config_json__" not in z.files:
                return None
            return from_dict(_json.loads(str(z["__config_json__"][()])))
    except ValueError:  # legacy snapshot: config stored as dtype=object
        with np.load(path, allow_pickle=True) as z:
            return from_dict(_json.loads(str(z["__config_json__"][()])))
