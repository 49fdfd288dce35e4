"""CN predictor CLI — equivalent of ref CN.py:156-220.

Trains the standalone MLP regressing the number of atoms in the local
environment from the EELS spectrum (ref CN.py:79-96), reporting MAE and the
rounded-prediction accuracy/macro-F1 (ref CN.py:20-77).
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax

from diffusion_model import api
from diffusion_model.config import Config
from diffusion_model.data.io import load_dataset
from diffusion_model.data.split import split_dataset
from diffusion_model.data.synthetic import synthetic_sio2_dataset
from diffusion_model.nn import CNPredictor


def macro_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Macro-averaged F1 over the integer classes present in y_true
    (ref CN.py:20-77 computes the same by hand)."""
    classes = sorted(set(y_true.tolist()))
    f1s = []
    for c in classes:
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1s.append(2 * prec * rec / (prec + rec) if prec + rec else 0.0)
    return float(np.mean(f1s))


def graphs_to_xy(graphs):
    x = np.stack([np.asarray(g["spectrum"][0], np.float32) for g in graphs])
    y = np.asarray([[float(np.asarray(g["pos"]).shape[0])] for g in graphs],
                   np.float32)
    return jnp.asarray(x), jnp.asarray(y)


def main(argv=None):
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset_path", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=256)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=2024)
    args = p.parse_args(argv)

    cfg = Config()
    if args.dataset_path:
        graphs = api.prepare_dataset(load_dataset(args.dataset_path), cfg)
    else:
        graphs = synthetic_sio2_dataset(args.seed, args.synthetic, 16,
                                        spectrum_size=cfg.spectrum_size)
    train_g, val_g, test_g = split_dataset(graphs, args.seed)
    x_tr, y_tr = graphs_to_xy(train_g)
    x_te, y_te = graphs_to_xy(test_g)

    model = CNPredictor()
    params = model.init(jax.random.key(args.seed), x_tr[:1])
    opt = optax.adam(args.lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            pred = model.apply(p, x_tr)
            return jnp.mean((pred - y_tr) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    for epoch in range(args.epochs):
        params, opt_state, loss = step(params, opt_state)
        if epoch % 50 == 0:
            print(f"epoch {epoch}  train_mse {float(loss):.5f}")

    pred = np.asarray(model.apply(params, x_te))[:, 0]
    truth = np.asarray(y_te)[:, 0]
    mae = float(np.mean(np.abs(pred - truth)))
    acc = float(np.mean(np.round(pred) == truth))
    f1 = macro_f1(truth.astype(int), np.round(pred).astype(int))
    print(f"test MAE {mae:.4f}  rounded accuracy {acc:.4f}  "
          f"macro-F1 {f1:.4f} (n={len(truth)})")


if __name__ == "__main__":
    main()
