"""Bisect the 192-atom network-data training NaN on the real chip.

A 192-atom/bs-8/kNN-32 run on amorphous_network_cell data goes
non-finite EVERY epoch on the accelerator (runs/size_gen_192net diverged) while
a 4-step single-batch probe on the first 8 cells was finite. Replaying
api.train's exact epoch-0 path showed it is NOT a poison cell: batch 0
steps fine (loss 785, grad_norm 7.8e4 pre-clip), then EVERY cell scores
loss ~1e25-1e26 with NaN grads from the post-step state — the first
optimizer update itself re-triggers the non-residual h-update blowup
that h_init_scale had tamed at init.

This probe replays the exact data path / PRNG chain and sweeps
mitigation configs: dtype, lr, optimizer, warmup steps, h_init_scale.
Each step prints loss / pre-clip grad_norm / param drift from init.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def tree_l2(a, b):
    import jax

    leaves = jax.tree.leaves(
        jax.tree.map(lambda x, y: float(((x - y) ** 2).sum()), a, b))
    return float(np.sqrt(sum(leaves)))


def run_case(train_set, label, steps, retest_init=False, **over):
    import jax

    from diffusion_model.config import Config
    from diffusion_model.data.batch import collate
    from diffusion_model.data.split import device_batch_iterator
    from diffusion_model.train.trainer import Trainer

    kw = dict(
        n_max=192, neighbor_k=32, batch_size=8,
        num_diffusion_timestep=1000, num_epochs=5, lr=2e-4,
        optimizer="RAdamScheduleFree", compute_dtype="bfloat16",
        gen_num_per_spectrum=2, h_init_scale=1e-3, checkpoint_every=500,
    )
    kw.update(over)
    cfg = Config(**kw)
    trainer = Trainer(cfg)
    example = collate(train_set[: cfg.batch_size], cfg.n_max)
    key = jax.random.key(cfg.seed)
    key, init_key = jax.random.split(key)
    state = trainer.init_state(init_key, example)
    init_params = state.params
    train_data = collate(train_set, cfg.n_max)
    print(f"== {label}", flush=True)
    key, k_tr, k_ev = jax.random.split(key, 3)
    batches = list(device_batch_iterator(
        train_data, cfg.batch_size, seed=cfg.seed))
    ekey = k_tr
    subs = []
    for _ in batches:
        ekey, sub = jax.random.split(ekey)
        subs.append(sub)
    if retest_init:
        # is batch 1 finite from the INIT state? (data vs update blame)
        _, m = trainer.train_step(state, subs[1], batches[1])
        print(f"  batch1-from-init: loss {float(m['loss']):.6g} "
              f"grad_norm {float(m['grad_norm']):.6g}", flush=True)
    for bi in range(min(steps, len(batches))):
        state, m = trainer.train_step(state, subs[bi], batches[bi])
        loss = float(np.asarray(m["loss"]))
        gn = float(np.asarray(m["grad_norm"]))
        drift = tree_l2(state.params, init_params)
        print(f"  step {bi}: loss {loss:.6g} grad_norm {gn:.6g} "
              f"param_drift {drift:.4g}", flush=True)
        if not np.isfinite(loss):
            print("  -> non-finite, stopping case", flush=True)
            break


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--platform", type=str, default="default",
                   choices=("default", "cpu"))
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--cases", type=str, default="base")
    args = p.parse_args()
    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from diffusion_model import api
    from diffusion_model.config import Config
    from diffusion_model.data.split import split_dataset
    from diffusion_model.data.synthetic import amorphous_network_cell

    print("devices", jax.devices(), flush=True)
    cfg0 = Config(n_max=192)
    rng = np.random.default_rng(cfg0.seed)
    train_graphs = [
        amorphous_network_cell(
            seed=int(s), num_atoms=int(rng.integers(128, 192 + 1)),
            spectrum_size=cfg0.spectrum_size)
        for s in rng.integers(0, 2**31, 96)
    ]
    dataset = api.prepare_dataset(train_graphs, cfg0)
    train_set, _, _ = split_dataset(dataset, cfg0.seed)

    catalog = {
        "base": dict(retest_init=True),
        "f32": dict(compute_dtype="float32"),
        "lowlr": dict(lr=2e-5),
        "adam": dict(optimizer="Adam"),
        "clip1": dict(max_grad_norm=1.0),
        "clip01": dict(max_grad_norm=0.1),
        "lowlr5e5": dict(lr=5e-5),
        "hinit1": dict(h_init_scale=1.0),
    }
    for name in args.cases.split(","):
        over = dict(catalog[name])
        retest = over.pop("retest_init", False)
        run_case(train_set, name, args.steps, retest_init=retest, **over)


if __name__ == "__main__":
    main()
