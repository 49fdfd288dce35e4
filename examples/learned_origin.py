"""Test the learned-schedule "own optimum" claim with evidence.

Round 2 closed the learned-schedule gap to 0.829/0.900 rdf_cos vs the
predefined 0.900/0.941 and ASSERTED that the residual gap is the trained
schedule's own optimum under the reference eps-MSE objective. This driver
tests that claim directly (VERDICT r2 weak #3 / next #3): fit the
GammaNetwork to the polynomial schedule BEFORE training (so the learned
run starts exactly at the predefined optimum's schedule), train the full
model, and record whether the objective actively migrates the schedule
away from the polynomial curve:

  * if it migrates and quality lands back at ~0.83 — the gap is the
    objective's own preference, settled with evidence;
  * if it stays at the polynomial and quality matches the predefined run
    — the gap was an optimisation artifact of the default init and this
    IS the fix.

Structural finding baked into this experiment: the reference's
``PositiveLinear`` registers ``bias=None`` (ref SNR.py:5-22), so
gamma_tilde(t) = w t + sum_k a_k sigmoid(b_k w t) is a sum of sigmoid
ramps all anchored at t = 0 — the family CANNOT place a knee late in t,
and the polynomial schedule's steep deep-noise tail (alpha -> 0 over the
last ~10% of t) is unrepresentable. The best in-family approximation
(this pre-fit) reaches max |alpha deviation| ~ 0.09, all of it in that
tail; the clean-data end (alpha(0), which controls the t=0 epilogue noise
and therefore RDF quality) fits to < 5e-4. So the learned-schedule family
and the predefined optimum are structurally disjoint at the noise end —
the experiment below measures where the objective actually pulls the
schedule WITHIN the representable family.

Ref: SNR.py:27-65 (the gamma net trains through the same loss),
diffusion_x_h.py:27-46. Writes ``docs/quality/learned_origin_test.json``
and per-checkpoint gamma curves into the run dir.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def fit_gamma_to_polynomial(trainer, cfg, steps: int = 6000,
                            lr: float = 1e-2):
    """Alpha^2-space pre-fit of the gamma net to the polynomial schedule
    (the shipped implementation lives in nn/gamma.fit_gamma_to_schedule,
    exposed as cfg.gamma_init="polynomial"; this wrapper keeps the
    experiment script's original interface)."""
    from diffusion_model.diffusion.process import predefined_schedule
    from diffusion_model.nn.gamma import fit_gamma_to_schedule

    params, max_err = fit_gamma_to_schedule(
        trainer.gamma, predefined_schedule(cfg).alphas, jax.random.key(0),
        steps=steps, lr=lr,
    )
    return params, float(max_err)


def gamma_curve(trainer, params, n: int = 101):
    t = jnp.linspace(0.0, 1.0, n)[:, None]
    return np.asarray(trainer.gamma.apply(params, t))[:, 0]


def alpha_curve(trainer, params, n: int = 101):
    """alpha(t) — the schedule as the diffusion process actually sees it."""
    g = gamma_curve(trainer, params, n)
    return np.sqrt(1.0 / (1.0 + np.exp(np.clip(g, -30, 30))))


def main():
    from diffusion_model.utils import setup_compile_cache
    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out_dir", type=str, default="runs/learned_origin")
    p.add_argument("--num", type=int, default=256)
    p.add_argument("--epochs", type=int, default=3000)
    p.add_argument("--snapshot_epochs", type=int, default=250)
    p.add_argument("--out", type=str,
                   default="docs/quality/learned_origin_test.json")
    args = p.parse_args()

    from diffusion_model import api
    from diffusion_model.config import Config
    from diffusion_model.data.split import batch_iterator, split_dataset
    from diffusion_model.data.synthetic import synthetic_sio2_dataset
    from diffusion_model.evals import evaluate_rdf_lists
    from diffusion_model.train import Trainer, save_checkpoint
    from diffusion_model.utils.logging import RunLogger

    cfg = Config(
        n_max=16, batch_size=64, lr=2e-4,
        num_diffusion_timestep=1000, num_epochs=args.epochs,
        optimizer="RAdamScheduleFree", compute_dtype="bfloat16",
        noise_schedule="learned",
    )
    print(f"devices: {jax.devices()}", flush=True)
    graphs = synthetic_sio2_dataset(cfg.seed, args.num, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=2)
    graphs = api.prepare_dataset(graphs, cfg)
    train_set, val_set, test_set = split_dataset(graphs, cfg.seed)

    trainer = Trainer(cfg)
    from diffusion_model.data.batch import collate

    example = collate(train_set[: cfg.batch_size], cfg.n_max)
    key = jax.random.key(cfg.seed)
    key, init_key = jax.random.split(key)
    state = trainer.init_state(init_key, example)

    # --- pre-fit the gamma net to the polynomial schedule -------------
    t0 = time.time()
    gamma_fit, fit_max_err = fit_gamma_to_polynomial(trainer, cfg)
    print(f"gamma pre-fit max|alpha^2 err| {fit_max_err:.5f} "
          f"in {time.time()-t0:.0f}s", flush=True)
    params = dict(state.params)
    params["gamma"] = gamma_fit
    # rebuild the optimizer state AFTER the override: schedule-free keeps
    # parameter copies inside its state, so init must see the final params
    opt_state = trainer.optimizer.init(params)
    from diffusion_model.train.trainer import TrainState

    state = TrainState(params=params, opt_state=opt_state,
                       step=jnp.zeros((), jnp.int32))

    init_alpha = alpha_curve(trainer, gamma_fit)
    logger = RunLogger(args.out_dir, cfg)
    snapshots = []
    t0 = time.time()
    for epoch in range(args.epochs):
        key, k_tr, k_ev = jax.random.split(key, 3)
        batches = batch_iterator(train_set, cfg.batch_size, cfg.n_max,
                                 seed=cfg.seed + epoch)
        state, train_loss = trainer.train_epoch(state, k_tr, batches)
        if (epoch + 1) % args.snapshot_epochs == 0 or epoch == 0:
            gp = state.eval_params(cfg)["gamma"]
            curve = gamma_curve(trainer, gp)
            a = alpha_curve(trainer, gp)
            snap = {
                "epoch": epoch + 1,
                "train_loss": float(train_loss),
                "alpha_rmse_from_polynomial_init": round(float(
                    np.sqrt(np.mean((a - init_alpha) ** 2))), 4),
                "alpha_max_dev_from_init": round(float(
                    np.max(np.abs(a - init_alpha))), 4),
                "gamma_0": round(float(curve[0]), 3),
                "gamma_1": round(float(curve[-1]), 3),
            }
            snapshots.append(snap)
            logger.log(snap, step=epoch)
            print(snap, flush=True)
    train_s = time.time() - t0
    save_checkpoint(os.path.join(args.out_dir, "checkpoints"), state, cfg,
                    step=args.epochs)

    # --- final quality at the flagship protocol -----------------------
    results = api.generate(cfg, trainer, state, test_set)
    # persist the samples in the flagship layout so the conditional-
    # geometry readout (examples/flagship_ceiling.py --run_dir) can score
    # this schedule the same way learned_ceiling.json scored the
    # default-init learned run
    np.savez_compressed(
        os.path.join(args.out_dir, "generated.npz"),
        **{k: v for k, v in results.items() if k != "ids"},
        ids=np.asarray(results["ids"]),
    )
    keep = np.nonzero(results["accepted"])[0]
    rdf_rows = evaluate_rdf_lists(
        results["original_pos"][keep], results["mask"][keep],
        results["generated_pos"][keep], results["mask"][keep],
    )
    rdf_cos = np.asarray([r["cos"] for r in rdf_rows])

    gp_final = state.eval_params(cfg)["gamma"]
    final_curve = gamma_curve(trainer, gp_final)
    final_alpha = alpha_curve(trainer, gp_final)
    out = {
        "config": f"learned_origin_{args.epochs}ep_2shell_n16",
        "prefit_alpha2_max_err": round(fit_max_err, 5),
        "train_seconds": round(train_s, 1),
        "finite_fraction": float(results["finite"].mean()),
        "num_accepted": int(len(keep)),
        "rdf_cos_mean": round(float(rdf_cos.mean()), 4),
        "rdf_cos_median": round(float(np.median(rdf_cos)), 4),
        "alpha_final_rmse_from_polynomial_init": round(float(
            np.sqrt(np.mean((final_alpha - init_alpha) ** 2))), 4),
        "alpha_final_max_dev_from_init": round(float(
            np.max(np.abs(final_alpha - init_alpha))), 4),
        "gamma_final_endpoints": [round(float(final_curve[0]), 3),
                                  round(float(final_curve[-1]), 3)],
        "snapshots": snapshots,
        "baselines": {
            "predefined (q_predef_r2)": [0.900, 0.941],
            "learned default-init (q_learned_r3)": [0.829, 0.900],
        },
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1), flush=True)


if __name__ == "__main__":
    main()
