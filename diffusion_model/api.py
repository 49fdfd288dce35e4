"""High-level framework API: train / generate / evaluate / schedule plots.

These functions are what the reference's ``main.py`` orchestration does
inline (ref main.py:204-337), factored as a library surface the CLI drivers
(and tests) call. Everything host-side here; the hot paths live in
``train.Trainer`` and ``diffusion.sampler``.
"""

from __future__ import annotations

import json
import os
from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from diffusion_model.config import Config
from diffusion_model.data.batch import GraphBatch, collate
from diffusion_model.data.split import (
    batch_iterator,
    device_batch_iterator,
    split_dataset,
)
from diffusion_model.diffusion import sample, sample_with_retry
from diffusion_model.diffusion.sampler import SampleResult, tile_batch
from diffusion_model.evals import (
    density_accuracy,
    evaluate_by_rmsd,
    o_density,
)
from diffusion_model.ops.kabsch import kabsch_rmsd
from diffusion_model.train import (
    EarlyStopping,
    Trainer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from diffusion_model.utils.logging import RunLogger


def prepare_dataset(graphs: list, cfg: Config):
    """Reference preprocessing: truncate spectra to ``spectrum_size`` and
    drop single-atom graphs (ref main.py:140-144,176)."""
    out = []
    for g in graphs:
        if np.asarray(g["pos"]).shape[0] <= 1:
            continue
        g = dict(g)
        g["spectrum"] = np.asarray(g["spectrum"])[:, : cfg.spectrum_size]
        out.append(g)
    return out


def fit_n_max(graphs: list, multiple: int = 8) -> int:
    """Smallest padding size covering the dataset, rounded up for tiling."""
    biggest = max(np.asarray(g["pos"]).shape[0] for g in graphs)
    return int(-(-biggest // multiple) * multiple)


def train(cfg: Config, dataset: list, run_dir: str,
          logger: Optional[RunLogger] = None,
          num_epochs: Optional[int] = None, mesh=None,
          resume: bool = False,
          init_params_from: Optional[str] = None):
    """Training loop with eval, early stopping and checkpoints
    (ref main.py:204-228). With ``mesh`` (or ``cfg.mesh_shape`` set),
    batches are data-parallel sharded and the state replicated. With
    ``resume=True`` training continues from the latest checkpoint's epoch
    (true mid-training resume; the reference has none, SURVEY.md §5).

    ``init_params_from``: curriculum initialisation — a run dir whose
    latest checkpoint's EVAL parameters (the schedule-free averaged point /
    EMA, i.e. the quality-bearing iterate) seed this run's parameters,
    with a FRESH optimizer state and epoch 0. The EGNN is size-agnostic
    (shared per-node/per-edge parameters), so a 192-atom checkpoint
    initialises a 512-atom run directly; the architecture flags (L,
    neighbor_k-independent widths, lever set) must match the source. When
    ``resume=True`` finds a checkpoint in ``run_dir`` it wins (watchdog
    relaunches of a curriculum run must not restart from the source)."""
    logger = logger or RunLogger(run_dir, cfg)
    dataset = prepare_dataset(dataset, cfg)
    train_set, val_set, test_set = split_dataset(dataset, cfg.seed)
    trainer = Trainer(cfg)
    example = collate(train_set[: cfg.batch_size], cfg.n_max)
    key = jax.random.key(cfg.seed)
    key, init_key = jax.random.split(key)
    ckpt_dir = os.path.join(run_dir, "checkpoints")

    start_epoch = 0
    state = None
    if resume:
        step = latest_step(ckpt_dir)
        if step is not None:
            # template values are overwritten by the restore — skip the
            # gamma_init='polynomial' pre-fit (a 6000-step device scan)
            template = trainer.init_state(init_key, example,
                                          skip_gamma_fit=True)
            state, _ = restore_checkpoint(ckpt_dir, template, step=step)
            start_epoch = step
    if state is None and init_params_from:
        from diffusion_model.train.trainer import TrainState

        template = trainer.init_state(init_key, example,
                                      skip_gamma_fit=True)
        src_state, src_cfg = restore_checkpoint(
            os.path.join(init_params_from, "checkpoints"), template
        )
        params = src_state.eval_params(src_cfg)
        state = TrainState(
            params=params,
            opt_state=trainer.optimizer.init(params),
            step=jnp.zeros((), jnp.int32),
        )
        print(f"curriculum init: params from {init_params_from} "
              f"(source step {int(src_state.step)})", flush=True)
    if state is None:
        state = trainer.init_state(init_key, example)

    if mesh is None and len(cfg.mesh_shape) > 0:
        from diffusion_model.parallel import make_mesh

        mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axis_names)
    if mesh is not None:
        from diffusion_model.parallel import replicate

        state = jax.device_put(state, replicate(mesh))
    stopper = EarlyStopping(patience=cfg.patience)

    from diffusion_model.utils.profiling import PhaseTimer

    timer = PhaseTimer()
    epochs = num_epochs if num_epochs is not None else cfg.num_epochs
    epoch = start_epoch
    nan_recoveries = 0
    good_state = state
    # Datasets live ON DEVICE for the whole run; epochs gather shuffled
    # batches with jnp.take instead of re-uploading host arrays (same
    # seeded order as batch_iterator, see device_batch_iterator).
    train_data = collate(train_set, cfg.n_max)
    val_data = collate(val_set, cfg.n_max) if val_set else None
    for epoch in range(start_epoch, epochs):
        # an epoch's keys depend on its number alone, so a resumed run
        # draws the same noise as an uninterrupted one
        k_tr, k_ev = jax.random.split(jax.random.fold_in(key, epoch))
        batches = device_batch_iterator(
            train_data, cfg.batch_size, seed=cfg.seed + epoch
        )
        with timer.phase("train_epoch"):
            state, train_loss = trainer.train_epoch(state, k_tr, batches,
                                                    mesh=mesh)
        # Training-level failure detection: a non-finite epoch rolls back
        # to the last good state instead of poisoning the run (the
        # reference's only failure handling is the sampler's NaN retry +
        # exit(), SURVEY.md §5).
        if not np.isfinite(train_loss):
            nan_recoveries += 1
            logger.log({"nan_recovery": nan_recoveries}, step=epoch)
            if nan_recoveries > 10:
                raise RuntimeError(
                    "training diverged: 10 non-finite epochs"
                )
            state = good_state
            continue
        good_state = state
        val_batches = (
            device_batch_iterator(val_data, cfg.batch_size)
            if val_data is not None else iter(())
        )
        with timer.phase("eval_epoch"):
            eval_loss = trainer.eval_epoch(state, k_ev, val_batches,
                                           mesh=mesh)
        logger.log(
            {"train_loss": train_loss, "eval_loss": eval_loss}, step=epoch
        )
        if cfg.checkpoint_every and (epoch + 1) % cfg.checkpoint_every == 0:
            with timer.phase("checkpoint"):
                save_checkpoint(ckpt_dir, state, cfg, step=epoch + 1)
        if stopper.validate(eval_loss):
            break

    with timer.phase("checkpoint"):
        save_checkpoint(ckpt_dir, state, cfg, step=epoch + 1)
    logger.register_artifact("checkpoints", ckpt_dir)
    # per-phase wall-clock profile (SURVEY §5: the reference has no
    # profiling at all) — persisted for every run
    with open(os.path.join(run_dir, "profile.json"), "w") as f:
        json.dump(timer.report(), f, indent=1)
    return trainer, state, (train_set, val_set, test_set)


def distill(cfg: Config, trainer: Trainer, state, train_graphs: list,
            final_steps: int, epochs_per_phase: int = 50,
            lr: float = 1e-4, key=None, log_fn=print):
    """Progressively distill the trained model into a ``final_steps``
    deterministic student (train/distill.py; beyond-reference capability —
    the reference can only truncate its 1000-step loop).

    Returns ``(student_cfg, student_state)`` drop-in compatible with
    ``api.generate``: the student cfg pins the dyadic sampling grid
    (``sample_steps=final_steps, deterministic_sampling=True``) and the
    state carries the student denoiser (plus the teacher's gamma subtree,
    so learned-schedule configs keep their schedule table).
    """
    from diffusion_model.train.distill import progressive_distill
    from diffusion_model.train.trainer import TrainState

    key = key if key is not None else jax.random.key(cfg.seed + 17)
    params = state.eval_params(cfg)
    schedule = trainer.schedule_for(params)

    def batches_fn():
        return batch_iterator(train_graphs, cfg.batch_size, cfg.n_max,
                              seed=cfg.seed)

    result = progressive_distill(
        cfg, trainer.model.apply, params["denoiser"], schedule,
        batches_fn, key, final_steps=final_steps,
        epochs_per_phase=epochs_per_phase, lr=lr, log_fn=log_fn,
    )
    student_params = dict(params)
    student_params["denoiser"] = result.params
    # optimizer="Adam" => TrainState.eval_params is the identity (the
    # student has no schedule-free averaging state to resolve)
    # sample_grid is pinned to "uniform": the student was distilled on the
    # dyadic grid (exactly round(linspace) when final_steps divides T), so
    # inheriting a teacher's sample_grid="snr" would silently sample it on
    # indices it never learned to match.
    student_cfg = cfg.replace(
        sample_steps=result.num_steps,
        deterministic_sampling=True,
        sample_grid="uniform",
        optimizer="Adam",
        # the student's TrainState carries opt_state=None — an inherited
        # ema_decay>0 would send eval_params to opt_state[-1].ema and crash
        ema_decay=0.0,
    )
    student_state = TrainState(
        params=student_params, opt_state=None,
        step=jnp.zeros((), jnp.int32),
    )
    return student_cfg, student_state


def load_trained(run_dir: str, cfg: Config, example: GraphBatch):
    """Restore the latest checkpoint of a run (generate_only/evaluate_only
    path, ref main.py:236-238)."""
    trainer = Trainer(cfg)
    template = trainer.init_state(jax.random.key(0), example,
                                  skip_gamma_fit=True)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    state, _ = restore_checkpoint(ckpt_dir, template)
    return trainer, state


def generate(cfg: Config, trainer: Trainer, state, test_graphs: list,
             key=None, gen_num_per_spectrum: Optional[int] = None,
             batch_size: int = 16, return_trajectory: bool = False,
             size_predictor=None):
    """Sample ``gen_num_per_spectrum`` structures per test condition
    (ref parts/train_per_iretation.py:264-444).

    ``size_predictor``: optional ``(CNPredictor module, params)`` — the
    generated structure size is then *predicted* from the spectrum instead
    of copied from the condition (the reference hardcodes the true size
    with the comment that it "should be predicted", ref :291-292, and
    ships the CN model for it, ref CN.py).

    Returns dict with original arrays, generated SampleResult fields and the
    repeat-expanded ids (condition i repeated G times, contiguous — the
    grouping the CN2 evaluator's group means expect).
    """
    if size_predictor is not None:
        test_graphs = predict_sizes(cfg, size_predictor, test_graphs)
    g = gen_num_per_spectrum or cfg.gen_num_per_spectrum
    key = key if key is not None else jax.random.key(cfg.seed)
    params = state.eval_params(cfg)
    denoise_fn = trainer.denoise_fn(params)
    schedule = trainer.schedule_for(params)
    jitted = jax.jit(
        partial(sample, denoise_fn, schedule, cfg,
                return_trajectory=return_trajectory)
    )

    outs = []
    ids = []
    orig_pos, orig_species, masks = [], [], []
    for start in range(0, len(test_graphs), batch_size):
        chunk = test_graphs[start : start + batch_size]
        n_real = len(chunk)
        if n_real < batch_size and len(test_graphs) >= batch_size:
            # pad the final chunk so the jitted scan keeps one shape
            # (padded entries are trimmed from the outputs below)
            chunk = list(chunk) + [chunk[-1]] * (batch_size - n_real)
        cond = collate(chunk, cfg.n_max)
        tiled = tile_batch(cond, g)
        key, sub = jax.random.split(key)
        res = sample_with_retry(denoise_fn, schedule, cfg, sub, tiled,
                                jitted_sample=jitted)
        res = jax.tree.map(np.asarray, res)
        if n_real < len(chunk):
            keep = n_real * g
            traj = res.trajectory
            if traj is not None:
                traj = tuple(t[:, :keep] for t in traj)
            res = SampleResult(
                pos=res.pos[:keep], species=res.species[:keep],
                h=res.h[:keep], finite=res.finite[:keep],
                accepted=res.accepted[:keep], trajectory=traj,
            )
        outs.append(res)
        for gr in chunk[:n_real]:
            ids += [gr["id"]] * g
        orig_pos.append(
            np.repeat(np.asarray(cond.pos[:n_real]), g, axis=0)
        )
        orig_species.append(
            np.repeat(np.asarray(cond.species[:n_real]), g, axis=0)
        )
        masks.append(np.repeat(np.asarray(cond.mask[:n_real]), g, axis=0))

    def cat(field):
        return np.concatenate([getattr(o, field) for o in outs], axis=0)

    extra = {}
    if return_trajectory and outs and outs[0].trajectory is not None:
        # [snapshots, total_samples, N, *] — the per-100-step transition
        # record of ref parts/train_per_iretation.py:331-337
        extra["trajectory_pos"] = np.concatenate(
            [o.trajectory[0] for o in outs], axis=1
        )
        extra["trajectory_h"] = np.concatenate(
            [o.trajectory[1] for o in outs], axis=1
        )

    return {
        "ids": ids,
        **extra,
        "original_pos": np.concatenate(orig_pos, axis=0),
        "original_species": np.concatenate(orig_species, axis=0),
        "mask": np.concatenate(masks, axis=0),
        "generated_pos": cat("pos"),
        "generated_species": cat("species"),
        "generated_h": cat("h"),
        "finite": cat("finite"),
        "accepted": cat("accepted"),
    }


def generate_ring(cfg: Config, trainer: Trainer, state, test_graphs: list,
                  mesh=None, axis: str = "data", key=None,
                  gen_num_per_spectrum: Optional[int] = None):
    """Sample through the ppermute ring: one node-sharded graph per call.

    The generation route for dense-topology cells whose ``[N, N]`` pair
    grid exceeds one chip (SURVEY.md §2.6; capability analogue of ref
    ``generate_amorphous.py`` at 4096+ atoms): the scan sampler runs
    UNCHANGED (strided/DDIM/CFG/t=0 epilogue, NaN retry) with its denoiser
    routed through ``parallel.ring.ring_sampler_denoise_fn``; conditions
    and their ``gen_num_per_spectrum`` repeats are driven sequentially at
    B=1 (one ring = one resident graph). Output dict matches
    :func:`generate` field-for-field, so every evaluator CLI consumes it.
    """
    from diffusion_model.parallel import make_mesh
    from diffusion_model.parallel.ring import ring_sampler_denoise_fn

    if not cfg.ring_sample:
        cfg = cfg.replace(ring_sample=True)
    if mesh is None:
        mesh = make_mesh(cfg.mesh_shape or None, (axis,))
    if cfg.n_max % mesh.devices.size != 0:
        raise ValueError(
            f"n_max={cfg.n_max} not divisible by mesh size "
            f"{mesh.devices.size}")
    g = gen_num_per_spectrum or cfg.gen_num_per_spectrum
    key = key if key is not None else jax.random.key(cfg.seed)
    params = state.eval_params(cfg)
    denoise_fn = ring_sampler_denoise_fn(cfg, params["denoiser"], mesh,
                                         axis)
    schedule = trainer.schedule_for(params)
    jitted = jax.jit(partial(sample, denoise_fn, schedule, cfg))

    outs, ids = [], []
    orig_pos, orig_species, masks = [], [], []
    for gr in test_graphs:
        cond = collate([gr], cfg.n_max)
        for _ in range(g):
            key, sub = jax.random.split(key)
            res = sample_with_retry(denoise_fn, schedule, cfg, sub, cond,
                                    jitted_sample=jitted)
            outs.append(jax.tree.map(np.asarray, res))
            ids.append(gr["id"])
        orig_pos.append(np.repeat(np.asarray(cond.pos), g, axis=0))
        orig_species.append(np.repeat(np.asarray(cond.species), g, axis=0))
        masks.append(np.repeat(np.asarray(cond.mask), g, axis=0))

    def cat(field):
        return np.concatenate([getattr(o, field) for o in outs], axis=0)

    return {
        "ids": ids,
        "original_pos": np.concatenate(orig_pos, axis=0),
        "original_species": np.concatenate(orig_species, axis=0),
        "mask": np.concatenate(masks, axis=0),
        "generated_pos": cat("pos"),
        "generated_species": cat("species"),
        "generated_h": cat("h"),
        "finite": cat("finite"),
        "accepted": cat("accepted"),
    }


def predict_sizes(cfg: Config, size_predictor, test_graphs: list) -> list:
    """Re-size each condition to the CN-predicted atom count: the per-node
    arrays are truncated or zero-padded to round(model(spectrum)) atoms
    (clamped to [2, n_max]); node 0 (exO) keeps the real spectrum row."""
    model, params = size_predictor
    spectra = jnp.asarray(
        np.stack([np.asarray(g["spectrum"][0], np.float32)
                  for g in test_graphs])
    )
    pred = np.asarray(model.apply(params, spectra))[:, 0]
    # non-finite predictions (untrained/diverged model) fall back to the
    # condition's true size instead of np.clip(NaN).astype(int) garbage
    true_sizes = np.asarray(
        [np.asarray(g["pos"]).shape[0] for g in test_graphs], np.float64
    )
    pred = np.where(np.isfinite(pred), pred, true_sizes)
    sizes = np.clip(np.round(pred), 2, cfg.n_max).astype(int)
    out = []
    for g, n in zip(test_graphs, sizes):
        g = dict(g)
        cur = np.asarray(g["pos"]).shape[0]
        for field in ("pos", "species", "spectrum", "exo"):
            a = np.asarray(g[field], np.float32)
            if n <= cur:
                g[field] = a[:n]
            else:
                padded = np.zeros((n,) + a.shape[1:], np.float32)
                padded[:cur] = a
                g[field] = padded
        # default species for grown slots: O one-hot (argmax decodes anyway)
        if n > cur:
            g["species"][cur:, 0] = 1.0
        out.append(g)
    return out


def evaluate(results: dict, run_dir: str, logger: Optional[RunLogger] = None,
             create_xyz: bool = False):
    """RMSD-sorted evaluation + O-density accuracy + figures
    (ref main.py:262-321)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    logger = logger or RunLogger(run_dir)
    # Keep finite, accepted samples only — the reference's generate() never
    # returns non-finite or >1000 A structures (ref :431-436); here rejects
    # are carried in the result masks and dropped at evaluation time.
    keep = np.nonzero(np.asarray(results["accepted"]))[0]
    if len(keep) == 0:
        logger.log({"num_accepted": 0})
        print("warning: no finite accepted samples to evaluate")
        return {"sorted_rmsd": [], "atom_type_accuracy": float("nan"),
                "num_accepted": 0}
    results = dict(results)
    results["ids"] = [results["ids"][i] for i in keep]
    for k in ("original_pos", "original_species", "mask", "generated_pos",
              "generated_species"):
        results[k] = np.asarray(results[k])[keep]
    sorted_rows = evaluate_by_rmsd(
        results["original_pos"], results["generated_pos"], results["mask"],
        ids=list(range(len(results["ids"]))),
    )
    rmsds = [r[1] for r in sorted_rows]

    fig, ax = plt.subplots()
    ax.plot(rmsds, marker="o", linestyle="None")
    ax.set_xlabel("sorted_index")
    ax.set_ylabel("rmsd")
    ax.set_yscale("log")
    ax.set_title("rmsd")
    logger.log_figure("rmsd", fig)
    plt.close(fig)

    d_orig = o_density(results["original_species"], results["mask"])
    d_gen = o_density(results["generated_species"], results["mask"])
    acc = density_accuracy(d_orig, d_gen)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot([0, 1], [0, 1], "-", color="red", alpha=0.5)
    ax.plot(d_orig, d_gen, "o", alpha=0.5)
    ax.set_xlabel("density of O for original")
    ax.set_ylabel("density of O for generated")
    ax.set_title(f"atom_type_eval (accuracy {acc:.5f})")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    logger.log_figure("atom_type_eval", fig)
    plt.close(fig)

    logger.log({
        "rmsd_best": float(rmsds[0]),
        "rmsd_median": float(rmsds[len(rmsds) // 2]),
        "rmsd_worst": float(rmsds[-1]),
        "atom_type_accuracy": acc,
        "num_accepted": len(keep),
    })

    if create_xyz:
        from diffusion_model.data.xyz import write_xyz_overlay

        picks = {
            "first_min_rmsd": 0,
            "second_min_rmsd": 1,
            "third_min_rmsd": 2,
            "mid_rmsd": len(sorted_rows) // 2,
            "max_rmsd": len(sorted_rows) - 1,
        }
        for name, rank in picks.items():
            if rank >= len(sorted_rows):
                continue
            idx, rmsd = sorted_rows[rank][0], sorted_rows[rank][1]
            n_real = int(results["mask"][idx].sum())
            write_xyz_overlay(
                os.path.join(run_dir, f"{name}.xyz"),
                results["original_pos"][idx][:n_real],
                results["original_species"][idx][:n_real],
                results["generated_pos"][idx][:n_real],
                results["generated_species"][idx][:n_real],
                comment=f"{name} {results['ids'][idx]} rmsd: {rmsd}",
            )
        logger.register_artifact("rmsd_xyz_path", run_dir)

    return {"sorted_rmsd": sorted_rows, "atom_type_accuracy": acc,
            "num_accepted": int(len(keep))}


def record_schedule(cfg: Config, trainer: Trainer, state, run_dir: str,
                    logger: Optional[RunLogger] = None):
    """alpha / sigma / SNR (+ gamma when learned) schedule figures
    (ref parts/def_for_main.py:8-60, main.py:324-337)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    logger = logger or RunLogger(run_dir)
    schedule = trainer.schedule_for(state.eval_params(cfg))
    t = np.arange(schedule.alphas.shape[0])
    alphas = np.asarray(schedule.alphas)
    sigmas = np.sqrt(np.clip(1 - alphas**2, 0, 1))
    curves = {
        "alpha": alphas,
        "sigma": sigmas,
        "SNR": (alphas**2) / np.maximum(sigmas**2, 1e-12),
    }
    if cfg.noise_schedule == "learned":
        gamma_params = state.eval_params(cfg)["gamma"]
        t_grid = jnp.linspace(0, 1, len(t))[:, None]
        curves["gamma"] = np.asarray(
            trainer.gamma.apply(gamma_params, t_grid)
        )[:, 0]
    paths = {}
    for name, y in curves.items():
        fig, ax = plt.subplots()
        ax.plot(t, y)
        ax.set_xlabel("t")
        ax.set_ylabel(name)
        if name == "SNR":
            ax.set_yscale("log")
        ax.set_title(name)
        paths[name] = logger.log_figure(name, fig)
        plt.close(fig)
    return paths
