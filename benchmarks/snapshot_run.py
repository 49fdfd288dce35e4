"""Snapshot a run dir's EVAL parameters to a portable .npz artifact.

Run dirs (checkpoints under runs/) are not committed, so quality
claims that rest on them lose their loadable artifacts when the run dir
goes. The flat npz
snapshot (train/checkpoint.save_params_npz, ~8 MB at the flagship size
in f16) is small enough to commit, and embeds the run config so it is
self-describing:

    python benchmarks/snapshot_run.py runs/q_predef_r5 \
        artifacts/q_predef_r5.npz

Restore path (tests/test_snapshot.py pins it):

    params = load_params_npz(path); cfg = load_config_npz(path)
    trainer = Trainer(cfg); state = trainer.init_state(key, batch)
    sample(trainer.denoise_fn(params), trainer.schedule_for(params),
           cfg, key, cond)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    from diffusion_model.utils import setup_compile_cache

    setup_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_dir")
    p.add_argument("out")
    p.add_argument("--dtype", default="float16")
    args = p.parse_args(argv)

    import jax

    from diffusion_model.data.split import batch_iterator
    from diffusion_model.data.synthetic import synthetic_sio2_dataset
    from diffusion_model.train import Trainer
    from diffusion_model.train.checkpoint import (
        latest_step,
        restore_checkpoint,
        save_params_npz,
    )
    from diffusion_model.utils.logging import load_run_config

    cfg = load_run_config(args.run_dir)
    trainer = Trainer(cfg)
    graphs = synthetic_sio2_dataset(0, cfg.batch_size, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size)
    batch = next(batch_iterator(graphs, cfg.batch_size, cfg.n_max))
    state = trainer.init_state(jax.random.key(0), batch)
    ckpt = os.path.join(os.path.abspath(args.run_dir), "checkpoints")
    step = latest_step(ckpt)
    state, _ = restore_checkpoint(ckpt, state, step=step)
    n = save_params_npz(state.eval_params(cfg), args.out,
                        dtype=args.dtype, cfg=cfg)
    size = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out}: {n} arrays, {size:.1f} MB "
          f"(step {step}, dtype {args.dtype})")


if __name__ == "__main__":
    main()
