"""Ahead-of-time serving export: the trained sampler as one StableHLO blob.

The reference's only deployment story is "clone the repo, load the .pth,
re-run the Python loop" (ref generate_amorphous.py:25-147). Here the whole
reverse-diffusion program — parameters baked in as constants, the T-step
scan, the t=0 epilogue, species argmax and acceptance filter — is exported
with ``jax.export`` into a single serialized artifact that a serving process
can deserialize and call WITHOUT the model code, config system, or
checkpoint machinery. Shapes are static per export (batch, n_max fixed),
which is the serving contract an accelerator fleet wants: one compiled
program per shape bucket, no tracing at request time.

Artifact layout: ``<path>`` is the exported program's StableHLO bytecode;
``<path>.json`` is a sidecar with the shape/step metadata a router needs
and, under ``"exported"``, the calling signature that rebuilds the
``jax.export.Exported`` around the bytecode. (JAX's own ``serialize`` needs
the ``flatbuffers`` package, which a serving host need not have.)
"""

from __future__ import annotations

import json
import os
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from diffusion_model.config import Config
from diffusion_model.data.batch import GraphBatch


def _sampler_fn(cfg: Config, denoise_fn: Callable, schedule,
                retry_rounds: int = 0) -> Callable:
    """(seed, spectrum [B,N,S], exo [B,N,1], mask [B,N], species [B,N,A]) ->
    (pos, species, accepted).

    ``species`` is the condition's one-hots: ignored when
    ``cfg.diffuse_species`` (the chain samples species itself) but the
    fixed species channel for position-only configs
    (``diffuse_species=False``, ref E3diffusion_new.py) — a router serving
    those passes the requested composition.

    ``retry_rounds > 0`` compiles the reference's host-level NaN/1000 A
    redraw loop (ref parts/train_per_iretation.py:376-436) INTO the
    artifact as a bounded ``lax.while_loop``: rejected batch entries are
    re-drawn with fresh fold_in keys, successes kept, until all are
    accepted or the bound is hit. Entries still rejected after the bound
    surface as ``accepted=False`` — the caller's redraw contract then only
    covers that residue. The first draw uses ``PRNGKey(seed)`` exactly as
    the retry-free program does, so round 0 stays bit-identical to the
    live sampler.
    """
    from diffusion_model.diffusion import sample

    def fn(seed, spectrum, exo, mask, species):
        b, n = mask.shape
        cond = GraphBatch(
            pos=jnp.zeros((b, n, 3), spectrum.dtype),
            species=species,
            spectrum=spectrum,
            exo=exo,
            mask=mask,
        )
        base = jax.random.PRNGKey(seed)
        if not retry_rounds:
            res = sample(denoise_fn, schedule, cfg, base, cond)
            return res.pos, res.species, res.accepted

        # ONE trace of the reverse-diffusion program: round 0 runs inside
        # the while_loop too (key selected between the base key and the
        # fold_in retry stream), instead of tracing `sample` once outside
        # and again in the body — which doubled the exported HLO and its
        # compile time. Round 0 stays bit-identical to the
        # retry-free program: same base key, and the (i == 0) take keeps
        # every row of the first draw (rejected rows then carry their
        # first-draw values, as before).
        def cond_fn(carry):
            i, pos, sp, acc = carry
            return (i < retry_rounds + 1) & ~jnp.all(acc)

        def body_fn(carry):
            i, pos, sp, acc = carry
            key = jnp.where(i == 0, base, jax.random.fold_in(base, i))
            r = sample(denoise_fn, schedule, cfg, key, cond)
            take = (((~acc) & r.accepted) | (i == 0))[:, None, None]
            return (
                i + 1,
                jnp.where(take, r.pos, pos),
                jnp.where(take, r.species, sp),
                acc | r.accepted,
            )

        _, pos, sp, acc = jax.lax.while_loop(
            cond_fn, body_fn,
            (
                jnp.zeros((), jnp.int32),
                jnp.zeros((b, n, 3), spectrum.dtype),
                jnp.zeros_like(species),
                jnp.zeros((b,), bool),
            ),
        )
        return pos, sp, acc

    return fn


def export_sampler(cfg: Config, trainer, state, path: str,
                   batch_size: int, platforms=("cpu", "cuda"),
                   retry_rounds: int = 0,
                   acceptance_stats: dict | None = None) -> None:
    """Serialize the trained sampler for ``batch_size`` conditions of
    ``cfg.n_max`` atoms into ``path`` (+ ``path.json`` metadata sidecar).

    ``platforms``: lowering targets; the artifact runs on any of them.
    ``retry_rounds``: bake a bounded in-graph redraw loop into the artifact
    (see ``_sampler_fn``); 0 exports the raw single-draw program whose
    rejects the caller must redraw.
    ``acceptance_stats``: optional measured acceptance numbers (e.g. from
    ``cli.export --calibrate``) recorded verbatim in the sidecar so a
    serving operator can size the redraw budget.
    """
    params = state.eval_params(cfg)
    denoise_fn = trainer.denoise_fn(params)
    schedule = trainer.schedule_for(params)
    fn = _sampler_fn(cfg, denoise_fn, schedule, retry_rounds=retry_rounds)

    b, n, s = batch_size, cfg.n_max, cfg.spectrum_size
    args = (
        jax.ShapeDtypeStruct((), jnp.uint32),
        jax.ShapeDtypeStruct((b, n, s), jnp.float32),
        jax.ShapeDtypeStruct((b, n, 1), jnp.float32),
        jax.ShapeDtypeStruct((b, n), jnp.float32),
        jax.ShapeDtypeStruct((b, n, cfg.atom_type_size), jnp.float32),
    )
    exp = jax.export.export(jax.jit(fn), platforms=list(platforms))(*args)
    with open(path, "wb") as f:
        f.write(exp.mlir_module_serialized)
    meta = {
        "batch_size": b,
        "n_max": n,
        "spectrum_size": s,
        "atom_type_size": cfg.atom_type_size,
        "num_diffusion_timestep": cfg.num_diffusion_timestep,
        "sample_steps": cfg.sample_steps,
        "deterministic_sampling": cfg.deterministic_sampling,
        "platforms": list(platforms),
        "diffuse_species": cfg.diffuse_species,
        "inputs": "seed:u32[], spectrum:f32[B,N,S], exo:f32[B,N,1], "
                  "mask:f32[B,N], species:f32[B,N,A] (condition one-hots; "
                  "ignored when diffuse_species)",
        "outputs": "pos:f32[B,N,3], species:f32[B,N,A], accepted:bool[B]",
        # Acceptance contract: the sampler can reject a draw (NaN or
        # coords > 1000 A, ref parts/train_per_iretation.py:376-436).
        # With in_graph_retry_rounds == 0 the CALLER owns the redraw loop
        # (re-call with a fresh seed for accepted=False rows); with
        # rounds > 0 the artifact redraws internally and only
        # budget-exhausted rows surface as rejected.
        "in_graph_retry_rounds": retry_rounds,
        "exported": exported_signature(exp),
    }
    if acceptance_stats:
        meta["acceptance"] = acceptance_stats
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)


def exported_signature(exp) -> dict:
    """What, beside its bytecode, rebuilds a single-device ``Exported``."""
    if exp.nr_devices != 1 or exp.ordered_effects or exp.unordered_effects:
        raise ValueError("only single-device exports without effects are "
                         "stored as sampler artifacts")
    avals = lambda xs: [[list(a.shape), str(a.dtype)] for a in xs]
    return {
        "fun_name": exp.fun_name,
        "in_avals": avals(exp.in_avals),
        "out_avals": avals(exp.out_avals),
        "platforms": list(exp.platforms),
        "calling_convention_version": exp.calling_convention_version,
        "module_kept_var_idx": list(exp.module_kept_var_idx),
        "uses_global_constants": exp.uses_global_constants,
    }


def load_exported(bytecode: bytes, sig: dict):
    """The ``Exported`` of a flat-argument function returning a tuple, from
    its StableHLO bytecode and :func:`exported_signature`."""
    aval = lambda a: jax.core.ShapedArray(tuple(a[0]), np.dtype(a[1]))
    in_avals = tuple(map(aval, sig["in_avals"]))
    out_avals = tuple(map(aval, sig["out_avals"]))
    none_in, none_out = (None,) * len(in_avals), (None,) * len(out_avals)
    return jax.export.Exported(
        fun_name=sig["fun_name"],
        in_tree=jax.tree.structure((in_avals, {})),
        in_avals=in_avals,
        out_tree=jax.tree.structure(out_avals),
        out_avals=out_avals,
        _has_named_shardings=True,
        _in_named_shardings=none_in,
        _out_named_shardings=none_out,
        in_shardings_hlo=none_in,
        out_shardings_hlo=none_out,
        nr_devices=1,
        platforms=tuple(sig["platforms"]),
        ordered_effects=(),
        unordered_effects=(),
        disabled_safety_checks=(),
        mlir_module_serialized=bytecode,
        calling_convention_version=sig["calling_convention_version"],
        module_kept_var_idx=tuple(sig["module_kept_var_idx"]),
        uses_global_constants=sig["uses_global_constants"],
        _get_vjp=None,
    )


class ServedSampler:
    """Deserialized sampler — model-code-free inference endpoint."""

    def __init__(self, path: str):
        with open(path + ".json") as f:
            self.meta = json.load(f)
        with open(path, "rb") as f:
            self._exported = load_exported(f.read(), self.meta["exported"])

    def __call__(self, seed: int, spectrum, exo, mask, species=None):
        args = [
            jnp.asarray(seed, jnp.uint32),
            jnp.asarray(spectrum, jnp.float32),
            jnp.asarray(exo, jnp.float32),
            jnp.asarray(mask, jnp.float32),
        ]
        # artifacts exported before the species input existed take 4 args
        takes_species = len(self._exported.in_avals) > 4
        if takes_species:
            if species is None:
                if not self.meta.get("diffuse_species", True):
                    raise ValueError(
                        "this artifact was exported from a position-only "
                        "(diffuse_species=False) model: the fixed species "
                        "one-hots must be supplied per request"
                    )
                b, n = np.asarray(mask).shape
                species = np.zeros((b, n, self.meta["atom_type_size"]),
                                   np.float32)
            args.append(jnp.asarray(species, jnp.float32))
        elif species is not None:
            raise ValueError(
                "this artifact predates the species input and cannot take "
                "a requested composition — re-export with cli/export"
            )
        pos, species, accepted = self._exported.call(*args)
        return np.asarray(pos), np.asarray(species), np.asarray(accepted)
