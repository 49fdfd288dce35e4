"""Ring-sharded dense message passing (the ring-attention analogue).

For cells whose dense [N, N] pair tensor exceeds one chip, the node axis is
sharded over the mesh and the *source* node block rotates around the ring
with ``ppermute`` while each device accumulates partial message sums for its
resident *target* block — the EGNN equivalent of ring attention
(SURVEY.md §2.6: edge-block sharding with halo exchange over ICI).

This is the explicit-collective counterpart of the GSPMD node-sharding
layout in parallel/mesh.py: same math, but communication is hand-scheduled,
so per-step peak memory is O(N * N/D) per device instead of relying on the
compiler's choices.

Functional (parameter pytree in, arrays out); shares DiffusionDenoiser's
exact parameters.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from diffusion_model.config import Config
from diffusion_model.nn.egnn import _rbf_features
from diffusion_model.ops.com import remove_mean


def _dense(p, v, dt):
    return v @ p["kernel"].astype(dt) + p["bias"].astype(dt)


def _silu(v):
    return v * jax.nn.sigmoid(v)


def _psum_masked_mean(v, mask, axis):
    """Masked mean over the FULL (mesh-sharded) node axis.

    ``v [Nb, D]`` and ``mask [Nb]`` are the resident block; the sums are
    psum-reduced so every device holds the global mean — the collective
    counterpart of ops/com.masked_mean for a node-sharded graph.
    """
    m = mask.astype(v.dtype)[:, None]
    total = jax.lax.psum(jnp.sum(v * m, axis=0), axis)
    count = jax.lax.psum(jnp.sum(m), axis)
    return total / jnp.maximum(count, 1.0), count


def _vn_ring(lp, h_i, x_i, mask_i, axis, dt, hdim):
    """Virtual-node global channel over the sharded node axis.

    The ring counterpart of nn/egnn.py EGCL._virtual_channel: the pooled
    transform (a masked mean over ALL nodes) becomes one psum per layer —
    exactly the collective the ring already schedules for the CoM epilogue.
    Returns ``(vn_msg [Nb, m_out] dt, x_vn [Nb, 3] f32)``.
    """
    m3_f = mask_i[:, None].astype(jnp.float32)
    h_m = (h_i * mask_i[:, None].astype(h_i.dtype)).astype(dt)
    x_f = x_i.astype(jnp.float32)
    x_v, _ = _psum_masked_mean(x_f, mask_i, axis)         # [3] global CoM
    diff = (x_f - x_v[None, :]) * m3_f                    # [Nb, 3]
    r2_f = jnp.sum(diff * diff, axis=-1, keepdims=True)   # [Nb, 1]
    r2 = r2_f.astype(dt)

    # gather: nodes -> pooled virtual feature (masked mean of a transform)
    u = _silu(_dense(lp["vnode_in"], jnp.concatenate([h_m, r2], -1), dt))
    u = u * m3_f.astype(dt)
    mean_u, _ = _psum_masked_mean(u, mask_i.astype(u.dtype), axis)
    h_v = _silu(_dense(lp["vnode_pool"], mean_u[None, :], dt))  # [1, V]
    vdim = h_v.shape[-1]

    # scatter: fused [H+V+1, F] kernels (nn/egnn.py _GlobalFirstLayer
    # layout) — the graph-constant h_v block multiplies once and
    # broadcast-adds
    def global_first(p):
        k = p["kernel"].astype(dt)
        return (h_m @ k[:hdim] + h_v @ k[hdim:hdim + vdim]
                + r2 * k[hdim + vdim] + p["bias"].astype(dt))

    vn_msg = global_first(lp["vnode_out"]) * m3_f.astype(dt)
    s_v = (
        jnp.sum(_silu(global_first(lp["vnode_x"]))
                * lp["vnode_x_head"]["kernel"][:, 0].astype(dt),
                axis=-1, keepdims=True)
        + lp["vnode_x_head"]["bias"].astype(dt)
    )
    norm = jnp.sqrt(jnp.where(m3_f > 0, jnp.maximum(r2_f, 1e-12), 1.0))
    x_vn = diff * (s_v.astype(jnp.float32) / (norm + 1.0)) * m3_f
    return vn_msg, x_vn


def _egcl_ring(lp, h_i, x_i, mask_i, idx_i, n_total, axis, dt, hdim,
               h_residual=False, rbf=None, vn=None):
    """One EGCL over ring-rotated source blocks.

    Args (per device):
      h_i, x_i, mask_i: resident target block ``[Nb, ...]``.
      idx_i: ``[Nb]`` global node indices of the resident block.
      rbf: ``(num, rmax)`` to inject Gaussian radial-basis edge features
        through the zero-init ``rbf_m`` / ``rbf_x`` kernels (config.edge_rbf).
      vn: precomputed virtual-node channel ``(vn_msg, x_vn)`` from
        :func:`_vn_ring` (config.virtual_node).
    """
    m0k = lp["mlp_m_dense0"]["kernel"].astype(dt)
    m0b = lp["mlp_m_dense0"]["bias"].astype(dt)
    x0k = lp["mlp_x_dense0"]["kernel"].astype(dt)
    x0b = lp["mlp_x_dense0"]["bias"].astype(dt)
    rbf_m_k = lp["rbf_m"]["kernel"].astype(dt) if rbf else None
    rbf_x_k = lp["rbf_x"]["kernel"].astype(dt) if rbf else None

    h_c = h_i.astype(dt)
    # target-side projections (bias folded into the i-part)
    am_i = h_c @ m0k[:hdim] + m0b
    ax_i = h_c @ x0k[:hdim] + x0b
    # source-side projections for the resident block (they rotate)
    bm = h_c @ m0k[hdim : 2 * hdim]
    bx = h_c @ x0k[hdim : 2 * hdim]
    w_dm = m0k[2 * hdim]
    w_dx = x0k[2 * hdim]

    ndev = jax.lax.psum(1, axis)
    me = jax.lax.axis_index(axis)
    perm = [(d, (d + 1) % ndev) for d in range(ndev)]

    nb = h_i.shape[0]
    # accumulators must be marked device-varying over the mesh axis so the
    # scan carry type matches the ppermute-produced (varying) updates
    m_sum0 = jax.lax.pcast(
        jnp.zeros((nb, lp["mlp_m_dense1"]["kernel"].shape[1]), dt),
        (axis,), to="varying",
    )
    upd0 = jax.lax.pcast(
        jnp.zeros((nb, 3), jnp.float32), (axis,), to="varying"
    )

    def step(carry, _):
        bm_r, bx_r, x_r, mask_r, idx_r, m_sum, upd = carry
        # f32 geometry (see nn/egnn.py _dense_call): pair differences and
        # distances in float32; only the MLP feature copy casts to dt.
        diff = (x_i.astype(jnp.float32)[:, None, :]
                - x_r.astype(jnp.float32)[None, :, :])
        d2 = jnp.sum(diff * diff, axis=-1, keepdims=True)
        pm_b = (
            (mask_i[:, None, None] * mask_r[None, :, None]) > 0
        ) & (idx_i[:, None, None] != idx_r[None, :, None])
        pm = pm_b.astype(dt)

        pre_m = am_i[:, None, :] + bm_r[None, :, :] + d2.astype(dt) * w_dm
        pre_x = ax_i[:, None, :] + bx_r[None, :, :] + d2.astype(dt) * w_dx
        if rbf is not None:
            feats = _rbf_features(d2, pm_b, *rbf).astype(dt)
            pre_m = pre_m + feats @ rbf_m_k
            pre_x = pre_x + feats @ rbf_x_k
        m = _silu(_dense(lp["mlp_m_dense1"], _silu(pre_m), dt))
        att = jax.nn.sigmoid(
            jnp.sum(m * lp["attention_dense"]["kernel"][:, 0].astype(dt),
                    axis=-1, keepdims=True)
            + lp["attention_dense"]["bias"].astype(dt)
        )
        m_sum = m_sum + jnp.sum(m * att * pm, axis=1)

        u = _silu(_dense(lp["mlp_x_dense1"], _silu(pre_x), dt))
        s = (
            jnp.sum(u * lp["mlp_x_dense2"]["kernel"][:, 0].astype(dt),
                    axis=-1, keepdims=True)
            + lp["mlp_x_dense2"]["bias"].astype(dt)
        )
        norm = jnp.sqrt(jnp.where(pm > 0, jnp.maximum(d2, 1e-12), 1.0))
        upd = upd + jnp.sum(
            diff * (s.astype(jnp.float32) / (norm + 1.0))
            * pm.astype(jnp.float32), axis=1)

        # rotate the source block to the next device
        rot = lambda v: jax.lax.ppermute(v, axis, perm)
        return (rot(bm_r), rot(bx_r), rot(x_r), rot(mask_r), rot(idx_r),
                m_sum, upd), None

    carry = (bm, bx, x_i, mask_i, idx_i, m_sum0, upd0)
    (bm_r, bx_r, x_r, mask_r, idx_r, m_sum, upd), _ = jax.lax.scan(
        step, carry, None, length=ndev
    )

    if vn is not None:
        m_sum = m_sum + vn[0].astype(m_sum.dtype)
    h_new = _dense(
        lp["mlp_h_dense1"],
        _silu(_dense(lp["mlp_h_dense0"],
                     jnp.concatenate([h_c, m_sum], axis=-1), dt)),
        dt,
    )
    if h_residual and h_new.shape[-1] == h_c.shape[-1]:
        h_new = h_new + h_c
    x_new = x_i.astype(jnp.float32) + upd
    if vn is not None:
        x_new = x_new + vn[1]
    return h_new.astype(h_i.dtype), x_new.astype(x_i.dtype)


def ring_denoise_apply(cfg: Config, mesh: Mesh, axis: str = "data"):
    """Differentiable ring-sharded denoiser over one large graph.

    Returns ``fn(denoiser_params, species_ch [N,A], pos [N,3],
    spectrum [N,S], exo [N,1], t_norm [N,1], mask [N]) -> (eps_x, eps_h)``
    with all node-axis inputs sharded over ``axis`` and the parameter
    pytree replicated (``P()``). Taking the params as an argument (rather
    than closing over them as ``ring_denoise_fn`` does) makes the whole
    program differentiable w.r.t. the parameters: ``shard_map`` transposes
    the replicated-in broadcast to a ``psum`` of per-device parameter
    cotangents and ``ppermute`` to its inverse rotation, so
    ``jax.grad`` through the ring matches the dense oracle — the SP
    -analogue *training* path for cells too big for one chip's pair grid
    (SURVEY.md §2.6).
    """
    dt = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
    hdim = cfg.h_size
    ndev = mesh.devices.size

    def local_fn(variables, species_ch, pos, spectrum, exo, t_norm, mask,
                 idx):
        p = variables["params"]
        comp = p.get("spectrum_compressor")

        def compressor(spectrum):
            y = spectrum.astype(dt)
            i = 0
            while comp is not None and f"dense{i}" in comp:
                y = jax.nn.relu(_dense(comp[f"dense{i}"], y, dt))
                i += 1
            return _dense(comp["dense_out"], y, dt)

        feats = [species_ch.astype(dt)]
        if cfg.conditional:
            if cfg.to_compress_spectrum:
                feats.append(compressor(spectrum))
            else:
                feats.append(spectrum.astype(dt))
        if cfg.give_exO:
            feats.append(exo.astype(dt))
        if cfg.global_radius_feature:
            # psum prologue: the gated log-radius envelope feature
            # (nn/denoiser.py) needs the masked CoM of the FULL sharded
            # node set. Same math, one collective.
            m3 = mask[:, None].astype(pos.dtype)
            com, _ = _psum_masked_mean(pos, mask.astype(pos.dtype), axis)
            d2g = jnp.sum((pos - com[None, :]) ** 2, axis=-1,
                          keepdims=True)
            r = jnp.sqrt(jnp.maximum(d2g, 1e-12))
            gate = p["radius_feature_gate"].astype(pos.dtype)
            feats.append((jnp.log1p(r) * m3 * gate).astype(dt))
        feats.append(t_norm.astype(dt))
        h = jnp.concatenate(feats, axis=-1)

        rbf = (cfg.edge_rbf, cfg.edge_rbf_rmax) if cfg.edge_rbf else None
        x = pos
        for l in range(cfg.L):
            lp = p["egnn"][f"egcl_{l}"]
            vn = (_vn_ring(lp, h, x, mask, axis, dt, hdim)
                  if cfg.virtual_node else None)
            h, x = _egcl_ring(
                lp, h, x, mask, idx,
                n_total=None, axis=axis, dt=dt, hdim=hdim,
                h_residual=cfg.h_residual, rbf=rbf, vn=vn,
            )

        # CoM over the full (sharded) node set
        m3 = mask[:, None].astype(pos.dtype)
        delta = (x - pos) * m3
        total = jax.lax.psum(jnp.sum(delta, axis=0), axis)
        count = jax.lax.psum(jnp.sum(mask), axis)
        eps_x = (delta - total / jnp.maximum(count, 1.0)) * m3
        eps_h = h[:, : cfg.atom_type_size].astype(pos.dtype) * m3
        return eps_x, eps_h

    sharded = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(axis)),
        out_specs=(P(axis), P(axis)),
    )

    def fn(denoiser_params, species_ch, pos, spectrum, exo, t_norm, mask):
        n = pos.shape[0]
        if n % ndev != 0:
            raise ValueError(f"N={n} not divisible by mesh size {ndev}")
        idx = jnp.arange(n, dtype=jnp.int32)
        return sharded(denoiser_params, species_ch, pos, spectrum, exo,
                       t_norm, mask, idx)

    return fn


def ring_denoise_fn(cfg: Config, denoiser_params, mesh: Mesh,
                    axis: str = "data"):
    """Ring denoiser with the parameters baked in (inference closure over
    :func:`ring_denoise_apply` — the sampling-path surface)."""
    apply_fn = ring_denoise_apply(cfg, mesh, axis)

    def fn(species_ch, pos, spectrum, exo, t_norm, mask):
        return apply_fn(denoiser_params, species_ch, pos, spectrum, exo,
                        t_norm, mask)

    return fn


def ring_sampler_denoise_fn(cfg: Config, denoiser_params, mesh: Mesh,
                            axis: str = "data"):
    """Adapter from the ring denoiser to the scan sampler's contract.

    The sampler (diffusion/sampler.py) calls ``denoise_fn(species_ch, pos,
    spectrum, exo, t_norm, mask, edges)`` with batched ``[B, N, ...]``
    arrays; the ring runs ONE node-sharded graph. This adapter closes the
    VERDICT-r4 seam: with ``cfg.ring_sample`` the sampler passes
    ``edges=None`` (no ``[B, N, N]`` pair mask is ever built) and this fn
    squeezes the mandatory B=1 axis, runs the ppermute ring, and restores
    it — so the UNMODIFIED scan sampler (strided/DDIM/CFG/t=0 epilogue
    included) generates cells whose dense pair grid exceeds one chip
    (SURVEY.md §2.6; capability analogue of ref generate_amorphous.py).

    B=1 is enforced at trace time: one ring = one resident graph; a
    larger batch would silently average unrelated graphs' blocks.
    """
    if cfg.neighbor_k:
        raise ValueError(
            "ring_sample is the dense-topology scale-out; kNN cells "
            "(neighbor_k > 0) scale on one card — "
            "unset neighbor_k or ring_sample")
    apply_fn = ring_denoise_apply(cfg, mesh, axis)

    def fn(species_ch, pos, spectrum, exo, t_norm, mask, edges=None):
        del edges  # the ring materialises pair blocks on the fly
        if pos.shape[0] != 1:
            raise ValueError(
                f"ring sampling takes one node-sharded graph per call "
                f"(got batch_size={pos.shape[0]}); use api.generate_ring")
        eps_x, eps_h = apply_fn(denoiser_params, species_ch[0], pos[0],
                                spectrum[0], exo[0], t_norm[0], mask[0])
        return eps_x[None], eps_h[None]

    return fn
