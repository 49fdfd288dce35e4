"""E(3)-equivariant graph network as dense masked message passing.

Redesign of the reference EGCL/EquivariantGNN
(ref EquivariantGraphNeuralNetwork.py:6-88). Instead of PyG edge lists +
scatter kernels, graphs are padded ``[B, N, *]`` tensors and the fully
connected edge set is the dense ``[B, N, N]`` pair tensor — every MLP
becomes one large batched matmul and the scatter-sum becomes a masked
reduction over the source-node axis.

Message orientation matches the reference exactly: the reference uses PyG
``flow='target_to_source'`` over all ordered pairs (i, j), so node i
aggregates ``sum_j phi(h_i, h_j, |x_i - x_j|^2)``
(ref EquivariantGraphNeuralNetwork.py:10-11,55-65).

Layer semantics reproduced (ref :55-71):
  * edge MLP ``mlp_m``: Linear-SiLU-Linear-SiLU on [h_i | h_j | d2]
  * sigmoid attention gate applied on the h-branch only (the reference
    computes an ``attention`` flag for the x-branch but never uses it)
  * node MLP ``mlp_h``: Linear-SiLU-Linear on [h | sum_j m_ij]
  * coordinate MLP ``mlp_x``: Linear-SiLU-Linear-SiLU-Linear, scalar per
    edge, producing ``x_i += sum_j (x_i - x_j) * s_ij / (norm + 1)``.

Node-projection decomposition: the first Linear of an edge MLP applied to
``[h_i | h_j | d2]`` is algebraically

    W [h_i | h_j | d2] + b = (W_i h_i) + (W_j h_j) + w_d * d2 + b

so the two H-wide blocks are computed per *node* (O(N) matmuls) and
broadcast-added over the pair grid, instead of per *edge* (O(N^2) matmuls
over a 2H+1-wide input). Identical math and identical parameter shapes —
the kernel is stored exactly as the fused ``[2H+1, F]`` matrix.

The coordinate-update divisor has a ``compat_scalar_norm`` switch: the
reference divides by a *single Frobenius norm over the whole edge batch*
(``torch.norm(coords_i - coords_j)`` without dim=, ref :64). Default is the
correct per-edge norm; the compat flag reproduces the reference bit-for-bit
for validation.

Parameters are nested dicts (``nn/dense.py``); ``init(key, *args)`` returns
``{"params": tree}`` and ``apply(variables, *args)`` runs the layer.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from diffusion_model.nn.dense import dense, init_dense, subkey
from diffusion_model.ops.angles import pairwise_sq_dist


def _edge_first(p, h, hdim, dt):
    """First Linear of an edge MLP, evaluated via node projections.

    ``p`` is the fused ``kernel [2H+1, F]`` / ``bias [F]`` (the layout a
    naive Dense over the concatenated edge feature would have). Returns
    ``(proj_i + bias [B,N,F], proj_j [B,N,F], d2_row [F])``.
    """
    k = p["kernel"].astype(dt)
    h = h.astype(dt)
    return (h @ k[:hdim] + p["bias"].astype(dt), h @ k[hdim:2 * hdim],
            k[2 * hdim])


def _global_first(p, h, h_v, r2, hdim, dt):
    """Dense over ``[h | h_v | r2]`` with the graph-constant ``h_v`` block
    projected once per graph.

    ``p`` is the fused ``kernel [H + V + 1, F]`` / ``bias [F]`` a plain
    Dense over the concatenation would have; the ``h_v`` rows multiply the
    ``[B, 1, V]`` vector and broadcast-add instead of re-multiplying the
    identical vector for all N nodes.
    """
    vdim = h_v.shape[-1]
    k = p["kernel"].astype(dt)
    return (
        h.astype(dt) @ k[:hdim]
        + h_v.astype(dt) @ k[hdim:hdim + vdim]
        + r2.astype(dt) * k[hdim + vdim]
        + p["bias"].astype(dt)
    )


def _vector_head(p, v):
    """Dense(features=1) as a multiply-reduce (kernel ``[F, 1]``, bias
    ``[1]``): a width-1 matmul output would waste a full matrix tile."""
    w = p["kernel"][:, 0].astype(v.dtype)
    return jnp.sum(v * w, axis=-1, keepdims=True) + p["bias"].astype(v.dtype)


def _rbf_features(d2_f, valid, num, rmax):
    """Gaussian radial basis of the edge distance, ``[..., num]`` float32.

    ``d2_f`` is the squared distance (float32), ``valid`` a boolean mask of
    real edges. The sqrt is guarded under the mask (d2 == 0 on padded/
    diagonal pairs has an infinite sqrt-gradient; 0 * inf = NaN would
    poison the backward pass — same safe-where pattern as the coordinate
    norm). Centers are ``linspace(0, rmax, num)``, width = center spacing.
    """
    d = jnp.sqrt(jnp.where(valid, jnp.maximum(d2_f, 1e-12), 1.0))
    d = jnp.where(valid, d, 0.0)
    centers = jnp.linspace(0.0, rmax, num, dtype=jnp.float32)
    width = rmax / (num - 1)
    z = (d - centers) / width
    return jnp.exp(-0.5 * z * z)


@dataclasses.dataclass(frozen=True)
class EGCL:
    """One equivariant graph convolution layer (dense, masked)."""

    m_hidden: int
    m_out: int
    x_hidden: int
    h_hidden: int
    h_out: int
    compat_scalar_norm: bool = False
    compute_dtype: jnp.dtype = jnp.float32
    zero_init_x: bool = True
    h_init_scale: float = 1.0
    h_residual: bool = False
    virtual_node: bool = False
    edge_rbf: int = 0
    edge_rbf_rmax: float = 8.0
    # ``edge_rbf`` (config.edge_rbf): K Gaussian radial-basis features of
    # the edge distance, injected into BOTH edge-MLP pre-activations
    # (message and coordinate branches) through separate bias-free
    # ZERO-initialised kernels ``rbf_m [K, m_hidden]`` / ``rbf_x
    # [K, x_hidden]`` — enabling the flag leaves the untrained network
    # bit-identical to the plain one, and the load-bearing fused
    # ``[2H+1, F]`` first-layer kernels are untouched. The reference's
    # only edge-geometry input is the squared distance (ref
    # EquivariantGraphNeuralNetwork.py:55-58); the RBF code gives the MLPs
    # sharp sensitivity at the ~0.1 A bond-length scale.
    # ``virtual_node`` adds a global context channel per layer (retrieved
    # technique: "Fast and Distributed Equivariant GNNs by Virtual Node
    # Learning", PAPERS.md): every node exchanges one extra message with a
    # virtual node sitting at the masked CoM whose feature is a pooled
    # transform of all node features. With kNN edges a node's receptive
    # field is ~L hops of local neighbourhoods — the score cannot
    # coordinate the GLOBAL density envelope / mid-range order of a large
    # cell; the virtual node restores O(1)-hop global communication at
    # O(N) cost. E(3)-correct: the h channel uses only invariants
    # (features, |x_i - x_v|^2), the coordinate update moves nodes along
    # (x_i - x_v) — equivariant because x_v is the masked CoM. Both output
    # heads are ZERO-initialised so enabling the flag leaves the untrained
    # network bit-identical to the plain one (globally-coherent features
    # otherwise re-ignite the ~K-per-layer init blowup, see
    # radius_feature_gate in nn/denoiser.py). Requires ``node_mask``.
    # ``h_residual`` switches the node update to ``h + mlp_h(...)`` when
    # input/output widths match (config.h_residual — conditioning fix for
    # the reference's non-residual update; False = exact reference form).
    # ``h_init_scale`` damps the variance of the node-MLP output kernel
    # (``mlp_h_dense1``) at initialisation. The reference h update is
    # non-residual (``updated_h = mlp_h([h | sum_j m_ij])``, ref
    # EquivariantGraphNeuralNetwork.py:68-69) and the attention-gated SiLU
    # messages are non-negative-biased, so the masked sum over K neighbours
    # adds coherently: at random init ``|h|`` grows ~0.2*K per layer
    # (1e6+ after 5 layers at K=192 dense; repeated first-step NaN at
    # 512-atom kNN-32). Setting the variance multiplier to ~1/K^2 holds
    # the init-time feature scale flat across layers. 1.0 is the default
    # lecun-normal law and the trained model family is unchanged either
    # way — this moves only the starting point.
    # ``zero_init_x`` zero-initialises the final coordinate-MLP layer so an
    # untrained network is the identity on positions. The reference instead
    # relies on a runtime NaN-retry loop to survive early-training reverse
    # chains (ref parts/train_per_iretation.py:376-389); zero output init is
    # the standard diffusion-model fix and changes nothing once trained.

    def _check(self, node_mask):
        # degenerate configs: num=1 makes the width rmax/(num-1) a
        # ZeroDivisionError at trace time; rmax <= 0 a zero/negative
        # width (NaN features). Reject both with a readable error.
        if self.edge_rbf:
            if self.edge_rbf < 2:
                raise ValueError(
                    f"edge_rbf={self.edge_rbf}: need >= 2 Gaussian centers "
                    "(width = rmax/(num-1)); use 0 to disable")
            if not self.edge_rbf_rmax > 0:
                raise ValueError(
                    f"edge_rbf_rmax={self.edge_rbf_rmax} must be > 0")
        if self.virtual_node and node_mask is None:
            raise ValueError("virtual_node=True requires node_mask")

    def init_params(self, key, hdim: int) -> dict:
        """Parameter tree of a layer whose input features are ``hdim``
        wide."""
        fm, fx, mo = self.m_hidden, self.x_hidden, self.m_out
        p = {
            "mlp_m_dense0": init_dense(key, "mlp_m_dense0", 2 * hdim + 1, fm),
            "mlp_m_dense1": init_dense(key, "mlp_m_dense1", fm, mo),
            "attention_dense": init_dense(key, "attention_dense", mo, 1),
            "mlp_x_dense0": init_dense(key, "mlp_x_dense0", 2 * hdim + 1, fx),
            "mlp_x_dense1": init_dense(key, "mlp_x_dense1", fx, fx),
            "mlp_x_dense2": init_dense(key, "mlp_x_dense2", fx, 1,
                                       scale=0.0 if self.zero_init_x
                                       else 1.0),
            "mlp_h_dense0": init_dense(key, "mlp_h_dense0", hdim + mo,
                                       self.h_hidden),
            "mlp_h_dense1": init_dense(key, "mlp_h_dense1", self.h_hidden,
                                       self.h_out, scale=self.h_init_scale),
        }
        if self.edge_rbf:
            p["rbf_m"] = init_dense(key, "rbf_m", self.edge_rbf, fm,
                                    scale=0.0, bias=False)
            p["rbf_x"] = init_dense(key, "rbf_x", self.edge_rbf, fx,
                                    scale=0.0, bias=False)
        if self.virtual_node:
            p["vnode_in"] = init_dense(key, "vnode_in", hdim + 1, fm)
            p["vnode_pool"] = init_dense(key, "vnode_pool", fm, mo)
            p["vnode_out"] = init_dense(key, "vnode_out", hdim + mo + 1, mo,
                                        scale=0.0)
            p["vnode_x"] = init_dense(key, "vnode_x", hdim + mo + 1, fx)
            p["vnode_x_head"] = init_dense(key, "vnode_x_head", fx, 1,
                                           scale=0.0)
        return p

    def init(self, key, h, x, edges, node_mask=None) -> dict:
        self._check(node_mask)
        return {"params": self.init_params(key, h.shape[-1])}

    def apply(self, variables, h, x, edges, node_mask=None):
        """Apply the layer.

        Args:
          variables: ``{"params": tree}`` from :meth:`init`.
          h: ``[B, N, H]`` node features.
          x: ``[B, N, 3]`` coordinates.
          edges: either a dense ``[B, N, N]`` pair mask (fully connected
            graphs, the reference topology) or a tuple
            ``(idx [B, N, K] int32, edge_mask [B, N, K])`` of fixed-degree
            neighbour lists — the padded large-cell topology (SURVEY.md §7:
            N^2 edges explode past ~1024 atoms).
          node_mask: ``[B, N]`` real-node mask; required (and used) only by
            the ``virtual_node`` channel.

        Returns:
          (h', x') with the same shapes; padded nodes pass through unchanged
          in ``x`` and produce zero-masked ``h`` updates.
        """
        self._check(node_mask)
        return self.forward(variables["params"], h, x, edges, node_mask)

    def forward(self, p, h, x, edges, node_mask=None):
        """:meth:`apply` over the bare parameter tree."""
        vn = None
        if self.virtual_node:
            vn = self._virtual_channel(p, h, x, node_mask)
        if isinstance(edges, tuple):
            return self._sparse_call(p, h, x, *edges, vn=vn)
        return self._dense_call(p, h, x, edges, vn=vn)

    def _virtual_channel(self, p, h, x, node_mask):
        """Global-context messages through a virtual node at the masked CoM.

        Returns ``(vn_msg [B,N,m_out], x_vn [B,N,3] float32)`` — the h-sum
        contribution (added to the neighbour message sum, so it flows
        through ``mlp_h`` without changing its width/params) and the
        equivariant radial coordinate update. Both heads are zero-init:
        exact no-op at initialisation.
        """
        from diffusion_model.ops.com import masked_mean

        dt = self.compute_dtype
        hdim = h.shape[-1]
        m3 = node_mask[..., None].astype(jnp.float32)
        h_c = (h * node_mask[..., None].astype(h.dtype)).astype(dt)
        x_f = x.astype(jnp.float32)
        x_v = masked_mean(x_f, node_mask)                        # [B,1,3]
        diff = (x_f - x_v) * m3                                  # [B,N,3]
        r2_f = jnp.sum(diff * diff, axis=-1, keepdims=True)      # [B,N,1]
        r2 = r2_f.astype(dt)

        # gather: nodes -> virtual feature (masked mean of a transform)
        u = jax.nn.silu(dense(p["vnode_in"],
                              jnp.concatenate([h_c, r2], axis=-1), dt))
        u = u * m3.astype(dt)
        h_v = jax.nn.silu(dense(p["vnode_pool"], masked_mean(u, node_mask),
                                dt))                             # [B,1,m_out]

        # scatter: virtual -> per-node message and radial coordinate
        # update. The h_v block of the fused [H+V+1, F] first layers is
        # graph-constant — projected once at [B,1,F] and broadcast-added.
        vn_msg = _global_first(p["vnode_out"], h_c, h_v, r2, hdim, dt) \
            * m3.astype(dt)
        s_v = _vector_head(
            p["vnode_x_head"],
            jax.nn.silu(_global_first(p["vnode_x"], h_c, h_v, r2, hdim, dt)),
        )
        norm = jnp.sqrt(jnp.where(m3 > 0, jnp.maximum(r2_f, 1e-12), 1.0))
        x_vn = diff * (s_v.astype(jnp.float32) / (norm + 1.0)) * m3
        return vn_msg, x_vn

    def _node_update(self, p, h_c, m_sum, vn):
        dt = self.compute_dtype
        if vn is not None:
            m_sum = m_sum + vn[0].astype(m_sum.dtype)
        h_new = dense(p["mlp_h_dense1"], jax.nn.silu(dense(
            p["mlp_h_dense0"], jnp.concatenate([h_c, m_sum], axis=-1), dt)),
            dt)
        if self.h_residual and h_new.shape[-1] == h_c.shape[-1]:
            h_new = h_new + h_c
        return h_new

    def _dense_call(self, p, h, x, pair_mask, vn=None):
        dt = self.compute_dtype
        hdim = h.shape[-1]
        h_c = h.astype(dt)
        # Geometry stays float32 regardless of compute_dtype: at large-cell
        # scale (|x| ~ 12 A for 512-atom cells) bfloat16 coordinate
        # rounding is ~0.05 A — the size of a Si-O bond-length error — so
        # pair distances, norms and the coordinate update run in f32; only
        # the MLP *feature* copy of d2 is cast down. The matmuls (where the
        # FLOPs are) stay in compute_dtype.
        x_f = x.astype(jnp.float32)
        d2_f = pairwise_sq_dist(x_f)[..., None]          # [B,N,N,1] f32
        d2 = d2_f.astype(dt)
        pm = pair_mask[..., None].astype(dt)
        pm_f = pair_mask[..., None].astype(jnp.float32)

        m_i, m_j, m_d = _edge_first(p["mlp_m_dense0"], h_c, hdim, dt)
        x_i, x_j, x_d = _edge_first(p["mlp_x_dense0"], h_c, hdim, dt)
        pre_m = m_i[:, :, None, :] + m_j[:, None, :, :] + d2 * m_d
        pre_x = x_i[:, :, None, :] + x_j[:, None, :, :] + d2 * x_d
        if self.edge_rbf:
            rbf = _rbf_features(d2_f, pm_f > 0, self.edge_rbf,
                                self.edge_rbf_rmax).astype(dt)
            pre_m = pre_m + dense(p["rbf_m"], rbf, dt)
            pre_x = pre_x + dense(p["rbf_x"], rbf, dt)

        # h-branch: edge messages, attention gate, masked sum over sources j.
        m = jax.nn.silu(dense(p["mlp_m_dense1"], jax.nn.silu(pre_m), dt))
        m = m * jax.nn.sigmoid(_vector_head(p["attention_dense"], m))
        m = m * pm
        m_sum = jnp.sum(m, axis=2)                        # [B,N,m_out]
        h_new = self._node_update(p, h_c, m_sum, vn)

        # x-branch: scalar weight per edge, equivariant difference update.
        s = _vector_head(p["mlp_x_dense2"], jax.nn.silu(
            dense(p["mlp_x_dense1"], jax.nn.silu(pre_x), dt)))
        if self.compat_scalar_norm:
            # Frobenius norm over the whole (masked) edge batch, as in
            # ref EquivariantGraphNeuralNetwork.py:64.
            norm = jnp.sqrt(
                jnp.sum(d2_f[..., 0] * pair_mask.astype(jnp.float32),
                        axis=(-1, -2))
            )[..., None, None, None]
        else:
            # safe sqrt: masked (diagonal/padded) pairs have d2 == 0 whose
            # sqrt-gradient is inf; 0*inf = NaN would poison the backward
            # pass through the mask multiply, so substitute 1 under the mask.
            pmb = pm_f > 0
            norm = jnp.sqrt(jnp.where(pmb, jnp.maximum(d2_f, 1e-12), 1.0))
        # sum_j (x_i - x_j) w_ij  ==  x_i * sum_j w_ij  -  (w @ x): the
        # decomposed form never materialises the [B,N,N,3] difference
        # tensor — the j-reduction becomes one [N,N]x[N,3] matmul.
        w = (s.astype(jnp.float32) / (norm + 1.0)) * pm_f  # [B,N,N,1]
        w_sum = jnp.sum(w, axis=2)                         # [B,N,1]
        x_new = x_f + x_f * w_sum - jnp.einsum(
            "bij,bjc->bic", w[..., 0], x_f)
        if vn is not None:
            x_new = x_new + vn[1]

        return h_new.astype(h.dtype), x_new.astype(x.dtype)

    def _sparse_call(self, p, h, x, idx, edge_mask, vn=None):
        """Fixed-degree neighbour-list message passing: identical math to
        the dense path over the K gathered sources per node. The first-layer
        node-projection trick applies unchanged — the j-projections are
        computed per node then gathered per edge."""
        if self.compat_scalar_norm:
            raise NotImplementedError(
                "compat_scalar_norm is a dense-path-only validation mode"
            )
        dt = self.compute_dtype
        hdim = h.shape[-1]
        h_c = h.astype(dt)
        # f32 geometry (see _dense_call): diff/d2/norm/update in float32,
        # MLP feature copy of d2 cast to compute_dtype.
        x_f = x.astype(jnp.float32)

        gather = jax.vmap(lambda arr, ind: arr[ind])   # [N,*] , [N,K] -> [N,K,*]
        x_j = gather(x_f, idx)                          # [B,N,K,3]
        diff = x_f[:, :, None, :] - x_j
        d2 = jnp.sum(diff * diff, axis=-1, keepdims=True)  # [B,N,K,1] f32
        em = edge_mask[..., None].astype(dt)
        em_f = edge_mask[..., None].astype(jnp.float32)

        # first layers via node projections + gather (no [.,2H+1] matmuls)
        m_i, m_j, m_d = _edge_first(p["mlp_m_dense0"], h_c, hdim, dt)
        x_i, x_j_proj, x_d = _edge_first(p["mlp_x_dense0"], h_c, hdim, dt)
        pre_m = m_i[:, :, None, :] + gather(m_j, idx) + d2.astype(dt) * m_d
        pre_x = (x_i[:, :, None, :] + gather(x_j_proj, idx)
                 + d2.astype(dt) * x_d)
        if self.edge_rbf:
            rbf = _rbf_features(d2, em_f > 0, self.edge_rbf,
                                self.edge_rbf_rmax).astype(dt)
            pre_m = pre_m + dense(p["rbf_m"], rbf, dt)
            pre_x = pre_x + dense(p["rbf_x"], rbf, dt)

        m = jax.nn.silu(dense(p["mlp_m_dense1"], jax.nn.silu(pre_m), dt))
        m = m * jax.nn.sigmoid(_vector_head(p["attention_dense"], m)) * em
        m_sum = jnp.sum(m, axis=2)
        h_new = self._node_update(p, h_c, m_sum, vn)

        s = _vector_head(p["mlp_x_dense2"], jax.nn.silu(
            dense(p["mlp_x_dense1"], jax.nn.silu(pre_x), dt)))
        norm = jnp.sqrt(jnp.where(em_f > 0, jnp.maximum(d2, 1e-12), 1.0))
        upd = diff * (s.astype(jnp.float32) / (norm + 1.0)) * em_f
        x_new = x_f + jnp.sum(upd, axis=2)
        if vn is not None:
            x_new = x_new + vn[1]
        return h_new.astype(h.dtype), x_new.astype(x.dtype)


@dataclasses.dataclass(frozen=True)
class EquivariantGNN:
    """Stack of L EGCLs (ref EquivariantGraphNeuralNetwork.py:73-88)."""

    L: int
    m_hidden: int
    m_out: int
    x_hidden: int
    h_hidden: int
    h_out: int
    compat_scalar_norm: bool = False
    compute_dtype: jnp.dtype = jnp.float32
    zero_init_x: bool = True
    h_init_scale: float = 1.0
    h_residual: bool = False
    virtual_node: bool = False
    edge_rbf: int = 0
    edge_rbf_rmax: float = 8.0
    remat_egcl: bool = False
    # Rematerialise each layer under grad (config.remat_egcl): the live
    # activation set drops from L layers to ~1 at the cost of one extra
    # forward per layer on the backward pass. The parameter tree is the
    # same either way, so checkpoints and the ring path are unaffected.

    @property
    def layer(self) -> EGCL:
        kw = {f.name: getattr(self, f.name)
              for f in dataclasses.fields(EGCL)}
        return EGCL(**kw)

    def init_params(self, key, hdim: int) -> dict:
        layer = self.layer
        return {
            f"egcl_{l}": layer.init_params(subkey(key, f"egcl_{l}"),
                                           hdim if l == 0 else self.h_out)
            for l in range(self.L)
        }

    def init(self, key, h, x, edges, node_mask=None) -> dict:
        self.layer._check(node_mask)
        return {"params": self.init_params(key, h.shape[-1])}

    def apply(self, variables, h, x, edges, node_mask=None):
        self.layer._check(node_mask)
        return self.forward(variables["params"], h, x, edges, node_mask)

    def forward(self, p, h, x, edges, node_mask=None):
        layer_fn = self.layer.forward
        if self.remat_egcl:
            layer_fn = jax.checkpoint(layer_fn)
        for l in range(self.L):
            h, x = layer_fn(p[f"egcl_{l}"], h, x, edges, node_mask)
        return h, x
