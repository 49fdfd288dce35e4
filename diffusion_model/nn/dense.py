"""The two primitives every network in ``nn/`` is written with.

Parameters are plain nested dicts. A linear layer is ``{"kernel" [in, out],
"bias" [out]}`` (bias optional), the layout the committed checkpoints and
``parallel/ring.py`` read. Each named sub-layer draws its initial values from
``fold_in(key, crc32(name))``: adding or removing a sibling layer leaves every
other layer's draw unchanged, so zero-initialised optional channels
(``virtual_node``, ``edge_rbf``) keep an untrained network identical to the
plain one at the same key.
"""

from __future__ import annotations

import zlib

import jax
import jax.numpy as jnp


def dense(p, x, dtype=None):
    """``x @ kernel + bias`` with inputs and parameters cast to ``dtype``
    (default: the promoted type of ``x`` and the kernel)."""
    dt = dtype or jnp.result_type(x.dtype, p["kernel"].dtype)
    y = x.astype(dt) @ p["kernel"].astype(dt)
    if "bias" in p:
        y = y + p["bias"].astype(dt)
    return y


def init_dense(key, name: str, fan_in: int, features: int,
               scale: float = 1.0, bias: bool = True) -> dict:
    """Parameters of the linear layer ``name`` under ``key``.

    The kernel is ``variance_scaling(scale, "fan_in", "truncated_normal")``:
    ``scale=1`` is lecun-normal, ``scale=0`` a zero kernel. Biases start at
    zero. Returns ``{"kernel", "bias"}`` (``{"kernel"}`` with ``bias=False``).
    """
    k = subkey(key, name)
    if scale:
        kernel = jax.nn.initializers.variance_scaling(
            scale, "fan_in", "truncated_normal")(k, (fan_in, features))
    else:
        kernel = jnp.zeros((fan_in, features), jnp.float32)
    p = {"kernel": kernel}
    if bias:
        p["bias"] = jnp.zeros((features,), jnp.float32)
    return p


def subkey(key, name: str):
    """The key of the sub-layer ``name``: a fixed function of its name."""
    return jax.random.fold_in(key, zlib.crc32(name.encode()))
