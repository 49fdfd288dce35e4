"""Device mesh + sharding layout for data-parallel training and sharded
generation.

The reference is strictly single-GPU with batch_size=1 (SURVEY.md §2.6 —
no torch.distributed/NCCL anywhere), so this layer is new capability, built
the XLA way: annotate shardings on a ``jax.sharding.Mesh`` and let GSPMD
insert the collectives (grad all-reduce for DP; all-gathers for the
node-sharded message-passing path used by 1024+-atom cells — the
ring-attention analogue for dense EGNN, SURVEY.md §2.6).

Strategies:
  * DP   — shard the graph-batch axis over ``data``; parameters replicated;
           gradient psum inserted by XLA from the sharded loss.
  * SP-analogue (graph/node sharding) — for one huge graph, shard the
    *target-node* axis of ``[B, N, ...]`` tensors; the ``[B, N, N]`` pair
    tensor is then row-sharded and XLA all-gathers the (small) source-node
    features.
  * TP/PP/EP — not applicable at this model scale (documented in SURVEY.md
    §2.6); the 1024-wide MLPs fit one card many times over.
  * Multi-slice (DCN) — ``make_hybrid_mesh`` builds a ("replica", "data")
    mesh: DP over both axes (hierarchical all-reduce) or batch-over-DCN +
    nodes-over-ICI (mode="dp_node") so the heavy all-gathers never leave
    the slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from diffusion_model.data.batch import GraphBatch


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",),
              devices=None) -> Mesh:
    """Build a Mesh. Default: all visible devices on one ``data`` axis."""
    devices = devices if devices is not None else jax.devices()
    if shape is None or len(shape) == 0:
        shape = (len(devices),)
    arr = np.asarray(devices[: int(np.prod(shape))]).reshape(tuple(shape))
    return Mesh(arr, tuple(axis_names[: arr.ndim]))


def make_hybrid_mesh(dcn_replicas: int, ici_size: Optional[int] = None,
                     axis_names: Sequence[str] = ("replica", "data"),
                     devices=None) -> Mesh:
    """Two-level mesh for multi-slice pods: ``replica`` spans slices (DCN),
    ``data`` spans chips within a slice (ICI).

    On real multi-slice hardware (devices expose distinct ``slice_index``)
    the device grid comes from ``mesh_utils.create_hybrid_device_mesh`` so
    each mesh row stays inside one slice — collectives over ``data`` ride
    ICI and only the (low-volume) ``replica`` reductions cross DCN. The
    intended layouts (``shard_graph_batch``):

      * mode="dp": batch over ("replica", "data") — hierarchical gradient
        all-reduce (XLA reduces within slices first, then across).
      * mode="dp_node": batch over "replica", node axis over "data" — the
        1024+-atom layout where node all-gathers stay on ICI and only
        per-replica gradients cross DCN.

    Without multi-slice hardware (this sandbox / the CPU test mesh) it
    falls back to reshaping the visible devices, which preserves the mesh
    semantics for compile-level validation.
    """
    devices = list(devices) if devices is not None else jax.devices()
    if ici_size is None:
        ici_size = len(devices) // dcn_replicas
    slice_ids = {getattr(d, "slice_index", 0) for d in devices}
    if len(slice_ids) > 1:
        from jax.experimental import mesh_utils

        arr = mesh_utils.create_hybrid_device_mesh(
            (1, ici_size), (dcn_replicas, 1), devices=devices)
    else:
        arr = np.asarray(devices[: dcn_replicas * ici_size]).reshape(
            dcn_replicas, ici_size)
    return Mesh(arr, tuple(axis_names))


def dp_batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Leading (batch) axis sharded over ``axis``.

    On the hierarchical ("replica", "data") mesh from ``make_hybrid_mesh``
    DP spans BOTH axes (DCN replicas x ICI data shards); any other
    multi-axis mesh keeps the requested ``axis`` only, so a second
    non-data axis stays replicated.
    """
    names = mesh.axis_names
    if set(names) == {"replica", "data"}:
        return NamedSharding(mesh, P(tuple(names)))
    if axis in names:
        return NamedSharding(mesh, P(axis))
    if len(names) > 1:
        # hybrid mesh under custom axis names (make_hybrid_mesh allows
        # them): DP spans every axis
        return NamedSharding(mesh, P(tuple(names)))
    raise ValueError(f"axis {axis!r} not in mesh axes {names}")


def node_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Node axis (dim 1 of [B, N, ...]) sharded — the large-cell layout."""
    return NamedSharding(mesh, P(None, axis))


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_graph_batch(batch: GraphBatch, mesh: Mesh, mode: str = "dp",
                      axis: str = "data") -> GraphBatch:
    """Place a GraphBatch on the mesh.

    mode='dp':      shard the batch axis (training / batched generation);
                    over every mesh axis on a hierarchical mesh.
    mode='node':    shard the node axis (single huge graph).
    mode='dp_node': hierarchical mesh only — batch over 'replica' (DCN),
                    node axis over 'data' (ICI): large cells, many slices.
    """
    if mode == "dp":
        sh = dp_batch_sharding(mesh, axis)
    elif mode == "node":
        sh = node_sharding(mesh, axis)
    elif mode == "dp_node":
        if "replica" not in mesh.axis_names:
            raise ValueError("dp_node needs a ('replica', 'data') mesh "
                             "(make_hybrid_mesh)")
        sh = NamedSharding(mesh, P("replica", axis))
    else:
        raise ValueError(mode)
    return jax.tree.map(lambda a: jax.device_put(a, sh), batch)
