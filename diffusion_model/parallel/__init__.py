from diffusion_model.parallel.mesh import (
    make_hybrid_mesh,
    make_mesh,
    shard_graph_batch,
    replicate,
    dp_batch_sharding,
    node_sharding,
)

__all__ = [
    "make_hybrid_mesh",
    "make_mesh",
    "shard_graph_batch",
    "replicate",
    "dp_batch_sharding",
    "node_sharding",
]
