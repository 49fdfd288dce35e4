from diffusion_model.ops.com import remove_mean, masked_mean
from diffusion_model.ops.schedules import (
    clip_noise_schedule,
    polynomial_alpha_schedule,
)
from diffusion_model.ops.kabsch import kabsch, kabsch_rmsd
from diffusion_model.ops.rdf import rdf_from_exo, rdf_cos_similarity
from diffusion_model.ops.angles import (
    cn2_angle_deg,
    cn2_bond_lengths,
    pairwise_sq_dist,
)
from diffusion_model.ops.edges import dense_pair_mask, knn_edges

__all__ = [
    "remove_mean",
    "masked_mean",
    "clip_noise_schedule",
    "polynomial_alpha_schedule",
    "kabsch",
    "kabsch_rmsd",
    "rdf_from_exo",
    "rdf_cos_similarity",
    "cn2_angle_deg",
    "cn2_bond_lengths",
    "pairwise_sq_dist",
    "dense_pair_mask",
    "knn_edges",
]
