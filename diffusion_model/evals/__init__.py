from diffusion_model.evals.rdf import evaluate_rdf_lists, rdf_metrics
from diffusion_model.evals.rmsd import (
    evaluate_by_rmsd,
    evaluate_by_rmsd_and_atom_type,
    permutation_min_rmsd,
    hungarian_align,
)
from diffusion_model.evals.cn2 import (
    aligned_group_means,
    cn2_statistics,
    conditional_angle_parity,
    per_graph_group_means,
    r2score,
    filter_si_o_si,
)
from diffusion_model.evals.density import o_density, density_accuracy
from diffusion_model.evals.fingerprint import (
    guess_bonds,
    atom_pair_fingerprint,
    morgan_fingerprint,
    tanimoto_similarity,
    fingerprint_similarity,
)
from diffusion_model.evals.baseline import (
    nn_ceiling_r2,
    spectrum_nn_predict,
)
from diffusion_model.evals.template import (
    local_descriptor,
    template_match,
)
from diffusion_model.evals.amorphous import (
    aggregate_exo_rdf,
    bond_angle_samples,
    coordination_stats,
    envelope_matched_cloud,
    excess_rdf_cos,
    exo_rdf_resampling_ceiling,
    pair_distances,
    radial_envelope,
    structure_panel,
)

__all__ = [
    "evaluate_rdf_lists",
    "rdf_metrics",
    "evaluate_by_rmsd",
    "evaluate_by_rmsd_and_atom_type",
    "permutation_min_rmsd",
    "hungarian_align",
    "aligned_group_means",
    "conditional_angle_parity",
    "cn2_statistics",
    "per_graph_group_means",
    "r2score",
    "filter_si_o_si",
    "o_density",
    "density_accuracy",
    "guess_bonds",
    "atom_pair_fingerprint",
    "morgan_fingerprint",
    "tanimoto_similarity",
    "fingerprint_similarity",
    "local_descriptor",
    "template_match",
    "spectrum_nn_predict",
    "nn_ceiling_r2",
    "aggregate_exo_rdf",
    "bond_angle_samples",
    "coordination_stats",
    "envelope_matched_cloud",
    "exo_rdf_resampling_ceiling",
    "pair_distances",
    "radial_envelope",
    "structure_panel",
]
