from diffusion_model.diffusion.process import (
    Schedule,
    predefined_schedule,
    learned_schedule,
    diffuse_zero_to_t,
    calculate_mu,
    reverse_diffuse_one_step,
)
from diffusion_model.diffusion.sampler import sample, sample_with_retry

__all__ = [
    "Schedule",
    "predefined_schedule",
    "learned_schedule",
    "diffuse_zero_to_t",
    "calculate_mu",
    "reverse_diffuse_one_step",
    "sample",
    "sample_with_retry",
]
