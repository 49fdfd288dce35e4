"""diffusion_model — E(3)-equivariant diffusion framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of the reference
PyTorch repo `Ren-Okubo/diffusion_model`: an EDM-style equivariant diffusion
model generating local SiO2 atomic structures conditioned on EELS core-loss
spectra, plus the full surrounding stack (data pipeline, trainer, sampler,
evaluators, CLI drivers) — redesigned for an accelerator:

* padded fixed-shape graph batches (no dynamic shapes under jit),
* dense masked message passing as large batched matmuls,
* `lax.scan` reverse-diffusion sampler (zero host sync inside the loop),
* `jax.sharding.Mesh` data parallelism and row-sharded message passing
  for large cells,
* checkpoints with optimizer state and true resume.
"""

__version__ = "0.1.0"

from diffusion_model.config import Config, load_config  # noqa: F401
