import os

from diffusion_model.utils.logging import RunLogger

__all__ = ["RunLogger", "setup_compile_cache"]

# <checkout>/.jax_cache: a fixed path, because the path is part of the
# cache key and a directory that moves never hits.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def setup_compile_cache() -> str:
    """Place JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache goes to ``<checkout>/.jax_cache``
    (listed in ``.gitignore``). Entry points call this at the top of
    ``main()``, before their first compile.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
