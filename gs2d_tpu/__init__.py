"""gs2d_tpu: a 2D Gaussian splatting framework in JAX.

A from-scratch JAX/XLA/Pallas implementation of the capabilities of
Ushio/2dGaussianSplatting (named importably). See README.md for the
architecture map.
"""

import os as _os

__version__ = "0.1.0"

# Where compiled executables are kept when JAX_COMPILATION_CACHE_DIR is not
# set: a fixed directory inside the checkout (listed in .gitignore).
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def enable_compilation_cache() -> str:
    """Keep compiled executables across processes; returns the directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here; otherwise the cache lives in DEFAULT_CACHE_DIR."""
    import jax

    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
