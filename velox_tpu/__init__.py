"""velox_tpu: a vectorized query-execution engine in JAX.

A from-scratch reimplementation of the capabilities of Velox
(facebookincubator/velox): columnar batches as statically-shaped jnp
arrays in device memory, operators as jit-compiled dense/masked programs,
hash tables and sorts as XLA programs, and multi-device scaling via
jax.sharding meshes and collectives. Its accelerator is an NVIDIA GPU.
"""

__version__ = "0.1.0"

import jax as _jax

# SQL semantics require 64-bit integers (BIGINT, scaled decimals); decimal
# money math is exact int64.
_jax.config.update("jax_enable_x64", True)

import os as _os

_CHECKOUT_CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
_cache_chosen = False


def compile_cache_dir(platform: str):
    """The persistent compile cache directory this package sets, or None.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no other
    path is set here. Otherwise accelerator platforms use
    ``<checkout>/.jax_cache``, a fixed path that every run from this checkout
    finds again. The CPU platform gets no cache: XLA:CPU entries bake in the
    compiling host's ISA features, and reloading them segfaulted the test
    suite.
    """
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR") or platform == "cpu":
        return None
    return _CHECKOUT_CACHE


def use_compile_cache() -> None:
    """Point JAX at ``compile_cache_dir`` for the default backend. Called
    by the engine's entry points before their first compile; JAX opens the
    cache at the first compile after the directory is set."""
    global _cache_chosen
    if _cache_chosen:
        return
    _cache_chosen = True
    path = compile_cache_dir(_jax.default_backend())
    if path is not None:
        _jax.config.update("jax_compilation_cache_dir", path)


from velox_tpu import types  # noqa: F401,E402
