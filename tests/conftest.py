"""Test configuration: run everything on an 8-device virtual CPU mesh.

Mirrors the reference's test strategy of exercising multi-node paths in one
process (velox/exec/tests/MultiFragmentTest.cpp:41-46): we force the JAX CPU
backend with 8 virtual devices so sharding/collective code paths compile and
run without an accelerator. XLA_FLAGS must be set before the backend
initializes.

The one exception: with ``JAX_PLATFORMS=cuda`` the GPU stays the default
backend, for ``pytest -m chip tests/test_chip.py`` on an NVIDIA card. Tests
marked ``chip`` decide in a fixture whether a GPU is present and skip
otherwise.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags = (_flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_parallel_codegen_split_count" not in _flags:
    # XLA:CPU's parallel LLVM codegen segfaulted nondeterministically
    # late in the suite (hundreds of compiled programs; faulthandler
    # inside backend_compile_and_load on a test that PASSES solo).
    # Serializing codegen removes the compiler's pool threads from the
    # picture; compile walls on these small test programs are unchanged.
    _flags = (_flags + " --xla_cpu_parallel_codegen_split_count=1").strip()
os.environ["XLA_FLAGS"] = _flags

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
if os.environ.get("JAX_PLATFORMS") != "cuda":
    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu", jax.default_backend()
    assert len(jax.devices()) == 8, jax.devices()

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_compile_state():
    """XLA:CPU segfaulted nondeterministically once a single process had
    compiled several hundred programs (faulthandler inside
    backend_compile_and_load, late in the suite, on tests that pass
    solo; reproduced with parallel codegen serialized). Clearing the
    executable caches after each test module bounds the live-program
    count; cached_jit wrappers recompile on demand."""
    yield
    jax.clear_caches()
