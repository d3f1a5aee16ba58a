"""Test environment.

By default the suite runs on the CPU backend with 8 virtual devices (for
the multi-device mesh tests), and Pallas kernels run in the interpreter
(kernels/common.interpret_mode). Both are set here, before any test module
imports JAX's backend.

Tests marked ``gpu`` need the card: they take the ``gpu_backend`` fixture,
which skips them on any other backend. ``chip_smoke.py`` runs them on the
card in its own process with RENDER_TESTS_ON_GPU=1, which leaves the
backend alone.
"""

import os

import pytest

if os.environ.get("RENDER_TESTS_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    # Interpret-mode cost scales with the raster chunk unroll: the suite
    # runs the same code paths at CHUNK=8 instead of the production 32.
    os.environ.setdefault("RASTER_CHUNK", "8")

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    assert jax.default_backend() == "cpu", "tests must run on the CPU backend"


@pytest.fixture
def gpu_backend():
    """Skip unless JAX runs on a GPU (decided at run time, never at import:
    every pytest-xdist worker must collect the same tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run through chip_smoke.py on the card")
    return jax.devices()[0]
