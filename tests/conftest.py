"""Test configuration: run everything on CPU with 8 virtual devices so
sharding / halo-exchange tests run without a multi-GPU host (SURVEY.md
§4). The platform is pinned through jax.config as well as by the
`JAX_PLATFORMS=cpu` the suite is launched with, so a card on the test
machine never changes which tests are collected.

Tests that need the card take the `gpu_device` fixture (marker `gpu`):
the fixture, not the import, decides, and skips them here.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)


import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound the suite's resident memory: compiled XLA-CPU programs
    accumulate across all ~215 tests (the heavy interpret-mode Pallas
    traces especially) and by the LAST module the process brushes the
    host's 63 GB commit limit — observed as a segfault inside XLA at
    99% of an otherwise-green run (round 5). Dropping the compilation
    caches after each module trades a few re-compiles of shared helpers
    for a flat memory profile."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture
def gpu_device():
    """The first GPU JAX can see; skips the test when there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX; run python chip_smoke.py on the card")
