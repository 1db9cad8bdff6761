"""Test harness: an 8-device virtual CPU platform, so the suite runs
deterministically without an accelerator and the sharding tests have a mesh.

The CPU is forced here even where a GPU is present: the suite runs under
several xdist workers, and each worker that opened the card would reserve
three quarters of its memory, so the second one would fail. Tests that need
the card carry the `gpu` marker and check for it inside the `gpu_device`
fixture; `python chip_smoke.py` runs the same comparisons on the card.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# One compile cache per xdist worker (gw0/gw1/... are stable across runs,
# so each stays warm): two workers writing the same entry at once can tear
# it, and a torn entry later aborts the reader. The split sits under
# JAX_COMPILATION_CACHE_DIR when that is set, else in the checkout.
if not os.environ.get("AGARCL_NO_CACHE"):
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw")
    base = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..")
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(base, f".jax_cache_{worker}"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where this process has none (always, in the
    CPU-forced suite)."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU; run `python chip_smoke.py` on the card")
    return gpus[0]
