"""
Test configuration: run on a virtual 8-device CPU mesh so that sharded
(multi-device) code paths are exercised without accelerator hardware, and
keep float64 for the DMET numerics.  Tests marked `gpu` need a CUDA
device; the `gpu_device` fixture skips them elsewhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)

# disk-cache the native integral tensors (keyed by workload + the ints/
# source hash, so integral-engine changes auto-invalidate): repeated
# suite runs skip the ~1 min/builder host generation
os.environ.setdefault(
    "LIBDMET_TPU_INT_CACHE",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".integral_cache"))


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none.  Decided
    here, at run time, so every xdist worker collects the same tests."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a CUDA device (run chip_smoke.py on the GPU)")
