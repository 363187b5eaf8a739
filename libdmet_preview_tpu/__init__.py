"""
libdmet_preview_tpu: a density-matrix-embedding-theory (DMET) framework in
JAX.

Brand-new implementation of the capabilities of gkclab/libdmet_preview
(reference layout: libdmet/), designed for an accelerator:

  * all per-k-point loops are batched (vmap) `eigh`/`svd`/einsum calls that
    XLA compiles into a few large device programs,
  * k<->R transforms are DFT-by-matmul over the cell axes,
  * the correlation-potential fit is a differentiable least-squares with an
    analytic occ-virt perturbation gradient evaluated on device,
  * impurity solvers (FCI, CCSD, SCF) are jit-compiled amplitude/sigma
    iterations instead of external C kernels,
  * multi-device scaling uses `jax.sharding.Mesh` + `shard_map` over the
    k-point and auxiliary axes (replacing the reference's MPI pool,
    eri_transform_mpi.py / mfd_mpi.py).

DMET works in float64 (energies to 1e-7 Ha); x64 mode is enabled at import.
Compiled programs persist in JAX's compilation cache: the directory named
by JAX_COMPILATION_CACHE_DIR when that is set, else `.jax_cache` at the
root of the checkout.
"""

import os as _os

import jax

jax.config.update("jax_enable_x64", True)

DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir(environ=None):
    """The persistent compilation-cache directory in use:
    JAX_COMPILATION_CACHE_DIR when set (JAX reads it itself), else the
    fixed in-checkout DEFAULT_CACHE_DIR (a fixed path, so the cache key
    is stable from one run to the next)."""
    environ = _os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)

__version__ = "0.1.0"

from libdmet_preview_tpu import utils
from libdmet_preview_tpu import models
from libdmet_preview_tpu import ops
from libdmet_preview_tpu import solvers
from libdmet_preview_tpu import dmet
from libdmet_preview_tpu import lo
from libdmet_preview_tpu import ints
from libdmet_preview_tpu import parallel
