"""The embedding-ERI product on the GPU: full square against s4-packed.

Given rotated DF factors L_emb (naux, neo, neo), symmetric in (ij), the
chemist ERI eri[ij,kl] = sum_x L_x[ij] L_x[kl] is one f64 GEMM:

  full -- (neo^2 x naux) @ (naux x neo^2), 2 naux neo^4 flops,
  s4   -- pack the neo(neo+1)/2 pairs i >= j, (npair x naux) @ (naux x
          npair), 2 naux npair^2 flops; "s4+unpack" adds the gather back
          to (neo,)*4 that the consumers read: the library's path
          (ops.eri_transform.eri_from_factors).

A large square f64 GEMM is timed beside them as the practical DGEMM rate
of the card.  Each product is timed as N_CHAIN dependent products inside
one program (so launch latency does not count; host clock ended by
block_until_ready), and rates are the algorithm's flops over that time,
against the 67 TFLOP/s FP64 tensor-core peak of the H100 SXM data sheet
(at its 700 W limit).

Exits non-zero without a GPU.
Run: python scripts/prof_eri_product.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import libdmet_preview_tpu  # noqa: F401  (x64 on)
import jax
import jax.numpy as jnp

from bench import card_line, require_gpu
from libdmet_preview_tpu.ops.eri_transform import eri_from_factors

PEAK_FP64_TFLOPS = 67.0   # H100 SXM FP64 tensor core, NVIDIA data sheet
N_REP = 10
N_CHAIN = 20
SHAPES = ((32, 512), (96, 1024))   # (neo, naux): bench cell, large solid
DGEMM_N = 8192


def timeit(f, x):
    """Seconds per f(x) over N_CHAIN dependent calls in one program."""
    def chain(x):
        def body(c, _):
            return c + 1e-300 * f(c).ravel()[0], None
        return jax.lax.scan(body, x, None, length=N_CHAIN)[0]
    fn = jax.jit(chain)
    jax.block_until_ready(fn(x))
    t0 = time.perf_counter()
    for _ in range(N_REP):
        jax.block_until_ready(fn(x))
    return (time.perf_counter() - t0) / N_REP / N_CHAIN


def s4_product(L_emb):
    neo = L_emb.shape[-1]
    ti, tj = np.tril_indices(neo)
    F = L_emb[:, ti, tj]
    return F.T @ F


def full_square(L_emb):
    neo = L_emb.shape[-1]
    Lf = L_emb.reshape(L_emb.shape[0], -1)
    return (Lf.T @ Lf).reshape((neo,) * 4)


def main():
    require_gpu()
    print(card_line(), flush=True)
    rng = np.random.RandomState(0)

    def report(case, shape, flops, t):
        tf = flops / t / 1e12
        print("%-10s %-16s %9.4f ms  %8.2f GFLOP  %7.3f TF/s  %5.1f%% of "
              "peak" % (case, shape, t * 1e3, flops / 1e9, tf,
                        100 * tf / PEAK_FP64_TFLOPS), flush=True)

    n = DGEMM_N
    A = jnp.asarray(rng.randn(n, n))
    report("dgemm", "%dx%dx%d" % (n, n, n), 2.0 * n ** 3,
           timeit(lambda a: a @ a, A))
    for neo, naux in SHAPES:
        L = rng.randn(naux, neo, neo)
        L = jnp.asarray(0.5 * (L + L.transpose(0, 2, 1)))
        npair = neo * (neo + 1) // 2
        ref = np.asarray(jax.jit(full_square)(L))
        assert np.allclose(np.asarray(jax.jit(eri_from_factors)(L)), ref,
                           rtol=1e-12, atol=1e-10)
        shape = "neo=%d naux=%d" % (neo, naux)
        report("full", shape, 2.0 * naux * neo ** 4,
               timeit(full_square, L))
        report("s4", shape, 2.0 * naux * npair ** 2,
               timeit(s4_product, L))
        report("s4+unpack", shape, 2.0 * naux * npair ** 2,
               timeit(eri_from_factors, L))


if __name__ == "__main__":
    main()
