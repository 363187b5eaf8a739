"""Micro-timings of the small f64 eighs on the DMET hot path, on the GPU.

Each case is timed two ways, host clock ended by block_until_ready:
  dispatch -- one jitted call per eigh (launch latency included),
  chained  -- 20 dependent eighs inside one lax.scan program, per eigh.

Cases: the f64 eigh (cuSOLVER) at the fused iteration's shapes (one
32x32, a batch of 14x32x32, and the 14 k-blocks of 16x16 Hermitian
matrices through their real 32x32 embedding, ops.zlinalg.zeigh), and over
sizes around 32, batched and single, with jaxlib's default choice and
with the Jacobi and QR solvers forced: where the GPU eigh stops batching.

Exits non-zero without a GPU.
Run: python scripts/prof_micro_eigh.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import libdmet_preview_tpu  # noqa: F401  (x64 on)
import jax
import jax.numpy as jnp
from jax import lax

from bench import card_line, require_gpu
from libdmet_preview_tpu.ops import zlinalg

N_REP = 20
N_CHAIN = 20


def timeit(fn, x):
    jax.block_until_ready(fn(x))
    t0 = time.perf_counter()
    for _ in range(N_REP):
        jax.block_until_ready(fn(x))
    return (time.perf_counter() - t0) / N_REP * 1e3


def chained(f):
    """N_CHAIN dependent evaluations of f (x -> (w, V)) in one program."""
    def g(x):
        def body(c, _):
            w, V = f(c)
            return c + 1e-20 * (jnp.sum(w) + jnp.sum(V)), None
        return lax.scan(body, x, None, length=N_CHAIN)[0]
    return jax.jit(g)


def sym(rng, shape):
    a = rng.randn(*shape)
    return jnp.asarray(a + np.swapaxes(a, -1, -2))


def main():
    require_gpu()
    print(card_line(), flush=True)
    rng = np.random.RandomState(0)
    impl = lax.linalg.EighImplementation

    def forced(which):
        return lambda h: lax.linalg.eigh(h, implementation=which)[::-1]

    zre = sym(rng, (14, 16, 16))
    zim_raw = rng.randn(14, 16, 16)
    zim = jnp.asarray(zim_raw - np.swapaxes(zim_raw, -1, -2))
    cases = [("zeigh", "14x(16c->32)",
              lambda z: zlinalg.zeigh(z[0], z[1]), jnp.stack([zre, zim]))]
    for batch, n in ((1, 16), (1, 32), (1, 64), (14, 16), (14, 32),
                     (14, 33), (14, 48), (14, 64), (14, 128)):
        x = sym(rng, (batch, n, n) if batch > 1 else (n, n))
        shape = "%dx%d" % (batch, n)
        cases.append(("default", shape, jnp.linalg.eigh, x))
        cases.append(("jacobi", shape, forced(impl.JACOBI), x))
        cases.append(("qr", shape, forced(impl.QR), x))

    for name, shape, f, x in cases:
        try:
            t_disp = timeit(jax.jit(f), x)
            t_chain = timeit(chained(f), x) / N_CHAIN
        except Exception as e:  # a solver the installed jaxlib refuses
            print("%-14s %-14s failed: %s" % (name, shape,
                                              str(e).splitlines()[0]))
            continue
        print("%-14s %-14s dispatch %9.4f ms  chained %9.4f ms"
              % (name, shape, t_disp, t_chain), flush=True)


if __name__ == "__main__":
    main()
