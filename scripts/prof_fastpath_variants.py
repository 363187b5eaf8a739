"""The fused DMET iteration at the bench's widths on the GPU, with the
fit's lone eigh on the solver the library picks (qr: ops.zlinalg.eigh_sym)
against jaxlib's default choice for it (default: Jacobi up to n=32).

Every variant is compiled first; then the timed rounds run the variants
in turn, so that all of them see the same card state.  Each timing is
N_CHAIN chained iterations in one program (host clock, ended by
block_until_ready), reported per iteration with the final fit error.

Exits non-zero without a GPU.
Run: python scripts/prof_fastpath_variants.py [variant ...]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import libdmet_preview_tpu  # noqa: F401  (x64 on)
import jax
import jax.numpy as jnp

import bench as B
from libdmet_preview_tpu.ops import zlinalg
from libdmet_preview_tpu.ops.fastpath import (make_dmet_iteration,
                                              chain_iterations)

VARIANTS = {"qr": zlinalg.eigh_sym, "default": jnp.linalg.eigh}
N_ROUNDS = 3
N_REP = 3


def main(names):
    B.require_gpu()
    print(B.card_line(), flush=True)
    Lat, vmat, rho_t, chol_L = B.make_lattice()
    vcor = B._VcorFixed(vmat)
    rng = np.random.RandomState(7)

    progs = {}
    rho_target = None
    for name in names:
        t0 = time.perf_counter()
        # the solver is bound when the program is traced, at its first call
        zlinalg.eigh_sym = VARIANTS[name]
        step, p0 = make_dmet_iteration(Lat, vcor, B.FILLING, beta=B.BETA,
                                       fit_max_iter=B.N_FIT_STEPS,
                                       chol_L=chol_L)
        if rho_target is None:
            dp = rng.randn(len(p0)) * 0.1
            embH1_p = step(jnp.asarray(p0 + dp), jnp.asarray(rho_t))[2]
            w, V = np.linalg.eigh(np.asarray(embH1_p))
            occ = 1.0 / (np.exp(np.clip(B.BETA * (w - np.median(w)),
                                        -100, 100)) + 1)
            rho_target = jnp.asarray(
                np.einsum("spi, si, sqi -> spq", V, occ, V))
        chained = chain_iterations(step, B.N_CHAIN)
        p0_j = jnp.asarray(p0)
        out = jax.block_until_ready(chained(p0_j, rho_target))
        progs[name] = (chained, p0_j)
        zlinalg.eigh_sym = VARIANTS["qr"]
        print("%-11s compile+first run %7.2f s  fit_err %.3e"
              % (name, time.perf_counter() - t0, float(out[1])), flush=True)

    times = {name: [] for name in names}
    errs = {}
    for _ in range(N_ROUNDS):
        for name in names:
            chained, p0_j = progs[name]
            t0 = time.perf_counter()
            for _ in range(N_REP):
                out = jax.block_until_ready(chained(p0_j, rho_target))
            times[name].append((time.perf_counter() - t0) / N_REP
                               / B.N_CHAIN * 1e3)
            errs[name] = float(out[1])
    for name in names:
        t = sorted(times[name])
        print("%-11s ms/iter %s  median %.4f  fit_err %.3e"
              % (name, " ".join("%.4f" % x for x in times[name]),
                 t[len(t) // 2], errs[name]), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(VARIANTS))
