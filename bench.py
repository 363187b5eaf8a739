"""
Benchmark: one DMET iteration hot path (lattice mean field + Schmidt bath +
EMBEDDING-ERI TRANSFORM + vcor fit) at Nk=27, nlo=16, executed through the
LIBRARY entry points (ops.fastpath.make_dmet_iteration with GDF/Cholesky
factors: the two-body transform sum_x (B^T L_x B)(x)(B^T L_x B) at naux=512
over the 432-orbital supercell runs inside the timed loop), timed on the
GPU.  There is no CPU fallback: without a GPU the script exits non-zero.

Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "ms", "vs_baseline": N,
   "platform": ..., "device_kind": ..., "card": ...}

value is the steady per-iteration time of N_CHAIN chained iterations,
ended by block_until_ready.  vs_baseline is the speedup over an equivalent
single-process NumPy/LAPACK pipeline run on the host in the same
interpreter (the reference implementation is pure NumPy/PySCF on CPU);
it is a host baseline, not a device metric.
"""

import json
import time

import numpy as np

import libdmet_preview_tpu  # noqa: F401  (x64 on)
import jax
import jax.numpy as jnp

from libdmet_preview_tpu.ops import zlinalg

# workload: Nk=27 k-points, 16 local orbitals per cell, 16 valence ->
# embedding dim 32; shapes mirror the driver metric "DMET iteration
# wall-time (bath + transform + vcor fit) at Nk=27".
NK = 27
NLO = 16
NVAL = NLO
NEO = NLO + NVAL
BETA = 1000.0
FILLING = 0.5
N_FIT_STEPS = 20   # vcor-fit iterations per DMET iteration
NAUX = 512         # DF rank of the embedding-ERI transform workload


def make_lattice(seed=0):
    """Library lattice with a random Hermitian translation-invariant
    hopping (same operator content as make_inputs of the r1 bench)."""
    from libdmet_preview_tpu.models.lattice import ChainLattice
    rng = np.random.RandomState(seed)
    h_R = rng.randn(NK, NLO, NLO) * 0.2
    h_R[0] = (h_R[0] + h_R[0].T) / 2
    for R in range(1, NK // 2 + 1):
        h_R[(-R) % NK] = h_R[R].T

    Lat = ChainLattice(NK * NLO, NLO)

    class _Ham:
        H2_format = "local"

        def getH1(self):
            return h_R

        def getFock(self):
            return h_R

        def getH2(self):
            return np.zeros((NLO,) * 4)

        def getH0(self):
            return 0.0

        def getImpJK(self):
            return None

    Lat.set_Ham_model(_Ham())
    vmat = rng.randn(1, NLO, NLO) * 0.05
    vmat = (vmat + vmat.transpose(0, 2, 1)) / 2
    rho_t = np.tile(np.eye(NEO)[None] * FILLING, (1, 1, 1))
    # DF factors of a fake supercell ERI (realistic GDF shapes: naux x
    # nsites x nsites, symmetric slices)
    nsites = NK * NLO
    L = rng.randn(NAUX, nsites, nsites).astype(float) * 0.02
    L = 0.5 * (L + L.transpose(0, 2, 1))
    return Lat, vmat, rho_t, L


class _VcorFixed:
    """Minimal local vcor carrying an explicit parameter vector
    (symmetric NLO x NLO, restricted) for the library fit."""

    restricted = True

    def __init__(self, vmat):
        self._tri = np.tril_indices(NLO)
        self.param = np.asarray(vmat[0][self._tri])

    def islocal(self):
        return True

    def get(self, kspace=False):
        m = np.zeros((NLO, NLO))
        m[self._tri] = self.param
        m = m + m.T - np.diag(np.diag(m))
        return m[None]

    def update(self, p):
        self.param = np.asarray(p)

    def gradient(self):
        npar = len(self.param)
        g = np.zeros((npar, 1, NLO, NLO))
        for P, (i, j) in enumerate(zip(*self._tri)):
            g[P, 0, i, j] = 1.0
            g[P, 0, j, i] = 1.0
        return g

    def length(self):
        return len(self.param)


def numpy_iteration(Lat, vmat, rho_target, chol_L=None):
    """Equivalent NumPy/LAPACK pipeline (reference-style per-k loops)."""
    cos_t, sin_t = zlinalg.dft_tables((NK,))
    h1 = np.asarray(Lat.getFock(kspace=False))
    f_re = np.einsum("kR, Rij -> kij", cos_t, h1)[None]
    f_im = -np.einsum("kR, Rij -> kij", sin_t, h1)[None]
    env_idx = np.arange(NLO, NK * NLO)
    nelec = int(f_re.shape[0] * NK * NLO * FILLING) * 2

    def mf_and_emb(v):
        h = f_re + 1j * f_im + v[:, None]
        spin = h.shape[0]
        ews, evs = [], []
        for s in range(spin):
            for k in range(NK):
                w, c = np.linalg.eigh(h[s, k])
                ews.append(w)
                evs.append(c)
        ew = np.asarray(ews).reshape(spin, NK, NLO)
        ev = np.asarray(evs).reshape(spin, NK, NLO, NLO)
        lo, hi = ew.min() - 10, ew.max() + 10
        for _ in range(60):
            mid = (lo + hi) / 2
            n = np.sum(1.0 / (np.exp(np.clip(BETA * (ew - mid),
                                             -100, 100)) + 1))
            if n * 2 < nelec:
                lo = mid
            else:
                hi = mid
        occ = 1.0 / (np.exp(np.clip(BETA * (ew - (lo + hi) / 2),
                                    -100, 100)) + 1)
        rho_k = np.einsum("skpi, ski, skqi -> skpq", ev, occ, ev.conj())
        rho_R = np.einsum("kR, skpq -> sRpq",
                          cos_t + 1j * sin_t.conj() * (-1), rho_k).real / NK
        flat = rho_R.reshape(spin, NK * NLO, NLO)
        env = flat[:, env_idx, :NVAL]
        u = np.stack([np.linalg.svd(env[s], full_matrices=False)[0]
                      for s in range(spin)])
        basis = np.zeros((spin, NK * NLO, NEO))
        basis[:, :NLO, :NLO] = np.eye(NLO)
        basis[:, env_idx, NLO:] = u
        bR = basis.reshape(spin, NK, NLO, NEO)
        b_k = np.einsum("kR, sRpj -> skpj", cos_t.T + 1j * sin_t.T, bR)
        embH1 = np.einsum("skpi, skpq, skqj -> sij",
                          b_k.conj(), h, b_k).real / NK
        rho_emb = np.einsum("skpi, skpq, skqj -> sij",
                            b_k.conj(), rho_k, b_k).real / NK
        return rho_emb, embH1

    v = vmat.copy()
    for _ in range(N_FIT_STEPS):
        # the reference's analytic gradient costs ~2 forwards per step
        # (favorable to the baseline)
        mf_and_emb(v)
        rho_emb, embH1 = mf_and_emb(v)
        v = v - 0.0 * v
    # embedding-ERI transform, once per DMET iteration (the reference's
    # GDF rotate + syrk hot loop, eri_transform.py:436-522): two GEMMs
    # per factor + syrk through NumPy BLAS
    if chol_L is not None:
        basis = np.zeros((NK * NLO, NEO))
        basis[:NLO, :NLO] = np.eye(NLO)
        basis[NLO:, NLO:] = np.linalg.qr(
            np.random.RandomState(0).randn(NK * NLO - NLO, NVAL))[0]
        LB = np.einsum("xpq, qj -> xpj", chol_L, basis, optimize=True)
        L_emb = np.einsum("pi, xpj -> xij", basis, LB, optimize=True)
        Lf = L_emb.reshape(L_emb.shape[0], -1)
        eri_emb = Lf.T @ Lf
        embH1 = embH1 + 0.0 * eri_emb[0, 0]
    return v, np.sum((rho_emb - rho_target) ** 2), embH1


def timeit(fn, n=5):
    jax.block_until_ready(fn())  # warmup/compile
    t0 = time.perf_counter()
    for _ in range(n):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / n


def require_gpu(devices=None, n_cards=1):
    """The first JAX device if the first n_cards devices are GPUs;
    SystemExit otherwise.  A timing taken on the host is not a device
    number, so nothing that measures the card falls back to the CPU."""
    devices = jax.devices() if devices is None else devices
    if len(devices) < n_cards or any(d.platform != "gpu"
                                     for d in devices[:n_cards]):
        raise SystemExit("need %d GPU(s); JAX found: %s"
                         % (n_cards, [d.platform for d in devices]))
    return devices[0]


def card_line():
    """`nvidia-smi --query-gpu=name,power.limit`: the card's name and
    power limit, to be printed beside every number taken on it."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = "nvidia-smi unavailable (%s)" % e
    return out or "nvidia-smi printed nothing"


N_CHAIN = 10   # back-to-back iterations per timed program (a real DMET
               # loop chains iterations with a data dependency; chaining
               # measures the sustained cost without charging the host
               # fetch round trip N times)


def main():
    from libdmet_preview_tpu.ops.fastpath import (make_dmet_iteration,
                                                  chain_iterations)
    dev = require_gpu()
    card = card_line()
    print(card, flush=True)
    Lat, vmat, rho_t, chol_L = make_lattice()
    vcor = _VcorFixed(vmat)

    step, p0 = make_dmet_iteration(Lat, vcor, FILLING, beta=BETA,
                                   fit_max_iter=N_FIT_STEPS,
                                   chol_L=chol_L)
    # a realistic correlated target: the mean-field embedding density of a
    # PERTURBED vcor (so the fit has a genuine residual + gradient signal)
    rng = np.random.RandomState(7)
    dp = rng.randn(len(p0)) * 0.1
    embH1_p = step(jnp.asarray(p0 + dp), jnp.asarray(rho_t))[2]
    w, V = np.linalg.eigh(np.asarray(embH1_p))
    occ = 1.0 / (np.exp(np.clip(BETA * (w - np.median(w)), -100, 100)) + 1)
    rho_target = np.einsum("spi, si, sqi -> spq", V, occ, V)

    chained = chain_iterations(step, N_CHAIN)
    p0_j = jnp.asarray(p0)
    t_j = jnp.asarray(rho_target)

    t_jax = timeit(lambda: chained(p0_j, t_j), n=5) / N_CHAIN

    def run_np():
        return numpy_iteration(Lat, vmat, rho_target, chol_L=chol_L)

    t_np = timeit(run_np, n=3)

    print(json.dumps({
        "metric": "dmet_iteration_walltime_nk27_library_with_eri",
        "value": round(t_jax * 1e3, 3),
        "unit": "ms",
        "vs_baseline": round(t_np / t_jax, 2),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "card": card,
    }))


if __name__ == "__main__":
    main()
