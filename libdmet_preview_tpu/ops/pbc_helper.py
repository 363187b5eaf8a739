"""
JK builders for lattice Hamiltonians (JAX rewrite of the pieces of
reference routine/pbc_helper.py used by the model path).
"""

import numpy as np
import jax
import jax.numpy as jnp


@jax.jit
def _jk_local(eri, dm):
    vj = jnp.einsum("ijkl, skl -> sij", eri, dm)
    vk = jnp.einsum("ilkj, skl -> sij", eri, dm)
    return vj, vk


def get_jk_local(eri, dm0):
    """J/K from a local (single-cell) ERI and the cell-averaged density
    rho(R=0) (reference pbc_helper.py:375-423).  Both are k-independent.

    dm0: (spin, nao, nao) real.  Returns (vj, vk) with shape
    (spin, nao, nao)."""
    dm0 = np.asarray(dm0)
    if dm0.ndim == 2:
        dm0 = dm0[None]
    vj, vk = _jk_local(jnp.asarray(eri), jnp.asarray(dm0))
    return np.asarray(vj), np.asarray(vk)


@jax.jit
def _jk_nearest(eri_R, dm_stripe, neg_map):
    """eri_R: (ncells, n, n, n, n) blocks (0 p 0 q | R r R s);
    dm_stripe: (spin, ncells, n, n) with block (ci, cj) = dm[(ci-cj) % N].

    vj is local (density in every cell identical); vk is a stripe:
      vj[p, q]    = sum_R eri_R[R, p, q, r, s] dm0[s, r]
      vk[R][p, s] = sum   eri_R[R, p, q, r, s] dm[R][r, q]
    (Coulomb/exchange of a translation-invariant state,
    reference pbc_helper.py:424-507)."""
    dm0 = dm_stripe[:, 0]
    vj = jnp.einsum("Rpqrs, tsr -> tpq", eri_R, dm0)
    # exchange needs the dm block (0, R) = stripe[R]^T (Hermitian dm)
    vk = jnp.einsum("Rpqrs, tRrq -> tRps", eri_R, dm_stripe)
    return vj, vk


def get_jk_nearest(eri_R, dm_stripe, neg_map=None):
    """J/K for the 'nearest' H2 format.  Returns (vj (spin, n, n),
    vk_stripe (spin, ncells, n, n))."""
    dm_stripe = np.asarray(dm_stripe)
    if dm_stripe.ndim == 3:
        dm_stripe = dm_stripe[None]
    vj, vk = _jk_nearest(jnp.asarray(eri_R), jnp.asarray(dm_stripe), None)
    return np.asarray(vj), np.asarray(vk)


def get_jk_full_bruteforce(lattice, eri_R, dm_stripe):
    """Oracle JK from the fully expanded supercell ERI ('nearest' blocks
    expanded to (nsites,)*4) -- test reference for get_jk_nearest."""
    ncells, n = eri_R.shape[0], eri_R.shape[1]
    ns = ncells * n
    big = np.zeros((ns,) * 4)
    for cI in range(ncells):
        for cR in range(ncells):
            cJ = lattice.add(cI, cR) if hasattr(lattice, "add") else \
                (cI + cR) % ncells
            big[cI * n:(cI + 1) * n, cI * n:(cI + 1) * n,
                cJ * n:(cJ + 1) * n, cJ * n:(cJ + 1) * n] = eri_R[
                    lattice.subtract(cJ, cI) if hasattr(lattice, "subtract")
                    else (cJ - cI) % ncells]
    dm_full = lattice.expand(np.asarray(dm_stripe))
    vj = np.einsum("pqrs, tsr -> tpq", big, dm_full)
    vk = np.einsum("pqrs, trq -> tps", big, dm_full)
    return vj, vk


# ----------------------------------------------------------------------
# k-resolved JK builders (reference pbc_helper.py:276-565: JK from
# 7d k-ERIs, JK from GDF factors, GHF JK, eri -> GDF conversion)
# ----------------------------------------------------------------------

def eri_R_to_eri_7d(eri_lo, ncells, nlo):
    """Translation-invariant supercell LO ERI -> the 7d k-resolved
    tensor eri_k[k1, k2, k3, p, q, r, s] = (k1 p, k2 q | k3 r, k4 s)
    with k4 = k1 - k2 + k3 implied by momentum conservation (the
    reference's 7d storage, pbc_helper.py:276); Bloch convention
    |k p> = (1/sqrt(N)) sum_A e^{ikA} |A p>, 1D cyclic mesh."""
    eri_lo = np.asarray(eri_lo)
    E = eri_lo.reshape(ncells, nlo, ncells, nlo, ncells, nlo, ncells, nlo)
    f = np.fft.fftfreq(ncells)
    P = np.exp(-2j * np.pi * np.outer(f, np.arange(ncells)))
    Ek = np.zeros((ncells,) * 3 + (nlo,) * 4, dtype=complex)
    for k1 in range(ncells):
        for k2 in range(ncells):
            for k3 in range(ncells):
                k4 = (k1 - k2 + k3) % ncells
                Ek[k1, k2, k3] = np.einsum(
                    "ApBqCrDs, A, B, C, D -> pqrs", E,
                    P[k1], P[k2].conj(), P[k3], P[k4].conj(),
                    optimize=True) / ncells ** 2
    return Ek


def get_jk_from_eri_7d(eri_k, dm_k):
    """J/K per k-point from the 7d momentum-conserving k-ERI
    (reference pbc_helper.py get_jk_from_eri_7d role), with the
    repo's chemist conventions (vj = (pq|rs) D[rs],
    vk[p,s] = (pq|rs) D[rq], validated against the supercell brute
    force in tests/test_pbc_helper.py):

      J_k[pq] = sum_{k3 rs} (k p, k q | k3 r, k3 s) D_k3[rs]
      K_k[ps] = sum_{k2 qr} (k p, k2 q | k2 r, k s) D_k2[rq]

    dm_k: (spin, nk, n, n) complex Hermitian (per-spin blocks).
    Returns (vj, vk) with the same shape."""
    eri_k = np.asarray(eri_k)
    dm_k = np.asarray(dm_k)
    if dm_k.ndim == 3:
        dm_k = dm_k[None]
    nk = dm_k.shape[1]
    diag = np.arange(nk)
    # the ket legs of the density carry the conjugate Bloch phases
    dmc = dm_k.conj()
    # J: k1 = k2 = k (transfer 0); k4 = k3
    blk_j = eri_k[diag, diag]                  # (k, k3, p, q, r, s)
    vj = np.einsum("kmpqrs, tmrs -> tkpq", blk_j, dmc, optimize=True)
    # K: k3 = k2 (the density is k-diagonal); k4 = k1
    blk_k = eri_k[np.arange(nk)[:, None], diag[None, :], diag[None, :]]
    vk = np.einsum("kmpqrs, tmrq -> tkps", blk_k, dmc, optimize=True)
    return vj, vk


def get_jk_from_gdf(factors, dm_k):
    """J/K per k from per-transfer GDF factors {q: (F_re, F_im)}
    (ops.eri_transform.make_gdf_factors; the same structure the
    reference streams from CDERI HDF5):

      M_q[(k1,p,a),(k3,s,r)] = (k1 p, k1+q a | k3+q r, k3 s)
                             = sum_x F_q[k1,p,a,x] conj(F_q[k3,s,r,x])

    J uses the q = 0 block; for K the k-diagonal density pairs
    (k p, k+q a | k+q r, k s), i.e. k3 = k within each transfer:

      J_k[pa] = sum_x F_0[k,p,a,x] sum_{k3 sr} conj(F_0[k3,s,r,x]) D_k3[rs]
      K_k[ps] = sum_q sum_{arx} F_q[k,p,a,x] conj(F_q[k,s,r,x]) D_{k+q}[ra]

    O(nk naux n^2) per transfer -- the scalable JK (no 7d tensor)."""
    dm_k = np.asarray(dm_k)
    if dm_k.ndim == 3:
        dm_k = dm_k[None]
    spin, nk, n, _ = dm_k.shape
    F0 = factors[0][0] + 1j * factors[0][1]
    dmc = dm_k.conj()
    w = np.einsum("msrx, tmrs -> tx", F0.conj(), dmc, optimize=True)
    vj = np.einsum("kpax, tx -> tkpa", F0, w, optimize=True)
    vk = np.zeros_like(vj)
    for q, (Fr, Fi) in factors.items():
        Fq = Fr + 1j * Fi                      # (nk, n, n, x)
        kq = (np.arange(nk) + q) % nk
        g = np.einsum("kpax, tkra -> tkprx", Fq, dmc[:, kq],
                      optimize=True)
        vk += np.einsum("tkprx, ksrx -> tkps", g, Fq.conj(),
                        optimize=True)
    return vj, vk


def get_jk_ghf(eri_blocks, dm_so):
    """Generalized (GHF) JK on a 2n x 2n generalized density from
    spin-blocked chemist ERIs (g_aa, g_bb, g_ab) (reference
    pbc_helper.py:565 GHF JK): the Coulomb is spin-diagonal; the
    exchange acts on every sector including the anomalous-looking
    off-diagonal spin blocks:

      K_ab[p,s] = sum_{l k} (p_a l_a | k_b s_b) D[k_b, l_a]."""
    g_aa, g_bb, g_ab = [np.asarray(x) for x in eri_blocks]
    dm_so = np.asarray(dm_so)
    n = g_aa.shape[0]
    daa, dab = dm_so[:n, :n], dm_so[:n, n:]
    dba, dbb = dm_so[n:, :n], dm_so[n:, n:]
    vj = np.zeros_like(dm_so)
    vj[:n, :n] = np.einsum("pqrs, rs -> pq", g_aa, daa) \
        + np.einsum("pqrs, rs -> pq", g_ab, dbb)
    vj[n:, n:] = np.einsum("pqrs, rs -> pq", g_bb, dbb) \
        + np.einsum("rspq, rs -> pq", g_ab, daa)
    vk = np.zeros_like(dm_so)
    vk[:n, :n] = np.einsum("pqrs, rq -> ps", g_aa, daa)
    vk[n:, n:] = np.einsum("pqrs, rq -> ps", g_bb, dbb)
    vk[:n, n:] = np.einsum("plks, kl -> ps", g_ab, dba)
    vk[n:, :n] = vk[:n, n:].conj().T        # Hermitian D -> Hermitian K
    return vj, vk


def eri_to_gdf(eri_lo, ncells, nlo, tol=1e-10):
    """Convert a translation-invariant supercell ERI into per-transfer
    GDF factors (the reference's eri -> GDF conversion,
    pbc_helper.py:508) -- delegates to make_gdf_factors."""
    from libdmet_preview_tpu.ops.eri_transform import make_gdf_factors
    return make_gdf_factors(eri_lo, ncells, nlo, tol=tol)
