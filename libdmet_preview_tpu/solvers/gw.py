"""
Static GW-type self-energy for embedding double counting
(capability analog of /root/reference/libdmet/routine/qsgw_dc.py:18-180
get_vsig_emb, which the reference delegates to the external fcdmft GW
code; here computed natively).

The quantity DMET needs is the STATIC (QSGW-Hermitianized) self-energy of
the embedded mean field, to be subtracted from the embedding H1 when the
lattice mean field is a GW/QSGW one.  The native implementation is the
exact static limit (COHSEX) with RPA screening at omega = 0, evaluated in
a density-fitted (Cholesky) auxiliary space as GEMMs:

    chi0_xy = 4 sum_ia L[x,i,a] L[y,i,a] / (e_i - e_a)   (restricted)
    W       = (I - chi0)^{-1}                            (aux space)
    SEX_pq  = - sum_i  L[x,p,i] W_xy L[y,q,i]            (screened exchange)
    COH_pq  = 0.5 sum_r L[x,p,r] (W - I)_xy L[y,q,r]     (Coulomb hole)

Exact-limit oracle: with screening off (chi0 = 0), W = I, COH = 0 and
SEX is minus the restricted HF exchange -- vsig == fock - hcore - J.
"""

import numpy as np
from functools import partial

import jax
import jax.numpy as jnp

from libdmet_preview_tpu.utils import logger as log
from libdmet_preview_tpu.ops.eri_transform import cholesky_eri


@jax.jit
def _chi0_static(L_ov, e_occ, e_vir):
    """chi0_xy(0) = 4 sum_ia L[x,i,a] L[y,i,a] / (e_i - e_a)."""
    denom = e_occ[:, None] - e_vir[None, :]
    return 4.0 * jnp.einsum("xia, yia -> xy", L_ov / denom, L_ov,
                            optimize=True)


@partial(jax.jit, static_argnames=("nocc",))
def _sex_coh(L_mo, W, nocc):
    """Screened exchange + Coulomb hole in the MO basis."""
    naux = L_mo.shape[0]
    L_po = L_mo[:, :, :nocc]
    WL_po = jnp.einsum("xy, ypi -> xpi", W, L_po, optimize=True)
    sex = -jnp.einsum("xpi, xqi -> pq", L_po, WL_po, optimize=True)
    dW = W - jnp.eye(naux)
    WL = jnp.einsum("xy, ypr -> xpr", dW, L_mo, optimize=True)
    coh = 0.5 * jnp.einsum("xpr, xqr -> pq", L_mo, WL, optimize=True)
    return sex + coh


def get_vsig_emb(fock, eri, nelec, ovlp=None, chol_tol=1e-8,
                 screened=True):
    """Static (COHSEX) self-energy of an embedding mean field
    (reference qsgw_dc.py:18-127 get_vsig_emb contract).

    fock: (spin, n, n); eri: (spin_pair, n, n, n, n) chemist (restricted:
    one block); nelec: total electrons; ovlp: optional metric.
    Returns vsig (spin, n, n), Hermitian, in the input orbital basis."""
    fock = np.asarray(fock)
    if fock.ndim == 2:
        fock = fock[None]
    spin = fock.shape[0]
    n = fock.shape[-1]
    eri = np.asarray(eri)
    if eri.ndim == 4:
        eri = eri[None]
    if ovlp is None:
        S = np.eye(n)
    else:
        S = np.asarray(ovlp)
        if S.ndim == 3:
            S = S[0]
    w, v = np.linalg.eigh(S)
    A = v @ np.diag(w ** -0.5) @ v.T

    if spin == 1:
        nocc = nelec // 2
        e, c = np.linalg.eigh(A @ fock[0] @ A)
        C = A @ c
        L = cholesky_eri(eri[0], tol=chol_tol)
        L_mo = jnp.einsum("xpq, pi, qj -> xij", jnp.asarray(L),
                          jnp.asarray(C), jnp.asarray(C), optimize=True)
        naux = L_mo.shape[0]
        if screened and nocc > 0 and nocc < n:
            chi0 = _chi0_static(L_mo[:, :nocc, nocc:],
                                jnp.asarray(e[:nocc]),
                                jnp.asarray(e[nocc:]))
            W = jnp.linalg.inv(jnp.eye(naux) - chi0)
        else:
            W = jnp.eye(naux)
        vs_mo = np.asarray(_sex_coh(L_mo, W, int(nocc)))
        Cinv = C.T @ S
        vsig = Cinv.T @ vs_mo @ Cinv
        return 0.5 * (vsig + vsig.T)[None]

    # unrestricted: chi0 sums both spin channels (factor 2 per spin)
    nocc_s = ((nelec + 1) // 2, nelec // 2) if np.isscalar(nelec) \
        else tuple(nelec)
    Cs, es = [], []
    for s in range(2):
        e, c = np.linalg.eigh(A @ fock[s] @ A)
        Cs.append(A @ c)
        es.append(e)
    # spin-blocked factors from [aa, bb, ab]: screening needs one shared
    # aux space -- use the aa-block factors for both (valid when the
    # spatial ERI is spin-independent, the DMET embedding case)
    L = cholesky_eri(eri[0], tol=chol_tol)
    L_mos = [jnp.einsum("xpq, pi, qj -> xij", jnp.asarray(L),
                        jnp.asarray(Cs[s]), jnp.asarray(Cs[s]),
                        optimize=True) for s in range(2)]
    naux = L_mos[0].shape[0]
    if screened:
        chi0 = 0.0
        for s, no in enumerate(nocc_s):
            if 0 < no < n:
                chi0 = chi0 + 0.5 * _chi0_static(
                    L_mos[s][:, :no, no:], jnp.asarray(es[s][:no]),
                    jnp.asarray(es[s][no:]))
        W = jnp.linalg.inv(jnp.eye(naux) - chi0)
    else:
        W = jnp.eye(naux)
    out = []
    for s, no in enumerate(nocc_s):
        # unrestricted exchange carries the full same-spin sum
        L_po = L_mos[s][:, :, :no]
        WL_po = jnp.einsum("xy, ypi -> xpi", W, L_po, optimize=True)
        sex = -jnp.einsum("xpi, xqi -> pq", L_po, WL_po, optimize=True)
        dW = W - jnp.eye(naux)
        WL = jnp.einsum("xy, ypr -> xpr", dW, L_mos[s], optimize=True)
        coh = 0.5 * jnp.einsum("xpr, xqr -> pq", L_mos[s], WL,
                               optimize=True)
        vs_mo = np.asarray(sex + coh)
        Cinv = Cs[s].T @ S
        v = Cinv.T @ vs_mo @ Cinv
        out.append(0.5 * (v + v.T))
    return np.asarray(out)
