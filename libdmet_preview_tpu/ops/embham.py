"""
Schmidt bath construction and embedding-Hamiltonian transforms.

Replaces reference routine/slater.py:98-688 and routine/slater_helper.py:22-157.
All transforms are batched einsums on device:

  * bath = SVD of the (env x imp) block of the lattice 1-RDM (one svd per
    spin, device);
  * 1-body transform uses the k-space identity
        H_emb = (1/Nk) sum_k C_k^H H_k C_k        (transform_trans_inv_k)
    as one batched GEMM chain;
  * local-operator and local-ERI transforms contract over the cell axis of
    the R-space basis in single einsums (GEMM-friendly).
"""

import numpy as np
import jax
import jax.numpy as jnp
from functools import partial

from libdmet_preview_tpu.utils import logger as log
from libdmet_preview_tpu.utils.misc import add_spin_dim
from libdmet_preview_tpu.models.integral import Integral


# ----------------------------------------------------------------------
# basic transforms
# ----------------------------------------------------------------------

@jax.jit
def _trans_inv_k_pair(Cr, Ci, Hr, Hi):
    """Re[(1/nk) sum_k C_k^H H_k C_k] with (re, im) pairs; shapes
    (spin, nk, nlo, neo) and (spin, nk, nlo, nlo) -> (spin, neo, neo)."""
    nkpts = Cr.shape[1]
    Pr = jnp.einsum("skpq, skqj -> skpj", Hr, Cr) \
        - jnp.einsum("skpq, skqj -> skpj", Hi, Ci)
    Pi = jnp.einsum("skpq, skqj -> skpj", Hr, Ci) \
        + jnp.einsum("skpq, skqj -> skpj", Hi, Cr)
    res = jnp.einsum("skpi, skpj -> sij", Cr, Pr) \
        + jnp.einsum("skpi, skpj -> sij", Ci, Pi)
    return res / nkpts


def transform_h1(H1_k, basis_k):
    """Embedding transform of a k-space one-body operator.

    H1_k: (re, im) pair with shape ((spin,) nk, n, n);
    basis_k: (re, im) pair (spin, nk, n, neo).
    Returns real (spin, neo, neo).  Reference slater_helper.py:37-51."""
    Cr, Ci = jnp.asarray(basis_k[0]), jnp.asarray(basis_k[1])
    spin = Cr.shape[0]
    Hr, Hi = jnp.asarray(H1_k[0]), jnp.asarray(H1_k[1])
    if Hr.ndim == 3:
        Hr = jnp.broadcast_to(Hr[None], (spin,) + Hr.shape)
        Hi = jnp.broadcast_to(Hi[None], (spin,) + Hi.shape)
    elif Hr.shape[0] != spin:
        Hr = jnp.broadcast_to(Hr[:1], (spin,) + Hr.shape[1:])
        Hi = jnp.broadcast_to(Hi[:1], (spin,) + Hi.shape[1:])
    return _trans_inv_k_pair(Cr, Ci, Hr, Hi)


foldRho_k = transform_h1  # rdm1_lo_k folded to embedding space


@jax.jit
def transform_local(basis_R, H):
    """Local (single-cell) operator to embedding space:
    sum_R basis[R].T H basis[R].  basis_R: (ncells, nlo, neo), H: (nlo, nlo).
    Reference slater_helper.py:75-82."""
    return jnp.einsum("Rpi, pq, Rqj -> ij", basis_R, H, basis_R)


@jax.jit
def transform_imp(basis_R, H):
    """Impurity-cell-only operator: basis[0].T H basis[0]
    (reference slater_helper.py:104)."""
    return basis_R[0].T @ H @ basis_R[0]


def _spin_pairs(spin):
    """ccdd channel order (aa,) or (aa, bb, ab)."""
    return [(0, 0)] if spin == 1 else [(0, 0), (1, 1), (0, 1)]


def transform_eri_nearest(basis, eri_R, lattice=None):
    """Interacting-bath embedding transform of the 'nearest' H2 format
    (blocks (0p 0q | Rr Rs) = eri_R[R], translation invariant) -- beyond
    the reference, which raises NotImplementedError here
    (/root/reference/libdmet/routine/slater.py:405-408):

      H2_emb[ijkl] = sum_{C, R} B[C,p,i] B[C,q,j]
                     B[C+R,r,k] B[C+R,s,l] eri_R[R,p,q,r,s].

    lattice: required for multi-dimensional cell meshes -- the C+R cell
    addition must use the lattice's index algebra (the flattened C order
    of a 2D/3D mesh is NOT 1D-cyclic); falls back to 1D-cyclic when
    absent.
    """
    basis = np.asarray(basis)
    spin, ncells, nlo, neo = basis.shape
    eri_R = np.asarray(eri_R)
    B = jnp.asarray(basis)
    if lattice is not None:
        add = np.asarray(lattice._add_tab)
    else:
        add = (np.arange(ncells)[:, None]
               + np.arange(ncells)[None, :]) % ncells
    # P1[s][C, p, q, i, j] = B[s,C,p,i] B[s,C,q,j]
    P1 = jnp.einsum("sCpi, sCqj -> sCpqij", B, B)
    out = []
    for s1, s2 in _spin_pairs(spin):
        acc = 0.0
        for R in range(ncells):
            P2 = P1[s2][jnp.asarray(add[:, R])]   # cell C+R
            acc = acc + jnp.einsum("Cpqij, pqrs, Crskl -> ijkl",
                                   P1[s1], jnp.asarray(eri_R[R]), P2,
                                   optimize=True)
        out.append(np.asarray(acc))
    return np.asarray(out)


def transform_eri_full(basis, eri_F, lattice=None):
    """Interacting-bath embedding transform of the 'full' H2 format
    (eri_F[R1, R2, R3] = (0p R1q | R2r R3s), translation invariant):

      H2_emb[ijkl] = sum_{C, R1, R2, R3} B[C,p,i] B[C+R1,q,j]
                     B[C+R2,r,k] B[C+R3,s,l] eri_F[R1,R2,R3,p,q,r,s].

    lattice: required for multi-dimensional cell meshes (see
    transform_eri_nearest).
    """
    basis = np.asarray(basis)
    spin, ncells, nlo, neo = basis.shape
    eri_F = np.asarray(eri_F)
    B = jnp.asarray(basis)
    if lattice is not None:
        add = np.asarray(lattice._add_tab)
    else:
        add = (np.arange(ncells)[:, None]
               + np.arange(ncells)[None, :]) % ncells
    out = []
    for s1, s2 in _spin_pairs(spin):
        acc = 0.0
        for R1 in range(ncells):
            B1 = B[s1][jnp.asarray(add[:, R1])]
            for R2 in range(ncells):
                B2 = B[s2][jnp.asarray(add[:, R2])]
                for R3 in range(ncells):
                    B3 = B[s2][jnp.asarray(add[:, R3])]
                    acc = acc + jnp.einsum(
                        "Cpi, Cqj, Crk, Csl, pqrs -> ijkl",
                        B[s1], B1, B2, B3,
                        jnp.asarray(eri_F[R1, R2, R3]), optimize=True)
        out.append(np.asarray(acc))
    return np.asarray(out)


def transform_eri_spin_local(basis, eri_S):
    """Interacting-bath embedding transform of the 'spin local' H2 format
    (per-channel local ERIs (aa, bb, ab), same cell only):

      H2_emb[m][ijkl] = sum_C B[s1,C,p,i] B[s1,C,q,j]
                        B[s2,C,r,k] B[s2,C,s,l] eri_S[m,p,q,r,s].
    """
    basis = np.asarray(basis)
    spin, ncells, nlo, neo = basis.shape
    eri_S = np.asarray(eri_S)
    B = jnp.asarray(basis)
    out = []
    for m, (s1, s2) in enumerate(_spin_pairs(spin)):
        g = eri_S[min(m, eri_S.shape[0] - 1)]
        acc = jnp.einsum("Cpi, Cqj, Crk, Csl, pqrs -> ijkl",
                         B[s1], B[s1], B[s2], B[s2], jnp.asarray(g),
                         optimize=True)
        out.append(np.asarray(acc))
    return np.asarray(out)


@jax.jit
def transform_eri_local(basis_R, H2):
    """Local lattice ERI to embedding space, interacting-bath formalism
    (reference slater_helper.py:138-157).

    basis_R: (spin, ncells, nlo, neo); H2: (nlo,)*4 (same for both spins) or
    (3, nlo^4) spin-blocked.  Returns (spin*(spin+1)/2, neo^4) in libdmet
    order [aa, bb, ab].
    """
    spin = basis_R.shape[0]
    if H2.ndim == 4:
        H2aa = H2bb = H2ab = H2
    else:
        H2aa, H2bb, H2ab = H2[0], H2[1], H2[2]

    def t4(H, ba, bb):
        # sum over cells R: (pqrs, Rpi, Rqj, Rrk, Rsl -> ijkl); two-step
        # contraction keeps it a chain of GEMMs
        tmp = jnp.einsum("pqrs, Rpi, Rqj -> Rijrs", H, ba, ba, optimize=True)
        return jnp.einsum("Rijrs, Rrk, Rsl -> ijkl", tmp, bb, bb, optimize=True)

    if spin == 1:
        return t4(H2aa, basis_R[0], basis_R[0])[None]
    else:
        eri_aa = t4(H2aa, basis_R[0], basis_R[0])
        eri_bb = t4(H2bb, basis_R[1], basis_R[1])
        eri_ab = t4(H2ab, basis_R[0], basis_R[1])
        return jnp.stack([eri_aa, eri_bb, eri_ab])


def unit2emb(H2_unit, neo):
    """Pad a unit-cell ERI into the impurity corner of the embedding ERI
    (reference slater_helper.py:494-529)."""
    H2_unit = np.asarray(H2_unit)
    spin_pair = H2_unit.shape[0]
    n = H2_unit.shape[-1]
    H2 = np.zeros((spin_pair,) + (neo,) * 4)
    H2[:, :n, :n, :n, :n] = H2_unit
    return H2


# ----------------------------------------------------------------------
# JK builders from embedding ERI (reference solver/scf.py:255-353,
# slater.py:478-524)
# ----------------------------------------------------------------------

@jax.jit
def _get_veff_rhf(rdm1_tot, eri):
    """Restricted veff = J(rho_tot) - 0.5 K(rho_tot); rdm1_tot is the
    spin-traced density (reference scf.py:345-353 with spin == 1)."""
    vj = jnp.einsum("ijkl, kl -> ij", eri, rdm1_tot)
    vk = jnp.einsum("ilkj, kl -> ij", eri, rdm1_tot)
    return (vj - vk * 0.5)[None]


@jax.jit
def _get_vjk_rhf(rdm1_tot, eri):
    """Separate (J, K) of the spin-traced density (hybrid-aware dc)."""
    vj = jnp.einsum("ijkl, kl -> ij", eri, rdm1_tot)
    vk = jnp.einsum("ilkj, kl -> ij", eri, rdm1_tot)
    return vj, vk


@jax.jit
def _get_veff_uhf(rdm1, eri_aa, eri_bb, eri_ab):
    """Unrestricted veff; rdm1 (2, neo, neo), eri blocks in chemists'
    notation (ij|kl)."""
    rho_a, rho_b = rdm1[0], rdm1[1]
    vj_aa = jnp.einsum("ijkl, kl -> ij", eri_aa, rho_a)
    vj_bb = jnp.einsum("ijkl, kl -> ij", eri_bb, rho_b)
    vj_ab = jnp.einsum("ijkl, kl -> ij", eri_ab, rho_b)  # alpha feels beta
    vj_ba = jnp.einsum("klij, kl -> ij", eri_ab, rho_a)  # beta feels alpha
    vk_aa = jnp.einsum("ilkj, kl -> ij", eri_aa, rho_a)
    vk_bb = jnp.einsum("ilkj, kl -> ij", eri_bb, rho_b)
    va = vj_aa + vj_ab - vk_aa
    vb = vj_bb + vj_ba - vk_bb
    return jnp.stack([va, vb])


def get_veff(rdm1, eri):
    """Dispatch on spin structure (reference slater.py:478-524).
    rdm1: (spin, neo, neo); eri: (1 or 3, neo^4)."""
    rdm1 = jnp.asarray(rdm1)
    eri = jnp.asarray(eri)
    if rdm1.ndim == 2:
        rdm1 = rdm1[None]
    spin = rdm1.shape[0]
    if spin == 1:
        return _get_veff_rhf(rdm1[0], eri[0])
    else:
        return _get_veff_uhf(rdm1, eri[0], eri[1], eri[2])


# ----------------------------------------------------------------------
# bath construction
# ----------------------------------------------------------------------

def get_emb_basis(lattice, rdm1=None, local=True, kind="svd", **kwargs):
    """Embedding basis C_lo_eo, shape (spin, ncells, nlo, neo)
    (reference slater.py:98-220)."""
    if rdm1 is None:
        rdm1 = lattice.rdm1_lo_R
    rdm1 = np.asarray(rdm1).real
    if kind == "svd":
        return _get_emb_basis_svd(lattice, rdm1, **kwargs)
    raise ValueError("unknown bath kind %s" % kind)


embBasis = get_emb_basis


def _bath_vectors(A):
    """Left singular vectors + singular values of the tall (spin, nenv,
    ncol) environment-impurity RDM block.

    Fast path: the ncol x ncol Gram matrix eigendecomposition (sigma^2 =
    eig(A^T A), u = A V / sigma, + Newton-Schulz orthonormalization) -- one
    GEMM + tiny eigh instead of the tall SVD (the bench-validated bath
    construction, now the library default).
    Falls back to the exact SVD per spin channel whenever a singular value
    is small enough (< 1e-6 * sigma_max) that the Gram square would lose
    the truncation decision (tol_bath semantics, reference slater.py:181-196).
    """
    A = np.asarray(A)
    spin, nenv, ncol = A.shape
    if ncol == 0 or nenv == 0:
        return np.zeros((spin, nenv, ncol)), np.zeros((spin, ncol))
    G = np.einsum("spi, spj -> sij", A, A, optimize=True)
    w, V = np.linalg.eigh(G)
    w = w[:, ::-1]
    V = V[:, :, ::-1]
    smax = np.maximum(np.sqrt(np.maximum(w[:, 0], 0.0)), 1e-300)
    sigma = np.sqrt(np.maximum(w, 0.0))
    u = np.empty((spin, nenv, ncol))
    eye = np.eye(ncol)
    for s in range(spin):
        if sigma[s, -1] < 1e-6 * smax[s]:
            # ill-conditioned: exact thin SVD keeps sigma to full precision
            u_s, sig_s, _ = np.linalg.svd(A[s], full_matrices=False)
            u[s], sigma[s] = u_s, sig_s
            continue
        u[s] = A[s] @ V[s] / sigma[s][None, :]
        for _ in range(2):   # Newton-Schulz cleanup of roundoff
            g2 = u[s].T @ u[s]
            u[s] = u[s] @ (1.5 * eye - 0.5 * g2)
    return u, sigma


def _get_emb_basis_svd(lattice, rdm1, **kwargs):
    imp_idx = list(kwargs.get("imp_idx", lattice.imp_idx))
    val_idx = list(kwargs.get("val_idx", lattice.val_idx))
    valence_bath = kwargs.get("valence_bath", True)
    orth = kwargs.get("orth", True)
    tol_bath = kwargs.get("tol_bath", 1e-9)
    nbath = kwargs.get("nbath", None)

    ncells = lattice.ncells
    nlo = lattice.nscsites
    imp_idx_bath = val_idx if valence_bath else imp_idx
    env_idx = []
    virt_mask = []
    imp_set = set(imp_idx)
    bath_set = set(imp_idx_bath)
    for i in range(ncells * nlo):
        if i not in bath_set:
            env_idx.append(i)
            virt_mask.append(i in imp_set)
    env_idx = np.asarray(env_idx, dtype=int)
    virt_mask = np.asarray(virt_mask, dtype=bool)
    nimp = len(imp_idx)

    if rdm1.ndim == 3:
        rdm1 = rdm1[None]
    spin = rdm1.shape[0]

    if len(imp_idx_bath) > 0 and np.max(imp_idx_bath) >= nlo:
        big = lattice.expand(rdm1)
        rdm1_env_imp = big[:, env_idx][:, :, imp_idx_bath]
    else:
        rdm1_env_imp = rdm1.reshape(spin, ncells * nlo, nlo)[:, env_idx][:, :, imp_idx_bath]

    nbath_cols = len(imp_idx_bath)
    u, sigma = _bath_vectors(rdm1_env_imp)

    basis = np.zeros((spin, ncells * nlo, nimp + nbath_cols))
    nbath_final = nbath_cols
    for s in range(spin):
        if nbath is None:
            nbath_s = int((sigma[s] >= tol_bath).sum())
        else:
            nbath_s = nbath
        if nbath_s < nbath_cols:
            log.warn("bath: %d singular values below tol %.1e discarded",
                     nbath_cols - nbath_s, tol_bath)
        B = np.array(u[s][:, :nbath_s])
        if nbath_s > 0 and orth and virt_mask.any():
            B[virt_mask] = 0.0
            B = vec_lowdin(B)
        basis[s, imp_idx, :nimp] = np.eye(nimp)
        basis[s, env_idx, nimp:nimp + nbath_s] = B
        nbath_final = min(nbath_final, nbath_s)

    basis = basis[:, :, :nimp + nbath_final].reshape(
        spin, ncells, nlo, nimp + nbath_final)
    return basis


def vec_lowdin(B):
    """Symmetric (Lowdin) orthogonalization of column vectors."""
    S = B.T @ B
    w, v = np.linalg.eigh(S)
    w = np.maximum(w, 1e-14)
    return B @ (v * (w ** -0.5)) @ v.T


def basis_matching(basis):
    """Rotate alpha/beta bath columns for maximal overlap via SVD
    (reference dmet/HubPhSymm.py:37-48).  basis: (2, ..., nbath) with the
    bath-column axis last; all leading axes are contracted in the overlap."""
    basisA, basisB = np.asarray(basis[0]), np.asarray(basis[1])
    nb = basisA.shape[-1]
    S = basisA.reshape(-1, nb).T @ basisB.reshape(-1, nb)
    u, gamma, vt = np.linalg.svd(S)
    log.debug(0, "basis matching overlap: mean %.6f min %.6f",
              float(np.average(gamma)), float(np.min(gamma)))
    basisA = np.tensordot(basisA, u, axes=(basisA.ndim - 1, 0))
    basisB = np.tensordot(basisB, vt, axes=(basisB.ndim - 1, 1))
    return np.asarray([basisA, basisB])


# ----------------------------------------------------------------------
# embedding Hamiltonian
# ----------------------------------------------------------------------

def get_rho_glob_R(basis, lattice, rho_emb):
    """Global lattice density matrix from the embedded rdm1 by democratic
    partitioning over translated impurities
    (reference slater_helper.py:183-310):

      rho_glob[0p, Rq] = 1/2 (B_0 rho B_R^T + B_{-R} rho B_0^T)_pq

    basis: (spin, ncells, nlo, neo); rho_emb: (spin, neo, neo).
    Returns the stripe (spin, ncells, nlo, nlo)."""
    basis = np.asarray(basis)
    rho_emb = np.asarray(rho_emb)
    if rho_emb.ndim == 2:
        rho_emb = rho_emb[None]
    spin, ncells, nlo, neo = basis.shape
    b = jnp.asarray(basis)
    r = jnp.asarray(rho_emb)
    # two democratic estimates of the (0, R) stripe block (lattice stripe
    # convention: rho[R]_pq = <R p| rho |0 q>); the fragment translation
    # MUST use the lattice's cell-index algebra (a 2D/3D mesh is not
    # 1D-cyclic in the flattened C order)
    row = jnp.einsum("spi, sij, sRqj -> sRqp", b[:, 0], r, b)
    neg = np.asarray(lattice._neg_map)
    col = jnp.einsum("sRpi, sij, sqj -> sRqp", b[:, neg], r, b[:, 0])
    return np.asarray(0.5 * (row + col))


def get_veff_from_rdm1_emb(lattice, rdm1_emb, basis):
    """Lattice veff in the LO basis rebuilt from the embedded rdm1 via the
    democratic global density (reference slater.py:1842-1956): the charge
    self-consistency (DMET-CSC) update.

    Returns (veff_stripe (spin, ncells, nlo, nlo), rho_glob_stripe).
    Requires the 'cholesky' H2 format (ab initio lattices)."""
    log.eassert(lattice.H2_format == "cholesky",
                "veff rebuild implemented for the cholesky H2 format")
    rho_glob = get_rho_glob_R(basis, lattice, rdm1_emb)
    spin = rho_glob.shape[0]
    rho_full = np.asarray(lattice.expand(rho_glob))
    L = jnp.asarray(lattice.Ham.getH2())
    if spin == 1:
        # restricted convention: rho is the per-spin density
        dm_tot = jnp.asarray(rho_full[0] * 2.0)
        w = jnp.einsum("xpq, qp -> x", L, dm_tot)
        vj = jnp.einsum("x, xpq -> pq", w, L)
        vk = jnp.einsum("xpr, rs, xsq -> pq", L, dm_tot, L)
        veff_full = (vj - 0.5 * vk)[None]
    else:
        dms = jnp.asarray(rho_full)
        w = jnp.sum(jnp.einsum("xpq, sqp -> sx", L, dms), axis=0)
        vj = jnp.einsum("x, xpq -> pq", w, L)
        vk = jnp.einsum("xpr, srt, xtq -> spq", L, dms, L)
        veff_full = vj[None] - vk
    veff_full = np.asarray(veff_full)
    veff_stripe = np.asarray(lattice.extract_stripe(veff_full))
    return veff_stripe, rho_glob


def update_lattice_csc(lattice, rdm1_emb, basis):
    """One charge-self-consistency step: fock <- hcore + veff(rho_glob)
    (reference update_Ham/test_csc workflow).  Updates the lattice in
    place and returns (max fock change, veff stripe) — the veff can be
    fed to the DMET energy functional (get_H_dmet(veff=...),
    reference test_csc.py:186-194)."""
    veff_stripe, rho_glob = get_veff_from_rdm1_emb(lattice, rdm1_emb, basis)
    spin = veff_stripe.shape[0]
    hcore = np.asarray(lattice.hcore_lo_R)
    if hcore.ndim == 3:
        hcore = hcore[None] if spin == 1 else np.asarray([hcore, hcore])
    fock_new = hcore[:spin] + veff_stripe
    if spin == 1:
        fock_new = fock_new[0]
    dfock = float(np.max(np.abs(fock_new - np.asarray(lattice.fock_lo_R))))
    lattice.fock_lo_R = fock_new
    lattice.fock_lo_k = lattice._pairify(lattice.R2k(fock_new))
    lattice.rdm1_lo_R = rho_glob * (2.0 if spin == 1 else 1.0)
    lattice.rdm1_lo_k = lattice._pairify(lattice.R2k(lattice.rdm1_lo_R))
    return dfock, veff_stripe


def get_E1_from_glob(lattice, rdm1_emb, basis):
    """Fragment 1-body energy from the democratic global rdm
    (reference test_E1_from_glob variant): E1 = sum_R tr(h(R) rho_glob(R))
    per cell (restricted: rho_glob is per-spin, factor 2)."""
    rho_glob = get_rho_glob_R(basis, lattice, rdm1_emb)
    spin = rho_glob.shape[0]
    h = np.asarray(lattice.getH1(kspace=False))
    if h.ndim == 3:
        h = h[None] if spin == 1 else np.asarray([h, h])
    E1 = np.einsum("sRpq, sRpq ->", h[:spin], rho_glob)
    return float(E1) * (2.0 if spin == 1 else 1.0)


def get_rdm1_idem(rho_glob_R, nelec_tot, kmesh):
    """Project the (non-idempotent) democratic global rdm onto the nearest
    idempotent density with the same electron count -- the pDMET step
    (reference slater_helper.py:380, used by test_pdmet/test_idem_fit).

    rho_glob_R: (spin, ncells, nlo, nlo) stripe, per-spin convention for
    spin == 1 (nelec_tot then counts PER-SPIN electrons).  Diagonalizes in
    k space (translation invariance) and refills by aufbau.
    Returns the idempotent stripe."""
    from libdmet_preview_tpu.ops import zlinalg, mfd
    rho_glob_R = np.asarray(rho_glob_R)
    spin = rho_glob_R.shape[0]
    if np.isscalar(nelec_tot):
        nelec_tot = [nelec_tot] * spin
    r_re, r_im = zlinalg.R2k(rho_glob_R, tuple(int(x) for x in kmesh))
    out = []
    for s in range(spin):
        ew2, V = zlinalg.zeigh(jnp.asarray(np.asarray(r_re)[s]),
                               jnp.asarray(np.asarray(r_im)[s]))
        ew2 = np.asarray(ew2)
        # occupy the LARGEST natural occupations (doubled spectrum -> 2x)
        occ2, mu, _ = mfd.assignocc(-ew2, int(round(2 * nelec_tot[s])),
                                    np.inf, 0.0)
        rho_re, rho_im = zlinalg.zfunc_from_eig(V, jnp.asarray(occ2))
        out.append(np.asarray(zlinalg.k2R(
            (np.asarray(rho_re), np.asarray(rho_im)),
            tuple(int(x) for x in kmesh))))
    return np.asarray(out)


def get_emb_Ham(lattice, basis, vcor, local=True, int_bath=True, **kwargs):
    """Build the embedding Hamiltonian Integral object
    (reference slater.py:320-688)."""
    basis = np.asarray(basis)
    spin = basis.shape[0]
    neo = basis.shape[-1]

    H2 = _emb_H2(lattice, basis, vcor, int_bath=int_bath, **kwargs)
    H1, ovlp_emb = _emb_H1(lattice, basis, vcor, H2, int_bath=int_bath, **kwargs)
    H0 = lattice.getH0()
    ImpHam = Integral(neo, spin == 1, False, H0, {"cd": H1}, {"ccdd": H2},
                      ovlp=ovlp_emb)
    return ImpHam, None


embHam = get_emb_Ham


def _emb_H2(lattice, basis, vcor, int_bath=True, **kwargs):
    spin = basis.shape[0]
    neo = basis.shape[-1]
    nsc = lattice.nscsites
    npair = spin * (spin + 1) // 2
    if lattice.H2_format in ("cholesky", "aft"):
        # ab initio path: factorized ERI transform (the reference
        # eri_transform.get_emb_eri role)
        from libdmet_preview_tpu.ops.eri_transform import get_emb_eri_chol
        if int_bath:
            if lattice.H2_format == "aft":
                # stream the embedding ERI straight from the analytic
                # pair FT (reference AFT driver role,
                # eri_transform.py:566-779) -- no supercell two-body
                # object is ever materialized (3D k-mesh scaling path)
                Ham = lattice.Ham
                C = np.asarray(Ham.C_ao_lo)
                df_mode = getattr(Ham, "df_mode", "aft")
                drv = {"aft": Ham.aft_cell.get_emb_eri_aft,
                       # uniform-grid FFT-DF driver (reference FFTDF
                       # role, eri_transform.py get_emb_eri_fft)
                       "fft": Ham.aft_cell.get_emb_eri_fft,
                       # range-separated driver (reference MDF role,
                       # eri_transform.py:566-1087)
                       "rs": Ham.aft_cell.get_emb_eri_rs}[df_mode]
                drv_x = {"aft": Ham.aft_cell.get_emb_eri_aft_cross,
                         "fft": Ham.aft_cell.get_emb_eri_fft_cross,
                         "rs": Ham.aft_cell.get_emb_eri_rs_cross}[df_mode]
                out = []
                for s in range(spin):
                    B = np.asarray(basis[s]).reshape(-1, neo)
                    out.append(drv(C @ B))
                if spin == 2:
                    Ba = np.asarray(basis[0]).reshape(-1, neo)
                    Bb = np.asarray(basis[1]).reshape(-1, neo)
                    out.append(drv_x(C @ Ba, C @ Bb))
                return np.asarray(out)
            return get_emb_eri_chol(lattice.Ham.getH2(), basis)
        eri_imp = np.asarray(lattice.Ham.eri_imp)
        if eri_imp.ndim == 5:     # spin-blocked (aa, bb, ab) unit-cell ERI
            return unit2emb(eri_imp, neo)
        return unit2emb(np.asarray((eri_imp,) * npair), neo)
    LatH2 = np.asarray(lattice.getH2(kspace=False))
    if lattice.H2_format == "local":
        if int_bath:
            H2 = np.asarray(transform_eri_local(jnp.asarray(basis),
                                                jnp.asarray(LatH2)))
        else:
            H2 = unit2emb(np.asarray((LatH2,) * npair), neo)
    elif lattice.H2_format == "nearest":
        if int_bath:
            H2 = transform_eri_nearest(basis, LatH2, lattice=lattice)
        else:
            H2 = np.zeros((npair,) + (neo,) * 4)
            H2[:, :nsc, :nsc, :nsc, :nsc] = LatH2[0]
    elif lattice.H2_format == "full":
        if int_bath:
            H2 = transform_eri_full(basis, LatH2, lattice=lattice)
        else:
            H2 = np.zeros((npair,) + (neo,) * 4)
            H2[:, :nsc, :nsc, :nsc, :nsc] = LatH2[0, 0, 0]
    elif lattice.H2_format == "spin local":
        if int_bath:
            H2 = transform_eri_spin_local(basis, LatH2)
        else:
            H2 = np.zeros((npair,) + (neo,) * 4)
            for i in range(npair):
                H2[i, :nsc, :nsc, :nsc, :nsc] = LatH2[i]
    else:
        raise ValueError("unknown H2 format %s" % lattice.H2_format)
    return H2


def _emb_H1(lattice, basis, vcor, H2_emb, int_bath=True, add_vcor=False,
            **kwargs):
    spin = basis.shape[0]
    basis_j = jnp.asarray(basis)
    basis_k = lattice.R2k_basis(basis)
    hcore_k = lattice.getH1(kspace=True)
    fock_k = lattice.getFock(kspace=True)
    ovlp_k = lattice.get_ovlp(kspace=True)

    hcore_emb = np.asarray(transform_h1(hcore_k, basis_k))
    ovlp_emb = np.asarray(transform_h1(ovlp_k, basis_k))
    if ovlp_emb.ndim == 3 and ovlp_emb.shape[0] == 1:
        ovlp_emb = ovlp_emb[0]

    if int_bath:
        rdm1_emb = np.asarray(foldRho_k(lattice.rdm1_lo_k, basis_k))
        H1 = np.asarray(transform_h1(fock_k, basis_k))
        xc_dc = getattr(lattice, "xc_dc", None)
        if xc_dc is not None:
            # DFT-in-DMET double counting (reference slater.py:525-688
            # vxc handling + pdft_helper roles): the lattice fock is a KS
            # fock (hcore + J + vxc [+ hyb HF-x]); remove the mean field
            # the embedded electrons generate for themselves -- Coulomb +
            # hybrid HF exchange + the xc potential evaluated AT the
            # folded density (exact HF-limit identity: hyb=1, vxc=0
            # reproduces the standard interacting-bath branch)
            hyb = float(getattr(lattice, "xc_hyb", 0.0))
            log.eassert(spin == 1, "DFT-in-DMET dc: restricted path")
            vj, vk = _get_vjk_rhf(jnp.asarray(rdm1_emb[0]),
                                  jnp.asarray(H2_emb[0]))
            JK_emb = np.asarray(vj - 0.5 * hyb * vk)[None]
            B = basis[0].reshape(-1, basis.shape[-1])
            rho_fold_lo = B @ rdm1_emb[0] @ B.T
            vxc_lo = np.asarray(xc_dc(rho_fold_lo))
            JK_emb = JK_emb + (B.T @ vxc_lo @ B)[None]
        else:
            JK_emb = np.asarray(get_veff(rdm1_emb, jnp.asarray(H2_emb)))
        H1 = H1 - JK_emb
        lattice.JK_core = H1 - hcore_emb
    else:
        add_vcor = True
        if lattice.use_hcore_as_emb_ham:
            H1 = hcore_emb.copy()
            lattice.JK_core = None
        else:
            H1 = np.asarray(transform_h1(fock_k, basis_k))
            JK_imp = lattice.getImpJK()
            if JK_imp is not None:
                JK_imp = np.asarray(JK_imp)
                if JK_imp.ndim == 2:
                    JK_emb = np.asarray([
                        np.asarray(transform_imp(basis_j[s], jnp.asarray(JK_imp)))
                        for s in range(spin)])
                else:
                    JK_emb = np.asarray([
                        np.asarray(transform_imp(basis_j[s], jnp.asarray(JK_imp[s])))
                        for s in range(spin)])
            else:
                rdm1_emb = np.asarray(foldRho_k(lattice.rdm1_lo_k, basis_k))
                JK_emb = np.asarray(get_veff(rdm1_emb, jnp.asarray(H2_emb)))
            H1 = H1 - JK_emb
            lattice.JK_core = H1 - hcore_emb

    if add_vcor:
        log.eassert(vcor.islocal(), "nonlocal vcor not supported here")
        vmat = np.asarray(vcor.get())
        for s in range(spin):
            # vcor acts on the environment only: add everywhere, subtract the
            # impurity-cell copy (reference slater.py:668-688)
            H1[s] += np.asarray(transform_local(basis_j[s], jnp.asarray(vmat[s])))
            if not kwargs.get("fitting", False):
                H1[s] -= np.asarray(transform_imp(basis_j[s], jnp.asarray(vmat[s])))
    return H1, ovlp_emb


def add_bath(lattice, basis, ew, ev, nocc, nfrac, tol_bath=1e-6):
    """Enlarge the embedding basis with bath orbitals built from the
    nfrac*2 mean-field levels around the Fermi level (reference
    slater.py:2278-2363 add_bath capability, re-derived: real span of the
    frontier Bloch orbitals, orthogonalized against the current basis).

    basis: (spin, ncells, nlo, neo) or (ncells, nlo, neo);
    ew: (nk, n) per-k mo energies (physical, undoubled);
    ev: per-k mo coefficients, complex (nk, n, n) or a (re, im) pair;
    nocc: total occupied count over the lattice; nfrac: half-window size.
    Returns the enlarged basis with <= 2*nfrac extra orthonormal columns
    (vectors already inside the embedding span are dropped)."""
    from libdmet_preview_tpu.ops.zlinalg import dft_tables
    basis = np.asarray(basis)
    squeeze = basis.ndim == 3
    if squeeze:
        basis = basis[None]
    spin, ncells, nlo, neo = basis.shape
    ew = np.asarray(ew)
    nk, n = ew.shape
    if isinstance(ev, (tuple, list)):
        ev = np.asarray(ev[0]) + 1j * np.asarray(ev[1])
    else:
        ev = np.asarray(ev)

    # frontier window on the global spectrum
    idx = np.argsort(ew, axis=None, kind="mergesort")
    sel = idx[max(nocc - nfrac, 0):nocc + nfrac]
    k_idx, m_idx = np.divmod(sel, n)
    e_sel = ew.ravel()[sel]

    # lattice-space Bloch vectors V[(R, p), i] = e^{+ik.R} v_p(k) / sqrt(nk)
    cos_t, sin_t = dft_tables(tuple(int(x) for x in lattice.kmesh))
    ph = (cos_t + 1j * sin_t) / np.sqrt(nk)          # [k, R]
    V = np.empty((ncells * nlo, len(sel)), dtype=complex)
    for i, (k, m) in enumerate(zip(k_idx, m_idx)):
        V[:, i] = np.kron(ph[k], ev[k][:, m])

    # real frontier subspace: spectral projector weighted to keep ordering
    shift = e_sel.min() - 0.1
    h = (V * (e_sel - shift)) @ V.conj().T
    if np.abs(h.imag).max() > tol_bath:
        log.warn("add_bath: projector has imaginary part %.2e "
                 "(frontier window breaks time reversal)",
                 np.abs(h.imag).max())
    w, u = np.linalg.eigh(h.real)
    keep = w > tol_bath
    u = u[:, keep][:, -len(sel):]

    out = []
    for s in range(spin):
        B = basis[s].reshape(ncells * nlo, neo)
        for i in range(u.shape[1]):
            v = u[:, i]
            v = v - B @ (B.T @ v)
            nv = np.linalg.norm(v)
            if nv > tol_bath:
                B = np.hstack([B, (v / nv)[:, None]])
        out.append(B)
    nmax = min(b.shape[1] for b in out)
    basis_out = np.asarray([b[:, :nmax] for b in out]).reshape(
        spin, ncells, nlo, nmax)
    return basis_out[0] if squeeze else basis_out


def get_rdm2_glob_R(basis, lattice, rdm2_emb):
    """Global lattice rdm2 stripe from the embedded rdm2 by 4-anchor
    democratic partitioning (reference slater_helper.py:311-363
    get_rdm2_glob_R):

      G[J,K,L]_{ijkl} = 1/4 sum_{anchor in (0,J,K,L)}
          (B_{0-a} x B_{J-a} x B_{K-a} x B_{L-a}) . rdm2_emb

    basis: (spin, ncells, nlo, neo) or (ncells, nlo, neo) (restricted /
    one species); rdm2_emb: (neo,)*4 chemist.  Returns
    (ncells, ncells, ncells, nlo, nlo, nlo, nlo)."""
    basis = np.asarray(basis)
    if basis.ndim == 4:
        basis = basis[0]
    ncells, nlo, neo = basis.shape
    r2 = jnp.asarray(rdm2_emb)
    b = jnp.asarray(basis)

    @jax.jit
    def term(bI, bJ, bK, bL):
        return jnp.einsum("pqrs, ip, jq, kr, ls -> ijkl", r2,
                          bI, bJ, bK, bL, optimize=True)

    out = np.zeros((ncells,) * 3 + (nlo,) * 4)
    for J in range(ncells):
        for K in range(ncells):
            for L in range(ncells):
                acc = 0.0
                for a in (0, J, K, L):
                    acc = acc + term(b[lattice.subtract(0, a)],
                                     b[lattice.subtract(J, a)],
                                     b[lattice.subtract(K, a)],
                                     b[lattice.subtract(L, a)])
                out[J, K, L] = 0.25 * np.asarray(acc)
    return out
