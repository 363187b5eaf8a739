"""
GSO / spinless formalism: partial particle-hole transform
(JAX rewrite of the reference's spinless stack,
/root/reference/libdmet/routine/spinless.py,
/root/reference/libdmet/routine/spinless_helper.py:48-441,
/root/reference/libdmet/routine/pbc_helper.py:1129-1330).

The spin-beta sector is particle-hole transformed (b_i = beta_i^dagger), so
superconducting pairing becomes a NUMBER-CONSERVING one-body term in a
2*nao "generalized spin orbital" (GSO) space.  Mean field = GHF over k;
the embedded problem is a single-species (spinless) FCI/CC problem.

Everything is complex-free: k-space operators are (re, im) pairs.

Conventions (matching the reference):
  compact H1 = [HA, -HB, HD] with GH0 = sum_k tr(HB)/nk
  combined GH1(k) = [[HA(k), HD(k)], [HD(k)^H, -HB(k)]]
  compact rdm = [rho_A, I - rho_B, kappa_AB], kappa_AB[p,q] = <b_q a_p>
  physical electron count n_phys = tr(G_aa) - tr(G_bb) + nao (per cell)
"""

import numpy as np
import jax
import jax.numpy as jnp

from libdmet_preview_tpu.utils import logger as log
from libdmet_preview_tpu.ops import zlinalg
from libdmet_preview_tpu.ops.ftsystem import fermi_smearing_occ


# ----------------------------------------------------------------------
# particle-hole transforms
# ----------------------------------------------------------------------

def transform_H1_k(H1_k):
    """k-space H1 -> spinless compact form.

    H1_k: (re, im) pair, shape ((spin,) nk, nao, nao); spin components are
    [HA] or [HA, HB] or [HA, HB, HD].
    Returns (GH1_re, GH1_im) shape (3, nk, nao, nao) = [HA, -HB, HD] and
    the constant GH0 = mean_k tr(HB(k)) (real)."""
    re, im = np.asarray(H1_k[0]), np.asarray(H1_k[1])
    if re.ndim == 3:
        re, im = re[None], im[None]
    spin = re.shape[0]
    nk, nao = re.shape[1], re.shape[-1]
    HA_re, HA_im = re[0], im[0]
    HB_re, HB_im = (re[1], im[1]) if spin > 1 else (re[0], im[0])
    HD_re = re[2] if spin > 2 else np.zeros_like(HA_re)
    HD_im = im[2] if spin > 2 else np.zeros_like(HA_im)
    GH1_re = np.asarray([HA_re, -HB_re, HD_re])
    GH1_im = np.asarray([HA_im, -HB_im, HD_im])
    GH0 = float(np.einsum("kii ->", HB_re)) / nk
    return (GH1_re, GH1_im), GH0


def combine_H1_k(GH1):
    """compact (3, nk, nao, nao) pair -> full (nk, nso, nso) pair:
    [[A, D], [D^H, B]] (B already carries the -HB sign)."""
    re, im = np.asarray(GH1[0]), np.asarray(GH1[1])
    nk, nao = re.shape[1], re.shape[-1]
    nso = 2 * nao
    out_re = np.zeros((nk, nso, nso))
    out_im = np.zeros((nk, nso, nso))
    out_re[:, :nao, :nao] = re[0]
    out_im[:, :nao, :nao] = im[0]
    out_re[:, nao:, nao:] = re[1]
    out_im[:, nao:, nao:] = im[1]
    out_re[:, :nao, nao:] = re[2]
    out_im[:, :nao, nao:] = im[2]
    out_re[:, nao:, :nao] = re[2].transpose(0, 2, 1)
    out_im[:, nao:, :nao] = -im[2].transpose(0, 2, 1)
    return out_re, out_im


def transform_H2_local(H2):
    """Local (restricted-storage) H2 -> spinless form.

    Returns GV2 (3, nao, nao, nao, nao) = [aa, bb, ab] blocks over the two
    GSO species, GV1 (3, nao, nao) one-body correction [on A, on B, on D],
    GV0 constant per cell (reference pbc_helper.py:1129-1237)."""
    H2 = np.asarray(H2)
    nao = H2.shape[-1]
    vj = np.einsum("ijkk -> ij", H2)
    vk = np.einsum("ikkj -> ij", H2)
    GV2 = np.asarray([H2, H2, -H2])
    GV1 = np.zeros((3, nao, nao))
    GV1[0] = vj
    GV1[1] = vk - vj
    GV0 = 0.5 * float(np.trace(vj)) - 0.5 * float(np.trace(vk))
    return GV2, GV1, GV0


def get_GV1_GV0_from_chol(L):
    """Particle-hole normal-ordering of a DF-factorized FULL-lattice
    interaction against the filled-beta sea (reference
    pbc_helper.py:1344 get_GV1_GV0_from_df, specialized to orthonormal
    LOs where the sea density is the identity).

    L: (naux, nsites, nsites) Cholesky/GDF factors of the supercell ERI
    in the LO basis.  Returns GV1 (3, nsites, nsites) = [on A, on B,
    on D] supercell one-body corrections and the constant GV0 per
    SUPERCELL:

      vj = sum_x L_x tr(L_x),   vk = sum_x L_x @ L_x
      GV1 = [vj, vk - vj, 0],   GV0 = (tr vj - tr vk) / 2
    """
    Lj = jnp.asarray(L)
    trL = jnp.einsum("xpp -> x", Lj)
    vj = np.asarray(jnp.einsum("x, xpq -> pq", trL, Lj))
    vk = np.asarray(jnp.einsum("xpr, xrq -> pq", Lj, Lj))
    GV1 = np.zeros((3,) + vj.shape)
    GV1[0] = vj
    GV1[1] = vk - vj
    GV0 = 0.5 * float(np.trace(vj) - np.trace(vk))
    return GV1, GV0


def get_veff_ghf(GRho, g):
    """GHF-frame veff J - K from a dense (chemist) ERI over the full
    GSO index space (reference slater.get_veff(..., ghf=True) role).

    GRho: (n, n) GSO density; g: (n, n, n, n) with g[p,q,r,s] = (pq|rs).
    """
    GRho_j = jnp.asarray(GRho)
    gj = jnp.asarray(g)
    vj = jnp.einsum("pqrs, sr -> pq", gj, GRho_j)
    vk = jnp.einsum("prsq, rs -> pq", gj, GRho_j)
    return np.asarray(vj - vk)


def transform_rdm1_k(rdm1_k):
    """Physical k-space rdm1 (spin comps [rA, rB(, kBA)]) -> GSO compact
    [rho_A, I - rho_B, kappa_AB]."""
    re, im = np.asarray(rdm1_k[0]), np.asarray(rdm1_k[1])
    if re.ndim == 3:
        re, im = re[None], im[None]
    spin = re.shape[0]
    nk, nao = re.shape[1], re.shape[-1]
    eye = np.tile(np.eye(nao), (nk, 1, 1))
    rB_re, rB_im = (re[1], im[1]) if spin > 1 else (re[0], im[0])
    kap_re = re[2] if spin > 2 else np.zeros_like(re[0])
    kap_im = im[2] if spin > 2 else np.zeros_like(im[0])
    G_re = np.asarray([re[0], eye - rB_re, kap_re])
    G_im = np.asarray([im[0], -rB_im, kap_im])
    return G_re, G_im


def extract_rdm(GRho):
    """Full R=0 (or embedding) GSO density (nso, nso) ->
    (rho_A, rho_B, kappa_BA) physical blocks.
    GRho = [[rho_A, kappa_AB], [kappa_AB^T, I - rho_B^T]]."""
    GRho = np.asarray(GRho)
    nao = GRho.shape[-1] // 2
    rho_A = GRho[:nao, :nao]
    rho_B = np.eye(nao) - GRho[nao:, nao:].T
    kappa_AB = GRho[:nao, nao:]
    return rho_A, rho_B, kappa_AB


def mu_matrix(mu, nao):
    """Physical chemical potential in the GSO rep: -mu*n_a + mu*n_b
    (constant -mu*nao per cell tracked by the caller)."""
    return np.diag(np.concatenate([np.full(nao, -mu), np.full(nao, mu)]))


def n_phys_from_GRho(GRho_R0_trace_a, GRho_R0_trace_b, nao):
    return GRho_R0_trace_a - GRho_R0_trace_b + nao


# ----------------------------------------------------------------------
# GHF mean field on the combined GSO Hamiltonian
# ----------------------------------------------------------------------

def GHF(GFock_k, filling_T=0.5, beta=np.inf, mu0=0.0, fix_mu=False,
        **kwargs):
    """Diagonalize the (nk, nso, nso) GSO Fock and fill with the
    TRANSFORMED filling (0.5 at Sz=0).  Returns (GRho_R, mu_T, E, res).

    GFock_k: (re, im) pair.  E is the transformed-frame 1-body energy
    sum_k tr(F rho)/nk (no H0)."""
    from libdmet_preview_tpu.ops import mfd
    f_re, f_im = np.asarray(GFock_k[0]), np.asarray(GFock_k[1])
    nk, nso = f_re.shape[0], f_re.shape[-1]
    ew2_dev, V_dev = zlinalg.zeigh(jnp.asarray(f_re), jnp.asarray(f_im))
    ew2 = np.asarray(ew2_dev)
    nelec2 = int(np.round(ew2.size * filling_T))
    ew_sorted = np.sort(ew2, axis=None)
    mu0_T = mfd._default_mu(ew_sorted, nelec2)
    ewocc2, mu_T, nerr = mfd.assignocc(ew2, nelec2, beta, mu0_T,
                                       fix_mu=fix_mu)
    rho_re, rho_im = zlinalg.zfunc_from_eig(V_dev, jnp.asarray(ewocc2))
    rho_re, rho_im = np.asarray(rho_re), np.asarray(rho_im)
    E = float(np.sum(f_re * rho_re) + np.sum(f_im * rho_im)) / nk
    res = {"e": ew2, "rho_k": (rho_re, rho_im), "nerr": nerr, "E": E,
           "mo_occ": ewocc2}
    return rho_re, mu_T, E, res


def GHF_mu_fit(lattice, GH1_k, vcor_mat, filling_phys, mu0=0.0,
               beta=np.inf, tol=1e-9, max_iter=80, **kwargs):
    """Fit the physical chemical potential so that the physical electron
    count matches filling_phys (reference spinless mono_fit over mu).

    GH1_k: combined (nk, nso, nso) pair; vcor_mat: (nso, nso) local GSO
    correlation potential (already combined).  Returns
    (GRho_R, mu, res) with GRho_R the real stripe (ncells, nso, nso)."""
    f_re0, f_im0 = np.asarray(GH1_k[0]), np.asarray(GH1_k[1])
    nk, nso = f_re0.shape[0], f_re0.shape[-1]
    nao = nso // 2
    target = filling_phys * 2.0 * nao  # physical electrons per cell

    def n_phys(mu):
        f_re = f_re0 + vcor_mat + mu_matrix(mu, nao)
        rho_k_re, _, _, res = GHF((f_re, f_im0), beta=beta, **kwargs)
        rho_R0 = np.asarray(lattice.k2R(res["rho_k"]))[0]
        tr_a = float(np.trace(rho_R0[:nao, :nao]))
        tr_b = float(np.trace(rho_R0[nao:, nao:]))
        return n_phys_from_GRho(tr_a, tr_b, nao), res

    # bracket and bisect (n_phys is monotone non-decreasing in mu)
    lo, hi = mu0 - 1.0, mu0 + 1.0
    n_lo = n_phys(lo)[0]
    n_hi = n_phys(hi)[0]
    it = 0
    while n_lo > target and it < 30:
        lo -= 2.0
        n_lo = n_phys(lo)[0]
        it += 1
    it = 0
    while n_hi < target and it < 30:
        hi += 2.0
        n_hi = n_phys(hi)[0]
        it += 1
    mu = mu0
    for _ in range(max_iter):
        mu = 0.5 * (lo + hi)
        n_mu, res = n_phys(mu)
        if abs(n_mu - target) < tol:
            break
        if n_mu < target:
            lo = mu
        else:
            hi = mu
    n_mu, res = n_phys(mu)
    GRho_R = np.asarray(lattice.k2R(res["rho_k"]))
    res["mu"] = mu
    res["nelec_phys"] = n_mu
    return GRho_R, mu, res


# ----------------------------------------------------------------------
# embedding: bath, Hamiltonian
# ----------------------------------------------------------------------

def get_emb_basis(lattice, GRho_R, localize_bath=None, **kwargs):
    """Schmidt bath for the GSO density: SVD of the environment block
    against the impurity-cell columns (all nso of cell 0)
    (reference spinless.py:34-273).  GRho_R: (ncells, nso, nso) stripe.

    localize_bath='scdm' rotates the bath columns by SCDM (reference
    embBasis(localize_bath=...) option; a unitary rotation of the bath
    block leaves the embedding space, hence the DMET solution, invariant).
    Returns basis (1, ncells, nso, neo), neo = 2*nso."""
    GRho_R = np.asarray(GRho_R)
    if GRho_R.ndim == 4:
        GRho_R = GRho_R[0]
    ncells, nso = GRho_R.shape[0], GRho_R.shape[-1]
    flat = GRho_R.reshape(ncells * nso, nso)
    env = flat[nso:]                        # environment rows
    u, s, _ = np.linalg.svd(env, full_matrices=False)
    if localize_bath == "scdm":
        from libdmet_preview_tpu.lo.scdm import scdm
        u = scdm(u)
    neo = 2 * nso
    basis = np.zeros((ncells * nso, neo))
    basis[:nso, :nso] = np.eye(nso)
    basis[nso:, nso:] = u
    return basis.reshape(1, ncells, nso, neo)


def transform_eri_local_gso(basis_Ra, basis_Rb, GV2):
    """Embedding ERI from the LOCAL species-blocked spinless interaction
    (reference spinless_helper.py:319-348).

    basis_Ra/b: (ncells, nao, neo) species sub-blocks of the bath basis.
    GV2: (3, nao, nao, nao, nao) = [aa, bb, ab].
    Returns g_emb (neo,)*4 chemist, symmetric under (pq)<->(rs)."""
    Ra, Rb = jnp.asarray(basis_Ra), jnp.asarray(basis_Rb)
    vaa, vbb, vab = (jnp.asarray(x) for x in GV2)

    def t4(V, B1, B2):
        # sum_R (B1[R] B1[R] | B2[R] B2[R]) with local V
        return jnp.einsum("pqrs, Rpi, Rqj, Rrk, Rsl -> ijkl", V,
                          B1, B1, B2, B2, optimize=True)

    g = t4(vaa, Ra, Ra) + t4(vbb, Rb, Rb)
    gab = jnp.einsum("pqrs, Rpi, Rqj, Rrk, Rsl -> ijkl", vab,
                     Ra, Ra, Rb, Rb, optimize=True)
    g = g + gab + jnp.transpose(gab, (2, 3, 0, 1))
    return np.asarray(g)


def combine_vcor(vcor_mat3):
    """[va, vb, D] physical blocks -> combined GSO local matrix
    [[va, D], [D^T, -vb^T]] (the ph transform of the vcor operator;
    the per-cell constant tr(vb) carries zero democratic weight and is
    dropped)."""
    va, vb, D = np.asarray(vcor_mat3)
    nao = va.shape[-1]
    out = np.zeros((2 * nao, 2 * nao))
    out[:nao, :nao] = va
    out[nao:, nao:] = -vb.T
    out[:nao, nao:] = D
    out[nao:, :nao] = D.T
    return out


def get_emb_Ham(lattice, basis, GH1_k, GV2, GV1, H0, mu, last_dmu=0.0,
                vcor_gso=None, **kwargs):
    """GSO embedding Hamiltonian (non-interacting-bath flavor: lattice
    hcore + local interaction on the impurity cell)
    (reference spinless.py:431-726).

    GH1_k: combined (nk, nso, nso) pair (WITHOUT mu, WITHOUT GV1);
    GV1: (3, nao, nao) local one-body from the H2 transform, added on the
    impurity cell's species blocks.  Returns an Integral over neo spinless
    orbitals (restricted storage, ghf semantics) with
    nelec_emb = neo // 2 transformed particles at Sz = 0.
    """
    from libdmet_preview_tpu.models.integral import Integral
    from libdmet_preview_tpu.ops import embham
    basis = np.asarray(basis)
    ncells, nso, neo = basis.shape[1], basis.shape[2], basis.shape[3]
    nao = nso // 2

    basis_k = lattice.R2k_basis(basis)
    H1_emb = np.array(embham.transform_h1(GH1_k, basis_k))[0]

    # mu on every cell (part of the transformed lattice H1)
    mmat = mu_matrix(mu, nao)
    bR = basis[0]
    H1_emb += np.asarray(embham.transform_local(jnp.asarray(bR),
                                                jnp.asarray(mmat)))

    # local one-body from the H2 ph-transform: IMPURITY CELL ONLY --
    # it is the transform of the (impurity-truncated, NIB) interaction
    # (reference spinless.py:661-698 applies hcore_add via transform_imp)
    gv1_mat = np.zeros((nso, nso))
    gv1_mat[:nao, :nao] = GV1[0]
    gv1_mat[nao:, nao:] = GV1[1]
    gv1_mat[:nao, nao:] = GV1[2]
    gv1_mat[nao:, :nao] = GV1[2].T
    H1_emb += np.asarray(embham.transform_imp(jnp.asarray(bR),
                                              jnp.asarray(gv1_mat)))

    # correlation potential in the ENVIRONMENT only (matches the Slater
    # NIB convention: add everywhere, subtract the impurity copy)
    if vcor_gso is not None:
        H1_emb += np.asarray(embham.transform_local(
            jnp.asarray(bR), jnp.asarray(vcor_gso)))
        H1_emb -= np.asarray(embham.transform_imp(
            jnp.asarray(bR), jnp.asarray(vcor_gso)))

    # two-body on the impurity cell only (non-interacting bath)
    Ra = bR[:, :nao, :]
    Rb = bR[:, nao:, :]
    Ra0 = Ra[:1]
    Rb0 = Rb[:1]
    g_emb = transform_eri_local_gso(Ra0, Rb0, GV2)

    ImpHam = Integral(neo, True, False, H0, {"cd": H1_emb[None]},
                      {"ccdd": g_emb[None]})
    return ImpHam


def get_emb_Ham_ib(lattice, basis, GFock_k, GH1_full_k, chol_L, H0, mu,
                   GRho_k_mf, vcor_gso=None):
    """INTERACTING-BATH GSO embedding Hamiltonian (reference
    spinless.py:560-726 __embHam1e int_bath branch + __embHam2e with
    get_emb_eri_gso):

      H2  = full ph-transformed lattice ERI in the embedding basis,
            sum_x (La_x - Lb_x) (x) (La_x - Lb_x)
      H1  = emb[GFock(k)] - (J-K)[GRho_emb_mf; H2] + local(mu)
      JK_core = emb[GFock] - JK_emb - emb[GH1_full]   (for the energy
            functional; GH1_full = ph hcore INCLUDING the GV1
            normal-ordering term)

    GFock_k / GH1_full_k: combined (nk, nso, nso) pairs; chol_L:
    (naux, nsites, nsites) supercell DF factors; GRho_k_mf: mean-field
    GSO density pair over k.  Returns (ImpHam, JK_core)."""
    from libdmet_preview_tpu.models.integral import Integral
    from libdmet_preview_tpu.ops import embham
    from libdmet_preview_tpu.ops.eri_transform import get_emb_eri_gso_chol
    basis = np.asarray(basis)
    nso, neo = basis.shape[2], basis.shape[3]
    nao = nso // 2
    basis_k = lattice.R2k_basis(basis)

    g_emb = np.asarray(get_emb_eri_gso_chol(chol_L, basis))

    fock_emb = np.array(embham.transform_h1(GFock_k, basis_k))[0]
    hcore_emb = np.array(embham.transform_h1(GH1_full_k, basis_k))[0]
    GRho_emb_mf = np.asarray(embham.foldRho_k(GRho_k_mf, basis_k))
    if GRho_emb_mf.ndim == 3:
        GRho_emb_mf = GRho_emb_mf[0]
    JK_emb = get_veff_ghf(GRho_emb_mf, g_emb)

    H1_emb = fock_emb - JK_emb
    JK_core = H1_emb - hcore_emb

    bR = basis[0]
    H1_emb = H1_emb + np.asarray(embham.transform_local(
        jnp.asarray(bR), jnp.asarray(mu_matrix(mu, nao))))
    if vcor_gso is not None:
        H1_emb += np.asarray(embham.transform_local(
            jnp.asarray(bR), jnp.asarray(vcor_gso)))
        H1_emb -= np.asarray(embham.transform_imp(
            jnp.asarray(bR), jnp.asarray(vcor_gso)))

    ImpHam = Integral(neo, True, False, H0, {"cd": H1_emb[None]},
                      {"ccdd": g_emb[None]})
    return ImpHam, JK_core


def get_H_dmet_ib(lattice, basis, GH1_full_k, JK_core, ImpHam, H0):
    """Democratically-scaled GSO Hamiltonian for the INTERACTING-BATH
    energy functional (reference spinless.py:948-1040 get_H_dmet):

      H1_scaled = emb[GH1_full(k)] + JK_core/2   -> democratic scaling
      H2_scaled = democratic scaling of the full GSO embedding ERI
      H0        = physical + ph-transform constants (caller supplies)

    Evaluate with solver.run_dmet_ham (the stored GSO 1/2-RDMs)."""
    from libdmet_preview_tpu.models.integral import Integral
    from libdmet_preview_tpu.ops import embham
    from libdmet_preview_tpu.dmet.hubbard import (get_H1_scaled,
                                                  get_H2_scaled)
    basis = np.asarray(basis)
    nso, neo = basis.shape[2], basis.shape[3]
    basis_k = lattice.R2k_basis(basis)
    hcore_emb = np.array(embham.transform_h1(GH1_full_k, basis_k))[0]
    H1_scaled = hcore_emb + 0.5 * np.asarray(JK_core)
    imp_idx = np.arange(nso)
    env_idx = np.arange(nso, neo)
    H1_scaled = get_H1_scaled(H1_scaled[None], imp_idx, env_idx)
    H2_scaled = get_H2_scaled(np.asarray(ImpHam.H2["ccdd"]), imp_idx,
                              env_idx)
    return Integral(neo, True, False, H0, {"cd": H1_scaled},
                    {"ccdd": H2_scaled})


def get_E_dmet_ib(lattice, basis, GH1_full_k, JK_core, ImpHam, H0,
                  solver, solver_args=None):
    Ham_scaled = get_H_dmet_ib(lattice, basis, GH1_full_k, JK_core,
                               ImpHam, H0)
    return solver.run_dmet_ham(Ham_scaled, **(solver_args or {}))


def apply_dmu(lattice, ImpHam, basis, dmu):
    """Add -dmu on the impurity-cell PHYSICAL electron count:
    -dmu*(n_a - n_b)_imp in the GSO rep (reference HubbardGSO.apply_dmu)."""
    from libdmet_preview_tpu.ops import embham
    basis = np.asarray(basis)
    nso = basis.shape[2]
    nao = nso // 2
    mmat = mu_matrix(dmu, nao)
    dH = np.asarray(embham.transform_imp(jnp.asarray(basis[0]),
                                         jnp.asarray(mmat)))
    ImpHam.H1["cd"] = ImpHam.H1["cd"] + dH[None]
    return ImpHam


def FitVcorGSOEmb(GRhoEmb, lattice, basis, vcor, GH1_k, mu, MaxIter=300,
                  imp_fit=False, **kwargs):
    """Correlation-potential fit in the GSO frame, fixed embedding basis
    (reference spinless.py:1090-2232 FitVcorEmb role).

    vcor: a Bogoliubov Vcor ([va, vb, D] components); the fit cost is
    || GRho_mf(param) - GRhoEmb || with GRho_mf from the eigenbasis of
      embH1 + sum_P param_P dV_P,   embH1 = emb[GH1(k) + mu_mat]
    at fixed transformed particle number neo/2.  Gradient via the same
    degenerate-safe occ-virt machinery as the Slater fit (ops/fit.py).
    """
    import jax.numpy as jnp
    from libdmet_preview_tpu.ops import embham
    from libdmet_preview_tpu.ops.fit import (_fit_err, _fit_err_grad,
                                             minimize_cg)
    basis = np.asarray(basis)
    ncells, nso, neo = basis.shape[1], basis.shape[2], basis.shape[3]
    nao = nso // 2
    GRhoEmb = np.asarray(GRhoEmb)
    if GRhoEmb.ndim == 3:
        GRhoEmb = GRhoEmb[0]

    basis_k = lattice.R2k_basis(basis)
    f_re = np.asarray(GH1_k[0]) + mu_matrix(mu, nao)
    embH1 = np.asarray(embham.transform_h1((f_re, GH1_k[1]), basis_k))

    # dV/dparam: combine each gradient component and rotate to the
    # embedding basis
    grad3 = np.asarray(vcor.gradient())          # (P, 3, nao, nao)
    nparam = grad3.shape[0]
    dV_gso = np.asarray([combine_vcor(grad3[p]) for p in range(nparam)])
    bR = jnp.asarray(basis)
    dV = np.asarray(jnp.einsum("sRpi, Ppq, sRqj -> Psij", bR,
                               jnp.asarray(dV_gso), bR, optimize=True))

    mask = np.ones((1, neo, neo))
    if imp_fit:
        mask[:] = 0.0
        mask[:, :nso, :nso] = 1.0
    Li = np.eye(neo)[None]
    nelec = (neo // 2,)
    target = GRhoEmb[None]

    def fun_grad(p):
        e, g = _fit_err_grad(jnp.asarray(p), jnp.asarray(embH1),
                             jnp.asarray(dV), jnp.asarray(Li),
                             jnp.asarray(mask), jnp.asarray(target), nelec)
        return float(e), np.asarray(g)

    p0 = np.array(vcor.param, copy=True)
    p_new, err, gmax = minimize_cg(fun_grad, p0, max_iter=MaxIter)
    import copy
    vcor_new = copy.deepcopy(vcor)
    vcor_new.update(p_new)
    return vcor_new, err


def transform_results(GRhoEmb, E_emb, basis, ImpHam, lattice, mu,
                      last_dmu=0.0, JK_core=None, **kwargs):
    """Embedded GSO results -> (GRhoImp, Efrag per cell, n_phys per cell)
    with the reference's fragment-energy convention
    (reference spinless.py transformResults):

      E2 = E_solver - tr(H1_emb GRho) - H0        (pure 2-body part)
      H1_scaled = H1_emb + imp(cancel last_dmu) + local(cancel mu)
                  [- JK_core/2 in the interacting-bath flavor,
                   reference spinless.py:834-836],
                  then democratic partitioning (imp-env x 0.5, env-env 0)
      Efrag = tr(H1_scaled GRho) + E2 + H0
    """
    from libdmet_preview_tpu.ops import embham
    basis = np.asarray(basis)
    nso = basis.shape[2]
    neo = basis.shape[3]
    nao = nso // 2
    GRhoEmb = np.asarray(GRhoEmb)
    if GRhoEmb.ndim == 3:
        GRhoEmb = GRhoEmb[0]
    GRhoImp = np.einsum("pi, ij, qj -> pq", basis[0, 0], GRhoEmb,
                        basis[0, 0])
    # physical electron count on the impurity cell
    n_phys = float(np.trace(GRhoImp[:nao, :nao])
                   - np.trace(GRhoImp[nao:, nao:])) + nao

    if E_emb is None:
        return GRhoImp, None, n_phys / nao

    H1_emb = np.asarray(ImpHam.H1["cd"][0])
    H0 = float(ImpHam.H0)
    E2 = E_emb - float(np.einsum("pq, qp ->", H1_emb, GRhoEmb)) - H0

    # cancel the mu (global) and last_dmu (impurity) terms in H1
    H1_scaled = H1_emb.copy()
    H1_scaled += np.asarray(embham.transform_imp(
        jnp.asarray(basis[0]), jnp.asarray(mu_matrix(-last_dmu, nao))))
    H1_scaled += np.asarray(embham.transform_local(
        jnp.asarray(basis[0]), jnp.asarray(mu_matrix(-mu, nao))))

    # interacting bath: the core JK potential is double-counted between
    # H1 and the democratic 2-body partitioning; remove half
    if JK_core is not None:
        H1_scaled -= 0.5 * np.asarray(JK_core)

    # democratic partitioning: impurity = first nso embedding orbitals
    imp_idx = np.arange(nso)
    env_idx = np.arange(nso, neo)
    H1_scaled[np.ix_(imp_idx, env_idx)] *= 0.5
    H1_scaled[np.ix_(env_idx, imp_idx)] *= 0.5
    H1_scaled[np.ix_(env_idx, env_idx)] = 0.0

    E1 = float(np.einsum("pq, qp ->", H1_scaled, GRhoEmb))
    Efrag = E1 + E2 + H0
    return GRhoImp, Efrag / nao, n_phys / nao


def GKS_mu_fit(lattice, GH1_k, filling_phys, xc_eval, vcor_mat=None,
               mu0=0.0, beta=np.inf, max_cycle=50, conv_tol=1e-8,
               mix=0.5, **kwargs):
    """Generalized Kohn-Sham in the spinless (GSO) frame (reference
    routine/kgks.py:240 KGKS role): self-consistent mean field where a
    density functional potential acts on the PHYSICAL per-spin densities.

    xc_eval(rho_a, rho_b) -> (vxc_a, vxc_b) with rho_s the (nao, nao)
    physical per-spin cell densities; the potential enters the GSO frame
    through the partial particle-hole transform,
    V_gso = diag(vxc_a, -vxc_b^T) (the b block rides the hole species; the
    constant tr(vxc_b) only shifts the total energy bookkeeping, not the
    state).  xc_eval == None reduces EXACTLY to GHF_mu_fit (oracle).

    Returns (GRho_R, mu, res) like GHF_mu_fit, with res["cycles"] and
    res["dGRho"]."""
    nso = np.asarray(GH1_k[0]).shape[-1]
    nao = nso // 2
    base = np.zeros((nso, nso)) if vcor_mat is None else np.asarray(vcor_mat)
    v_gso = np.array(base, copy=True)
    GRho_old = None
    mu = mu0
    dG = np.inf
    for it in range(max_cycle):
        GRho_R, mu, res = GHF_mu_fit(lattice, GH1_k, v_gso, filling_phys,
                                     mu0=mu, beta=beta, **kwargs)
        if xc_eval is None:
            res["cycles"] = it + 1
            res["dGRho"] = 0.0
            return GRho_R, mu, res
        rA, rB, _ = extract_rdm(GRho_R[0] if GRho_R.ndim == 3 else GRho_R)
        vxc_a, vxc_b = xc_eval(np.asarray(rA), np.asarray(rB))
        v_new = np.array(base, copy=True)
        v_new[:nao, :nao] += vxc_a
        v_new[nao:, nao:] -= np.asarray(vxc_b).T
        if GRho_old is not None:
            dG = float(np.max(np.abs(np.asarray(GRho_R)
                                     - np.asarray(GRho_old))))
            if dG < conv_tol:
                res["cycles"] = it + 1
                res["dGRho"] = dG
                return GRho_R, mu, res
        GRho_old = np.asarray(GRho_R)
        v_gso = (1.0 - mix) * v_gso + mix * v_new
    log.warn("GKS_mu_fit: not converged, dGRho = %.2e", dG)
    res["cycles"] = max_cycle
    res["dGRho"] = dG
    return GRho_R, mu, res
