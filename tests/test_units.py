"""
Per-layer unit tests (reference test strategy, SURVEY 4: system/test,
routine/test, dmet/test unit suites).

  * Fourier identities: R<->k round trips, stripe/expand consistency
    (reference system/test/test_fourier.py)
  * Integral I/O: FCIDUMP and HDF5 round trips
    (reference system/test/test_integral.py)
  * differentiable Fermi density: custom JVP vs finite differences,
    including exactly degenerate spectra
    (reference routine/test/test_ft_system.py)
  * vcor parametrization: evaluate/gradient consistency
    (reference routine/test/test_vcor.py)
  * vcor fit: analytic gradient vs numerical (reference slater.py test_grad
    used by routine/test/test_fit.py)
  * quadratic mu extrapolation (reference dmet/test/test_quad_fit.py)
"""

import os
import numpy as np
import pytest


def test_fourier_roundtrip():
    from libdmet_preview_tpu.ops import zlinalg
    rng = np.random.RandomState(0)
    kmesh = (3, 2)
    nk = 6
    A = rng.randn(nk, 4, 4)
    B = zlinalg.R2k(A, kmesh)
    A2 = zlinalg.k2R(B, kmesh)
    assert np.max(np.abs(np.asarray(A2) - A)) < 1e-12
    # Parseval-like identity: k-sum of |A(k)|^2 == nk * R-sum of |A(R)|^2
    norm_k = float(np.sum(np.asarray(B[0]) ** 2 + np.asarray(B[1]) ** 2))
    assert abs(norm_k - nk * float(np.sum(A ** 2))) < 1e-9


def test_lattice_expand_stripe():
    from libdmet_preview_tpu.models.lattice import ChainLattice
    rng = np.random.RandomState(1)
    Lat = ChainLattice(8, 2)
    stripe = rng.randn(1, Lat.ncells, 2, 2)
    full = Lat.expand(stripe)
    back = Lat.extract_stripe(full)
    assert np.max(np.abs(back - stripe)) < 1e-12
    # expanded matrix is block-circulant: check one translated block
    assert np.max(np.abs(full[0, 2:4, 2:4] - full[0, 0:2, 0:2])) < 1e-12


def test_fcidump_roundtrip(tmp_path):
    from libdmet_preview_tpu.models.integral import (
        Integral, dump_FCIDUMP, read_FCIDUMP)
    rng = np.random.RandomState(2)
    n = 3
    h = rng.randn(n, n)
    h = h + h.T
    A = rng.randn(4, n, n)
    A = A + A.transpose(0, 2, 1)
    g = np.einsum("xpq, xrs -> pqrs", A, A)
    Ham = Integral(n, True, False, 0.25, {"cd": h[None]}, {"ccdd": g[None]})
    path = str(tmp_path / "FCIDUMP")
    dump_FCIDUMP(path, Ham, nelec=2)
    Ham2 = read_FCIDUMP(path)
    assert np.max(np.abs(np.asarray(Ham2.H1["cd"][0]) - h)) < 1e-9
    from libdmet_preview_tpu.models.integral import restore_eri
    g2 = restore_eri(np.asarray(Ham2.H2["ccdd"][0]), n, 1)
    assert np.max(np.abs(g2 - g)) < 1e-9
    assert abs(Ham2.H0 - 0.25) < 1e-12


def test_integral_h5_roundtrip(tmp_path):
    from libdmet_preview_tpu.models.integral import (
        Integral, save_h5, load_h5)
    rng = np.random.RandomState(3)
    n = 3
    h = rng.randn(2, n, n)
    g = rng.randn(3, n, n, n, n)
    Ham = Integral(n, False, False, -0.5, {"cd": h}, {"ccdd": g})
    path = str(tmp_path / "ham.h5")
    save_h5(path, Ham)
    Ham2 = load_h5(path)
    assert np.max(np.abs(np.asarray(Ham2.H1["cd"]) - h)) < 1e-12
    assert np.max(np.abs(np.asarray(Ham2.H2["ccdd"]) - g)) < 1e-12
    assert Ham2.restricted is False


def test_zrho_fermi_jvp_vs_fd():
    """Degenerate-safe Fermi-density derivative vs finite differences."""
    import jax
    import jax.numpy as jnp
    from libdmet_preview_tpu.ops.zlinalg import zrho_fermi
    rng = np.random.RandomState(4)
    n, nk, beta = 3, 4, 50.0
    h = rng.randn(nk, n, n) * 0.5
    h_re = 0.5 * (h + h.transpose(0, 2, 1))
    # enforce an EXACT degeneracy: duplicate one k block
    h_re[1] = h_re[0]
    h_im = np.zeros_like(h_re)
    nelec = 2.0 * nk * n * 0.5   # doubled spectrum, half filling

    dh = rng.randn(nk, n, n) * 0.1
    dh = 0.5 * (dh + dh.transpose(0, 2, 1))

    def obj(t):
        r_re, r_im, mu = zrho_fermi(jnp.asarray(h_re + t * dh),
                                    jnp.asarray(h_im), nelec, beta)
        return jnp.sum(r_re ** 3) + jnp.sum(r_re * jnp.asarray(dh))

    g_ad = float(jax.grad(obj)(0.0))
    eps = 1e-5
    g_fd = (float(obj(eps)) - float(obj(-eps))) / (2 * eps)
    assert abs(g_ad - g_fd) < 1e-6 * max(1.0, abs(g_fd))


def test_vcor_gradient():
    from libdmet_preview_tpu.ops.vcor import VcorLocal
    rng = np.random.RandomState(5)
    v = VcorLocal(False, False, 3)
    p = rng.randn(v.length())
    v.update(p)
    V0 = np.array(v.get())
    grad = np.asarray(v.gradient())   # (nparam, spin, n, n)
    eps = 1e-6
    for k in [0, 3, v.length() - 1]:
        p1 = p.copy()
        p1[k] += eps
        v.update(p1)
        dV = (np.array(v.get()) - V0) / eps
        assert np.max(np.abs(dV - grad[k, :2])) < 1e-6


def test_fit_gradient_vs_numerical():
    """Analytic vcor-fit gradient (occ-virt perturbation theory) vs
    numerical differences (reference slater.py:820 test_grad)."""
    import jax.numpy as jnp
    from libdmet_preview_tpu.ops.fit import _fit_err, _fit_err_grad
    rng = np.random.RandomState(6)
    neo, nparam, spin = 6, 5, 2
    embH1 = rng.randn(spin, neo, neo)
    embH1 = 0.5 * (embH1 + embH1.transpose(0, 2, 1))
    dV = rng.randn(nparam, spin, neo, neo)
    dV = 0.5 * (dV + dV.transpose(0, 1, 3, 2))
    Li = np.tile(np.eye(neo), (spin, 1, 1))
    mask = np.ones((spin, neo, neo))
    target = rng.rand(spin, neo, neo) * 0.1
    target = 0.5 * (target + target.transpose(0, 2, 1))
    nelec = (3, 3)
    p0 = rng.randn(nparam) * 0.1

    err, grad = _fit_err_grad(jnp.asarray(p0), jnp.asarray(embH1),
                              jnp.asarray(dV), jnp.asarray(Li),
                              jnp.asarray(mask), jnp.asarray(target), nelec)
    grad = np.asarray(grad)
    eps = 1e-6
    for k in range(nparam):
        p1 = p0.copy()
        p1[k] += eps
        p2 = p0.copy()
        p2[k] -= eps
        e1 = float(_fit_err(jnp.asarray(p1), jnp.asarray(embH1),
                            jnp.asarray(dV), jnp.asarray(Li),
                            jnp.asarray(mask), jnp.asarray(target), nelec))
        e2 = float(_fit_err(jnp.asarray(p2), jnp.asarray(embH1),
                            jnp.asarray(dV), jnp.asarray(Li),
                            jnp.asarray(mask), jnp.asarray(target), nelec))
        g_fd = (e1 - e2) / (2 * eps)
        assert abs(grad[k] - g_fd) < 1e-5 * max(1.0, abs(g_fd))


def test_quad_fit_mu():
    from libdmet_preview_tpu.dmet.quad_fit import quad_fit_mu
    # exact parabola: nelec(mu) = 1 + 0.8*(mu - 0.3) - 0.2*(mu - 0.3)**2
    def n_of(mu):
        return 1.0 + 0.8 * (mu - 0.3) - 0.2 * (mu - 0.3) ** 2
    mus = np.asarray([0.0, 0.1, 0.2])
    ns = np.asarray([n_of(m) for m in mus])
    target_filling = 0.5   # target nelec = 1.0
    dmu = quad_fit_mu(mus, ns, target_filling, step=1.0)
    assert abs(n_of(dmu) - 1.0) < 1e-6


def test_vcor_nonlocal():
    """Non-local vcor: Hermitian lattice operator, correct k form, fit
    machinery consistency (reference routine/vcor.py:105-525)."""
    import jax.numpy as jnp
    from libdmet_preview_tpu.models.lattice import ChainLattice
    from libdmet_preview_tpu.ops.vcor import VcorNonLocal
    from libdmet_preview_tpu.ops import zlinalg
    from libdmet_preview_tpu.ops.fit import get_dV_dparam
    rng = np.random.RandomState(8)
    Lat = ChainLattice(16, 2)   # 8 cells of 2 sites
    v = VcorNonLocal(False, False, Lat, rcells=[0, 1])
    p = rng.randn(v.length()) * 0.3
    v.update(p)
    VR = v.evaluate_R()
    # Hermiticity of the full lattice operator: V(k) Hermitian per k
    v_re, v_im = v.get(kspace=True)
    herm = np.max(np.abs(v_re - v_re.transpose(0, 1, 3, 2))) \
        + np.max(np.abs(v_im + v_im.transpose(0, 1, 3, 2)))
    assert herm < 1e-12
    # gradient consistency: evaluate == sum param * gradient
    g = v.gradient_R()
    VR2 = np.einsum("P, Psrij -> srij", p, g)
    assert np.max(np.abs(VR2 - VR)) < 1e-12
    # assign round trip
    v2 = VcorNonLocal(False, False, Lat, rcells=[0, 1])
    v2.assign(VR)
    assert np.max(np.abs(v2.evaluate_R() - VR)) < 1e-10
    # dV_emb: nonlocal path vs explicit full-matrix transform
    basis = rng.randn(2, 8, 2, 4)
    basis_k = Lat.R2k_basis(basis)
    dV = get_dV_dparam(v, basis, basis_k=basis_k, kmesh=Lat.kmesh)
    # brute force for one param: expand V stripe to the full matrix
    k = 3
    VRk = g[k]
    full = np.zeros((2, 16, 16))
    for s in range(2):
        for R1 in range(8):
            for R2 in range(8):
                dR = (R2 - R1) % 8
                full[s, R1*2:(R1+1)*2, R2*2:(R2+1)*2] = VRk[s, dR]
    Bf = basis.reshape(2, 16, 4)
    want = np.einsum("spi, spq, sqj -> sij", Bf, full, Bf)
    assert np.max(np.abs(dV[k] - want)) < 1e-9


def test_hf_with_nonlocal_vcor():
    """Mean field with a nonlocal vcor == mean field with the equivalent
    explicitly-built k potential."""
    import libdmet_preview_tpu.dmet.hubbard as dmet
    from libdmet_preview_tpu.ops.vcor import VcorNonLocal
    rng = np.random.RandomState(9)
    Lat = dmet.ChainLattice(8, 2)
    Ham = dmet.Ham(Lat, 2.0)
    Lat.set_Ham(Ham, use_hcore_as_emb_ham=True)
    v = VcorNonLocal(False, False, Lat, rcells=[0, 1])
    v.update(rng.randn(v.length()) * 0.1)
    rho, mu, res = dmet.HartreeFock(Lat, v, 0.5, None, ires=True)
    assert np.all(np.isfinite(rho))
    nelec = np.sum(np.trace(rho[:, 0], axis1=1, axis2=2)) * Lat.ncells
    assert abs(nelec - 8.0) < 1e-6


def test_vcor_symm():
    """Point-group symmetric vcor: the evaluated potential is invariant
    under the generating permutations (reference VcorSymm family)."""
    from libdmet_preview_tpu.ops.vcor import VcorSymm
    rng = np.random.RandomState(10)
    # 2x2 plaquette: C4 rotation permutation (0,1,3,2 cycle) + mirror
    rot = [1, 3, 0, 2]
    mir = [1, 0, 3, 2]
    v = VcorSymm(False, False, 4, [rot, mir])
    p = rng.randn(v.length())
    v.update(p)
    V = np.asarray(v.get())
    for P in (rot, mir):
        P = np.asarray(P)
        for s in range(2):
            VP = V[s][np.ix_(P, P)]
            assert np.max(np.abs(VP - V[s])) < 1e-12
    # AFM spin-swap symmetry: rot exchanges sublattices AND spins
    v2 = VcorSymm(False, False, 4, [rot], spin_swap=[True])
    p2 = rng.randn(v2.length())
    v2.update(p2)
    V2 = np.asarray(v2.get())
    P = np.asarray(rot)
    assert np.max(np.abs(V2[0][np.ix_(P, P)] - V2[1])) < 1e-12
    # fewer parameters than the unconstrained vcor
    from libdmet_preview_tpu.ops.vcor import VcorLocal
    assert v.length() < VcorLocal(False, False, 4).length()
    # bogoliubov=True delegates to VcorSymmBogo: 3 blocks, the pairing
    # block symmetric under the generators too
    vb = VcorSymm(False, True, 4, [rot, mir])
    pb = rng.randn(vb.length())
    vb.update(pb)
    Vb = np.asarray(vb.get())
    assert Vb.shape[0] == 3
    for P in (rot, mir):
        P = np.asarray(P)
        for s in range(3):
            assert np.max(np.abs(Vb[s][np.ix_(P, P)] - Vb[s])) < 1e-12


def test_basis_matching():
    """alpha/beta bath alignment (reference HubPhSymm.basisMatching):
    matched baths span the same spaces and maximize the overlap."""
    from libdmet_preview_tpu.ops.embham import basis_matching
    rng = np.random.RandomState(11)
    nc, n, nb = 3, 2, 2
    A = np.linalg.qr(rng.randn(nc * n, nb))[0]
    # beta bath: same span, rotated
    R = np.linalg.qr(rng.randn(nb, nb))[0]
    B = A @ R
    basis = np.asarray([A.reshape(nc, n, nb), B.reshape(nc, n, nb)])
    out = basis_matching(basis)
    Am, Bm = out[0].reshape(-1, nb), out[1].reshape(-1, nb)
    # after matching, the two baths coincide up to signs
    ov = Am.T @ Bm
    assert np.max(np.abs(np.abs(ov) - np.eye(nb))) < 1e-10
    assert np.min(np.diag(ov)) > 0.99


def test_k2gamma_and_bands():
    """k2gamma folding == lattice expand; band interpolation hits the
    exact tight-binding dispersion and velocity (reference fourier
    k2gamma + band-velocity capabilities)."""
    from libdmet_preview_tpu.models.lattice import ChainLattice
    from libdmet_preview_tpu.ops import fourier
    rng = np.random.RandomState(12)
    Lat = ChainLattice(12, 2)
    stripe = rng.randn(Lat.ncells, 2, 2)
    # make it a valid Hermitian lattice operator: A(-R) = A(R)^T
    for R in range(1, Lat.ncells):
        stripe[(-R) % Lat.ncells] = stripe[R].T
    stripe[0] = 0.5 * (stripe[0] + stripe[0].T)
    A_k = fourier.R2k(stripe, Lat.kmesh)
    full = fourier.k2gamma(A_k, Lat.kmesh)
    want = Lat.expand(stripe[None])[0]
    assert np.max(np.abs(full - want)) < 1e-10
    back = fourier.gamma2k(full, Lat.kmesh, 2)
    assert np.max(np.abs(np.asarray(back[0]) - np.asarray(A_k[0]))) < 1e-10

    # 1-band chain: exact dispersion -2t cos(2 pi kf) and velocity
    Lat1 = ChainLattice(8, 1)
    h = np.zeros((8, 1, 1))
    h[1, 0, 0] = h[7, 0, 0] = -1.0
    kf = np.asarray([[0.13], [0.37]])
    bands, vel = fourier.band_velocity(h, (8,), kf)
    for ik in range(2):
        assert abs(bands[ik, 0] - (-2 * np.cos(2 * np.pi * kf[ik, 0]))) < 1e-9
        assert abs(vel[ik, 0, 0]
                   - (4 * np.pi * np.sin(2 * np.pi * kf[ik, 0]))) < 1e-9


def test_jk_nearest_vs_bruteforce():
    """'nearest' H2 JK builder vs fully-expanded supercell contraction
    (reference pbc_helper.py:424-507)."""
    from libdmet_preview_tpu.models.lattice import ChainLattice
    from libdmet_preview_tpu.models.hamiltonian import HubbardExtended
    from libdmet_preview_tpu.ops.pbc_helper import (get_jk_nearest,
                                                    get_jk_full_bruteforce)
    rng = np.random.RandomState(13)
    Lat = ChainLattice(12, 2)
    Ham = HubbardExtended(Lat, U=4.0, V=1.0)
    eri_R = np.asarray(Ham.getH2())
    assert Ham.H2_format == "nearest"
    dm = rng.randn(1, Lat.ncells, 2, 2) * 0.2
    # make the full matrix Hermitian: dm[-R] = dm[R]^T
    for R in range(1, Lat.ncells):
        dm[0, (-R) % Lat.ncells] = dm[0, R].T
    dm[0, 0] = 0.5 * (dm[0, 0] + dm[0, 0].T)
    vj, vk = get_jk_nearest(eri_R, dm)
    vj_full, vk_full = get_jk_full_bruteforce(Lat, eri_R, dm)
    n = 2
    assert np.max(np.abs(vj[0] - vj_full[0][:n, :n])) < 1e-10
    # vk[R] is the (0, R) block of the full exchange matrix
    for R in range(Lat.ncells):
        blk = vk_full[0][:n, R * n:(R + 1) * n]
        assert np.max(np.abs(vk[0, R] - blk)) < 1e-10


def test_hf_scf_lattice():
    """Self-consistent lattice UHF on the Hubbard chain: fock fixed point
    (further update_Ham leaves the energy invariant) and AFM symmetry
    breaking at large U (reference DiagHF_scf role)."""
    import libdmet_preview_tpu.dmet.hubbard as dmet
    from libdmet_preview_tpu.ops import mfd
    Lat = dmet.ChainLattice(12, 2)
    Ham = dmet.Ham(Lat, 8.0)
    Lat.set_Ham(Ham, use_hcore_as_emb_ham=False)
    # seed symmetry breaking via an AFM vcor that we then remove
    vcor = dmet.VcorLocal(False, False, 2)
    vcor.assign(np.asarray([np.diag([0.5, -0.5]), np.diag([-0.5, 0.5])]))
    rho0, mu0, E0 = mfd.HF(Lat, vcor, 0.5, False)
    Lat.update_Ham(rho0)
    vcor.update(np.zeros(vcor.length()))
    rho, mu, E = mfd.HF_scf(Lat, vcor, 0.5, False, conv_tol=1e-12)
    # fixed point: one more pass changes nothing
    rho2, mu2, E2 = mfd.HF(Lat, vcor, 0.5, False, use_hcore=False)
    assert abs(E2 - E) < 1e-9
    # AFM moment survives self-consistency at U/t = 8
    m = 0.5 * abs(rho[0, 0, 0, 0] - rho[1, 0, 0, 0])
    assert m > 0.2


def test_hub_u_correction():
    """DFT+U machinery (reference krkspu/kukspu +U form):
    v_U = dE_U/dP adjoint (finite-difference oracle); idempotent filled
    subspace gives v_U = 0 on it; HF+U opens the gap on the H-ring."""
    from libdmet_preview_tpu.ops.dftu import hub_u_correction, HF_plus_U
    rng = np.random.RandomState(16)
    spin, nk, nlo = 1, 3, 4
    r_re = rng.rand(spin, nk, nlo, nlo) * 0.3
    r_re = 0.5 * (r_re + r_re.transpose(0, 1, 3, 2))
    r_im = np.zeros_like(r_re)
    U_idx, U_val = [[0, 1]], [2.0]
    (v_re, v_im), E_U = hub_u_correction((r_re, r_im), U_idx, U_val)
    # dE_U/dP finite difference vs v_U (restricted: E_U carries factor 2,
    # and dE/drho per spin-channel picks the same factor on both sides)
    eps = 1e-6
    dr = np.zeros_like(r_re)
    dr[0, 1, 0, 1] = dr[0, 1, 1, 0] = eps
    _, E2 = hub_u_correction((r_re + dr, r_im), U_idx, U_val)
    g_fd = (E2 - E_U) / eps
    # E_U(P + dP) - E_U(P) ~= (1/nk) * 2(restricted) * sum(vU * dP)
    g_an = 2.0 * 2.0 * v_re[0, 1, 0, 1] / nk
    assert abs(g_fd - g_an) < 1e-5

    # fully occupied local subspace (P = I): vU vanishes there
    r_full = np.tile(np.eye(nlo)[None, None], (spin, nk, 1, 1))
    (vf_re, _), _ = hub_u_correction((r_full, r_im), U_idx, U_val)
    assert np.max(np.abs(vf_re[0, :, :2, :2])) < 1e-12

    # self-consistent HF+U on the ab initio H ring: U on each cell's LOs
    from libdmet_preview_tpu.models.abinitio import make_h_ring_lattice
    Lat, meta = make_h_ring_lattice(3, 2, 1.8, basis="sto-6g")
    filling = meta["mole"].nelectron / (2.0 * meta["mole"].nao)
    rho0, mu0, E0 = HF_plus_U(Lat, None, filling, True, [[0, 1]], [0.0])
    assert abs(E0 - meta["E_hf"] / Lat.ncells) < 1e-8   # U = 0: plain HF
    rho1, mu1, E1 = HF_plus_U(Lat, None, filling, True, [[0, 1]], [1.0])
    assert E1 > E0  # +U raises the total energy of the metallic-ish state
    assert np.all(np.isfinite(rho1))


def test_pm_er_localization():
    """PM and ER localization (reference ibo.py / edmiston.py roles):
    the localized orbitals span the same space, are orthonormal, and
    strictly raise their metric vs the delocalized canonical set."""
    from libdmet_preview_tpu.lo.localize import (localize_pm, localize_er,
                                                 pm_metric, er_metric)
    from libdmet_preview_tpu.ints.gto import Mole
    from libdmet_preview_tpu.models.abinitio import make_molecule_lattice
    import jax.numpy as jnp
    atoms = [("H", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 1.6)),
             ("H", (0.0, 0.0, 4.6)), ("H", (0.0, 0.0, 6.2))]
    mol = Mole(atoms, basis="sto-6g")
    Lat, meta = make_molecule_lattice(mol)
    # canonical occupied orbitals in the Lowdin-LO basis
    h = meta["h_lo"]
    from libdmet_preview_tpu.models.integral import Integral
    from libdmet_preview_tpu.solvers.scf import SCF
    Ham = Integral(4, True, False, 0.0, {"cd": h[None]},
                   {"ccdd": meta["eri_lo"][None]})
    scf = SCF(); scf.set_system(4, 0, False, True); scf.set_integral(Ham)
    scf.HF(tol=1e-12)
    C_occ = scf.mo_coeff[0][:, :2]
    slices = [[0], [1], [2], [3]]

    C_pm, m_pm = localize_pm(C_occ, slices)
    assert m_pm > float(pm_metric(jnp.asarray(C_occ), slices)) + 1e-6
    assert np.max(np.abs(C_pm.T @ C_pm - np.eye(2))) < 1e-9
    # span preserved: projectors agree
    P0 = C_occ @ C_occ.T
    P1 = C_pm @ C_pm.T
    assert np.max(np.abs(P0 - P1)) < 1e-8
    # localized bonding orbitals: each concentrated on one H2 unit
    w_unit1 = np.sum(C_pm[:2] ** 2, axis=0)
    assert np.min(np.abs(w_unit1 - 0.5)) > 0.45  # ~0 or ~1 per orbital

    C_er, m_er = localize_er(C_occ, meta["eri_lo"])
    assert m_er > float(er_metric(jnp.asarray(C_occ),
                                  meta["eri_lo"])) + 1e-6
    assert np.max(np.abs(C_er @ C_er.T - P0)) < 1e-8


def test_zrho_fermi_weighted_tr_mesh():
    """Weighted Fermi-density op == full-mesh op on a time-reversal
    reduced k set: same mu, same rho on the kept k's; gradient matches
    finite differences."""
    import jax
    import jax.numpy as jnp
    from libdmet_preview_tpu.ops.zlinalg import zrho_fermi, zrho_fermi_w
    from libdmet_preview_tpu.ops import zlinalg
    rng = np.random.RandomState(17)
    nk, n, beta = 8, 3, 80.0
    h_R = rng.randn(nk, n, n) * 0.4
    for R in range(1, nk):
        h_R[(-R) % nk] = h_R[R].T
    h_R[0] = 0.5 * (h_R[0] + h_R[0].T)
    f_re, f_im = zlinalg.R2k(h_R, (nk,))
    f_re, f_im = np.asarray(f_re), np.asarray(f_im)
    nelec = float(nk * n)   # half filling on the doubled spectrum

    r_full = zrho_fermi(jnp.asarray(f_re), jnp.asarray(f_im), nelec, beta)
    # IBZ: k = 0..nk/2 with weights [1, 2, 2, 2, 1] for even nk
    idx = list(range(nk // 2 + 1))
    w = np.asarray([1.0] + [2.0] * (nk // 2 - 1) + [1.0])
    r_ibz = zrho_fermi_w(jnp.asarray(f_re[idx]), jnp.asarray(f_im[idx]),
                         nelec, beta, jnp.asarray(w))
    assert abs(float(r_ibz[2]) - float(r_full[2])) < 1e-9   # mu
    assert np.max(np.abs(np.asarray(r_ibz[0])
                         - np.asarray(r_full[0])[idx])) < 1e-10

    dh = rng.randn(len(idx), n, n) * 0.1
    dh = 0.5 * (dh + dh.transpose(0, 2, 1))

    def obj(t):
        rr, ri, mu = zrho_fermi_w(jnp.asarray(f_re[idx] + t * dh),
                                  jnp.asarray(f_im[idx]), nelec, beta,
                                  jnp.asarray(w))
        return jnp.sum(rr ** 3) + 0.3 * mu

    g_ad = float(jax.grad(obj)(0.0))
    eps = 1e-5
    g_fd = (float(obj(eps)) - float(obj(-eps))) / (2 * eps)
    assert abs(g_ad - g_fd) < 1e-6 * max(1.0, abs(g_fd))


def test_fold_mo_k2gamma():
    """MO folding to the Gamma supercell (reference fold_kmf role): the
    folded REAL orbitals diagonalize the supercell Hamiltonian with the
    folded (sorted) spectrum."""
    import jax.numpy as jnp
    from libdmet_preview_tpu.ops import zlinalg, fourier
    rng = np.random.RandomState(0)
    nk, n = 6, 3
    hR = rng.randn(nk, n, n) * 0.3
    hR[0] = 0.5 * (hR[0] + hR[0].T)
    hR[nk // 2] = 0.5 * (hR[nk // 2] + hR[nk // 2].T)  # self-paired R
    for R in range(1, nk // 2):
        hR[(-R) % nk] = hR[R].T
    hk = zlinalg.R2k(hR, (nk,))
    # complex spectrum/orbitals per k (host side, from the raw pair)
    h_cplx = np.asarray(hk[0]) + 1j * np.asarray(hk[1])
    ew, ev = np.linalg.eigh(h_cplx)
    C_sc, e_sc, ok = fourier.fold_mo_k2gamma((ev.real, ev.imag), ew, (nk,))
    assert ok.all()
    H_sc = fourier.k2gamma(hk, (nk,))
    # orthonormal real eigenvectors with the folded spectrum
    assert np.abs(C_sc.T @ C_sc - np.eye(nk * n)).max() < 1e-9
    resid = H_sc @ C_sc - C_sc * e_sc[None, :]
    assert np.abs(resid).max() < 1e-8
    assert np.abs(np.sort(np.linalg.eigvalsh(H_sc)) - e_sc).max() < 1e-9


def test_bench_program_runs_on_cpu():
    """The driver-facing bench program (bench.dmet_iteration) compiles
    and runs on CPU with finite outputs and a decreasing fit error --
    guards the benchmark against silent breakage from library changes."""
    import sys
    import os
    import jax
    import jax.numpy as jnp
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import bench
    from libdmet_preview_tpu.ops.fastpath import (make_dmet_iteration,
                                                  chain_iterations)
    Lat, vmat, rho_t, chol_L = bench.make_lattice()
    vcor = bench._VcorFixed(vmat)
    # small DF rank keeps the CPU f64 transform cheap in-suite
    step, p0 = make_dmet_iteration(Lat, vcor, bench.FILLING,
                                   beta=bench.BETA, fit_max_iter=3,
                                   chol_L=chol_L[:32])
    chained = chain_iterations(step, 2)
    p_fin, err = chained(jnp.asarray(p0), jnp.asarray(rho_t))
    assert np.isfinite(float(err))
    assert np.isfinite(np.asarray(p_fin)).all()


def test_restore_eri_roundtrip_s8():
    """s1/s4/s8 conversions round-trip an 8-fold-symmetric ERI exactly
    (reference ao2mo.restore role, integral.py get_eri_format/restore)."""
    import numpy as np
    from libdmet_preview_tpu.models.integral import restore_eri

    norb = 4
    rng = np.random.RandomState(3)
    g = rng.randn(norb, norb, norb, norb)
    # symmetrize to full 8-fold
    g = g + g.transpose(1, 0, 2, 3)
    g = g + g.transpose(0, 1, 3, 2)
    g = g + g.transpose(2, 3, 0, 1)

    s8 = restore_eri(g, norb, 8)
    s4 = restore_eri(g, norb, 4)
    assert s8.ndim == 1 and s4.ndim == 2
    np.testing.assert_allclose(restore_eri(s4, norb, 8), s8, atol=1e-14)
    np.testing.assert_allclose(restore_eri(s8, norb, 8), s8, atol=1e-14)
    np.testing.assert_allclose(restore_eri(s8, norb, 1), g, atol=1e-14)
    np.testing.assert_allclose(restore_eri(s8, norb, 4), s4, atol=1e-14)


def test_vcor_dca_phsymm():
    """DCA ph-symmetric vcor (reference HubPhSymm.py:213-295
    VcorDCAPhSymm): one parameter per displacement class {v, -v} on the
    impurity torus, AFM sign structure, fixed U/2 diagonal shift."""
    import itertools as it
    from libdmet_preview_tpu.ops.vcor import VcorDCAPhSymm

    U = 4.0
    ImpSize = (4,)
    subA, subB = [0, 2], [1, 3]
    v = VcorDCAPhSymm(U, ImpSize, subA, subB)
    # classes on Z_4: {0}, {1, 3}, {2}
    assert v.length() == 3

    rng = np.random.RandomState(0)
    p = rng.randn(v.length())
    v.update(p)
    V = v.get()
    assert V.shape == (2, 4, 4)

    # behavioral spec transcribed from the reference loop
    sites = [(i,) for i in range(4)]
    sdict = {s: i for i, s in enumerate(sites)}
    vecs_by_class = [[(0,)], [(1,), (3,)], [(2,)]]
    want = np.zeros((2, 4, 4))
    for idxp, vecs in enumerate(vecs_by_class):
        for vec in vecs:
            for i1, s1 in enumerate(sites):
                i2 = sdict[((s1[0] + vec[0]) % 4,)]
                if i1 in subA and i2 in subA:
                    want[0, i1, i2] = p[idxp]
                    want[1, i1, i2] = -p[idxp]
                elif i1 in subB and i2 in subB:
                    want[0, i1, i2] = -p[idxp]
                    want[1, i1, i2] = p[idxp]
                else:
                    want[0, i1, i2] = p[idxp]
                    want[1, i1, i2] = p[idxp]
    want += (U / 2.0) * np.eye(4)
    np.testing.assert_allclose(V, want, atol=1e-12)

    # translation invariance and the {v, -v} pairing
    assert abs(V[0, 0, 1] - V[0, 1, 2]) < 1e-12
    assert abs(V[0, 0, 1] - V[0, 0, 3]) < 1e-12

    # gradient consistent with evaluate
    g = v.gradient()
    assert g.shape == (3, 2, 4, 4)
    for k in range(v.length()):
        dp = np.zeros(v.length())
        dp[k] = 1e-6
        v.update(p + dp)
        Vp = v.get()
        v.update(p - dp)
        Vm = v.get()
        np.testing.assert_allclose((Vp - Vm) / 2e-6, g[k], atol=1e-7)

    # assign() round-trips a representable target
    v.update(p)
    target = v.get() - (U / 2.0) * np.eye(4)
    v2 = VcorDCAPhSymm(U, ImpSize, subA, subB)
    v2.assign(target)
    np.testing.assert_allclose(v2.param, p, atol=1e-10)


def test_rho_fermi_real_matches_doubled():
    """rho_fermi_real (the n x n real-symmetric fit fast path) ==
    zrho_fermi on the doubled embedding: forward, mu, value-grad, and
    mu-grad, including an exactly degenerate pair."""
    import jax
    import jax.numpy as jnp
    from libdmet_preview_tpu.ops.zlinalg import zrho_fermi, rho_fermi_real

    rng = np.random.RandomState(3)
    n = 14
    h = rng.randn(n, n)
    h = (h + h.T) / 2
    w, V = np.linalg.eigh(h)
    w[4] = w[5]                           # exact degeneracy
    h = V @ np.diag(w) @ V.T
    nelec2, beta = 12, 40.0   # smooth N(mu): unique mu, exact comparison

    r0, _, mu0 = zrho_fermi(jnp.asarray(h), jnp.zeros((n, n)), nelec2,
                            beta)
    r1, mu1 = rho_fermi_real(jnp.asarray(h), nelec2, beta)
    assert float(jnp.max(jnp.abs(r0 - r1))) < 1e-12
    assert abs(float(mu0 - mu1)) < 1e-8   # independent bisection brackets

    tgt = rng.randn(n, n)
    tgt = (tgt + tgt.T) / 2

    g0 = jax.grad(lambda x: jnp.sum(
        (zrho_fermi(x, jnp.zeros_like(x), nelec2, beta)[0] - tgt) ** 2
    ))(jnp.asarray(h))
    g1 = jax.grad(lambda x: jnp.sum(
        (rho_fermi_real(x, nelec2, beta)[0] - tgt) ** 2
    ))(jnp.asarray(h))
    assert float(jnp.max(jnp.abs(g0 - g1))) < 1e-11

    gm0 = jax.grad(lambda x: zrho_fermi(
        x, jnp.zeros_like(x), nelec2, beta)[2])(jnp.asarray(h))
    gm1 = jax.grad(lambda x: rho_fermi_real(
        x, nelec2, beta)[1])(jnp.asarray(h))
    # mu enters through its own bisection bracket -> ~1e-10 match
    assert float(jnp.max(jnp.abs(gm0 - gm1))) < 1e-8


def test_lm_engine_ft_matches_cg():
    """The Levenberg-Marquardt embedding-fit engine (exact Daleckii-
    Krein Jacobian, one eigh per iteration) solves the same objective
    as the CG engine: on an achievable target (rho at p_true), with an
    orthonormal basis and no mask, it drives the residual to ~0, and it
    never does worse than CG at equal iteration budget."""
    import jax
    import jax.numpy as jnp
    from libdmet_preview_tpu.ops.fit import _cg_engine, _fit_lm_finite_t
    from libdmet_preview_tpu.ops.zlinalg import rho_fermi_real

    rng = np.random.RandomState(5)
    spin, n, P = 2, 8, 10
    beta, nelec2 = 400.0, 8    # 4 electrons in 8 orbitals (half filled)
    embH1 = rng.randn(spin, n, n)
    embH1 = jnp.asarray(embH1 + embH1.transpose(0, 2, 1))
    dV = rng.randn(P, spin, n, n) * 0.3
    dV = jnp.asarray(dV + dV.transpose(0, 1, 3, 2))
    p_true = jnp.asarray(rng.randn(P) * 0.2)
    Ht = embH1 + jnp.einsum("P, Psij -> sij", p_true, dV)
    target = jnp.stack([rho_fermi_real(Ht[s], nelec2, beta)[0]
                        for s in range(spin)])

    def err_fn(p):
        Heff = embH1 + jnp.einsum("P, Psij -> sij", p, dV)
        errs = 0.0
        for s in range(spin):
            r1, _ = rho_fermi_real(Heff[s], nelec2, beta)
            errs = errs + jnp.sum((r1 - target[s]) ** 2)
        return jnp.sqrt(errs / spin)

    p0 = jnp.zeros(P)
    err_start = float(err_fn(p0))
    fg = jax.value_and_grad(err_fn)
    p_cg, err_cg, _ = _cg_engine(fg, p0, 30, 1e-12, 1e-9)
    Li = jnp.broadcast_to(jnp.eye(n), (spin, n, n))
    mask = jnp.ones((spin, n, n))
    p_lm, err_lm, _ = _fit_lm_finite_t(p0, embH1, dV, Li, mask, target,
                                       1e-12, 1e-9, (nelec2,) * spin,
                                       beta, 30, spin)
    # the LM engine evaluates the same objective it minimizes
    assert abs(float(err_fn(p_lm)) - float(err_lm)) < 1e-10
    assert float(err_lm) < 1e-6            # achievable target reached
    assert float(err_lm) <= float(err_cg) + 1e-8
    assert err_start > 1e-2                # the problem was nontrivial


def test_fit_lm_finite_t_matches_cg_masked():
    """The facade LM engine handles the full FitVcorEmb objective --
    overlap-Cholesky rotation Li + residual mask -- and matches the CG
    engine's minimum on an achievable masked target."""
    import jax.numpy as jnp
    from libdmet_preview_tpu.ops.fit import (_fit_cg_finite_t,
                                             _fit_lm_finite_t)
    from libdmet_preview_tpu.ops.zlinalg import rho_fermi_real

    rng = np.random.RandomState(9)
    spin, n, P = 2, 8, 6
    beta = 300.0
    nelec2 = (8, 6)
    embH1 = rng.randn(spin, n, n)
    embH1 = jnp.asarray(embH1 + embH1.transpose(0, 2, 1))
    dV = rng.randn(P, spin, n, n) * 0.3
    dV = jnp.asarray(dV + dV.transpose(0, 1, 3, 2))
    # nontrivial (but well-conditioned) overlap Cholesky-inverse
    S = np.eye(n) + 0.1 * rng.randn(n, n)
    S = S @ S.T
    Li_m = np.linalg.inv(np.linalg.cholesky(S))
    Li = jnp.asarray(np.stack([Li_m, np.eye(n)]))
    mask = np.zeros((spin, n, n))
    mask[:, :5, :5] = 1.0            # impurity-window fit mask
    mask = jnp.asarray(mask)

    p_true = jnp.asarray(rng.randn(P) * 0.2)
    Ht = embH1 + jnp.einsum("P, Psij -> sij", p_true, dV)
    tgt = []
    for s in range(spin):
        Ho = Li[s] @ Ht[s] @ Li[s].T
        r, _ = rho_fermi_real(Ho, nelec2[s], beta)
        tgt.append((Li[s].T @ r @ Li[s]) * mask[s])
    target = jnp.stack(tgt)

    p0 = jnp.zeros(P)
    p_cg, err_cg, _ = _fit_cg_finite_t(p0, embH1, dV, Li, mask, target,
                                       1e-12, 1e-9, nelec2, beta, 40,
                                       spin)
    p_lm, err_lm, _ = _fit_lm_finite_t(p0, embH1, dV, Li, mask, target,
                                       1e-12, 1e-9, nelec2, beta, 40,
                                       spin)
    assert float(err_lm) < 1e-6
    assert float(err_lm) <= float(err_cg) + 1e-8
