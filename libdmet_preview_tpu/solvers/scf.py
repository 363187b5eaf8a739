"""
Embedded mean field on an `Integral` (JAX rewrite of the reference's
molecular-SCF-on-Integral engine, /root/reference/libdmet/solver/scf.py:255-1341).

The reference builds a fake PySCF Mole and patches JK contractions; here the
SCF is a plain fixed-point iteration on device: jitted Fock build (JK from
the spin-blocked embedding ERIs), batched eigh, DIIS on the host over the
tiny Fock matrices.  Handles RHF (restricted) and UHF ((na, nb) electrons,
arbitrary 2-body with [aa, bb, ab] spin blocks).
"""

import numpy as np
import jax
import jax.numpy as jnp

from libdmet_preview_tpu.utils import logger as log
from libdmet_preview_tpu.ops.diis import DIIS
from libdmet_preview_tpu.models.integral import restore_eri


@jax.jit
def _veff_rhf(dm, eri):
    """dm: (n, n) total density; eri: (n,)*4 s1.  Returns J - K/2."""
    vj = jnp.einsum("pqrs, sr -> pq", eri, dm)
    vk = jnp.einsum("prqs, sr -> pq", eri, dm)
    return vj - 0.5 * vk


@jax.jit
def _veff_uhf(dma, dmb, eri_aa, eri_bb, eri_ab):
    """Per-spin veff from blocked ERIs (chemist (pq|rs); eri_ab = (aa|bb))."""
    ja = jnp.einsum("pqrs, sr -> pq", eri_aa, dma)
    jb = jnp.einsum("pqrs, sr -> pq", eri_bb, dmb)
    jab = jnp.einsum("pqrs, sr -> pq", eri_ab, dmb)   # J on alpha from beta
    jba = jnp.einsum("pqrs, qp -> rs", eri_ab, dma)   # J on beta from alpha
    ka = jnp.einsum("prqs, sr -> pq", eri_aa, dma)
    kb = jnp.einsum("prqs, sr -> pq", eri_bb, dmb)
    va = ja + jab - ka
    vb = jb + jba - kb
    return va, vb


def _eigh_gen(F, S=None):
    if S is None:
        return np.linalg.eigh(F)
    L = np.linalg.cholesky(S)
    Li = np.linalg.inv(L)
    w, c = np.linalg.eigh(Li @ F @ Li.T)
    return w, Li.T @ c


class SCF(object):
    """Embedded HF engine.

    Usage (mirrors the reference scf.SCF contract):
        myscf = SCF()
        myscf.set_system(nelec, spin, bogoliubov, restricted)
        myscf.set_integral(Ham)
        E, rho = myscf.HF(tol=1e-10)
    """

    def __init__(self, newton_ah=False):
        self.nelec = None
        self.spin = 0          # 2*Sz
        self.restricted = True
        self.bogoliubov = False
        self.integral = None
        self.mo_coeff = None
        self.mo_energy = None
        self.mo_occ = None
        self.e_tot = None
        self.rdm1 = None
        self.converged = False

    def set_system(self, nelec, spin, bogoliubov, restricted):
        assert not bogoliubov, "use HFB path for Bogoliubov"
        self.nelec = nelec
        self.spin = spin
        self.restricted = restricted

    def set_integral(self, integral):
        self.integral = integral

    # ------------------------------------------------------------------
    def _eris_s1(self):
        Ham = self.integral
        n = Ham.norb
        H2 = Ham.H2["ccdd"]
        if len(H2) == 1:
            eri = restore_eri(np.asarray(H2[0]), n, symmetry=1)
            return (jnp.asarray(eri),)
        eri_aa = restore_eri(np.asarray(H2[0]), n, symmetry=1)
        eri_bb = restore_eri(np.asarray(H2[1]), n, symmetry=1)
        eri_ab = restore_eri(np.asarray(H2[2]), n, symmetry=1)
        return (jnp.asarray(eri_aa), jnp.asarray(eri_bb), jnp.asarray(eri_ab))

    def _fock(self, dm, h1, eris):
        """Per-spin Fock matrices from the (2, n, n) density."""
        dma, dmb = jnp.asarray(dm[0]), jnp.asarray(dm[1])
        if len(eris) == 1:
            va, vb = _veff_uhf(dma, dmb, eris[0], eris[0], eris[0])
        else:
            va, vb = _veff_uhf(dma, dmb, *eris)
        h1a = h1[0]
        h1b = h1[1] if h1.shape[0] == 2 else h1[0]
        return h1a + np.asarray(va), h1b + np.asarray(vb)

    def _energy(self, dm, Fa, Fb, h1):
        h1a = h1[0]
        h1b = h1[1] if h1.shape[0] == 2 else h1[0]
        return 0.5 * (np.sum((h1a + Fa) * dm[0])
                      + np.sum((h1b + Fb) * dm[1])) \
            + float(self.integral.H0)

    def _oo_minimize(self, dm0, h1, eris, na, nb, S, same_spin, tol):
        """Fallback: direct orbital-rotation minimization E(C0 exp(K))
        with jax gradients + scipy BFGS (robust where Roothaan+DIIS
        oscillates; plays the role of the reference's newton_ah path)."""
        from scipy.optimize import minimize as sp_minimize
        from jax.scipy.linalg import expm
        n = h1.shape[-1]
        Fa, Fb = self._fock(dm0, h1, eris)
        wa, Ca0 = _eigh_gen(Fa, S)
        wb, Cb0 = _eigh_gen(Fb, S)
        h1a = jnp.asarray(h1[0])
        h1b = jnp.asarray(h1[1] if h1.shape[0] == 2 else h1[0])
        tri = np.tril_indices(n, -1)
        nrot = len(tri[0])
        Ca0j, Cb0j = jnp.asarray(Ca0), jnp.asarray(Cb0)
        e_aa = eris[0]
        e_bb = eris[0] if len(eris) == 1 else eris[1]
        e_ab = eris[0] if len(eris) == 1 else eris[2]

        def unpack(p):
            K = jnp.zeros((n, n)).at[tri].set(p)
            return K - K.T

        # the ERI tensors enter as ARGUMENTS: closing over them would
        # bake n^4 constants into the traced program and trigger
        # minutes of XLA constant folding at every re-trace
        def energy(params, g_aa, g_bb, g_ab):
            Ka = unpack(params[:nrot])
            Kb = Ka if same_spin else unpack(params[nrot:])
            Ca = Ca0j @ expm(Ka)
            Cb = Cb0j @ expm(Kb)
            dma = Ca[:, :na] @ Ca[:, :na].T
            dmb = Cb[:, :nb] @ Cb[:, :nb].T
            va, vb = _veff_uhf(dma, dmb, g_aa, g_bb, g_ab)
            E = 0.5 * (jnp.sum((2 * h1a + va) * dma)
                       + jnp.sum((2 * h1b + vb) * dmb))
            return E

        vg = jax.jit(jax.value_and_grad(energy))

        def fun(p):
            v, g = vg(jnp.asarray(p), e_aa, e_bb, e_ab)
            return float(v), np.asarray(g)

        nparam = nrot if same_spin else 2 * nrot
        # small deterministic start offset: lets BFGS escape exact saddles
        x0 = np.random.RandomState(7).randn(nparam) * 1e-3
        res = sp_minimize(fun, x0, jac=True, method="BFGS",
                          options={"gtol": max(tol * 10, 1e-9),
                                   "maxiter": 2000})
        p = res.x
        Ka = np.asarray(unpack(jnp.asarray(p[:nrot])))
        Kb = Ka if same_spin else np.asarray(unpack(jnp.asarray(p[nrot:])))
        import scipy.linalg as sla
        Ca = Ca0 @ sla.expm(Ka)
        Cb = Cb0 @ sla.expm(Kb)
        dm = np.asarray([Ca[:, :na] @ Ca[:, :na].T,
                         Cb[:, :nb] @ Cb[:, :nb].T])
        return dm, res.fun + float(self.integral.H0), bool(res.success)

    def HF(self, tol=1e-10, MaxIter=100, InitGuess=None, DiisDim=8,
           damping=0.0, level_shift=0.0):
        Ham = self.integral
        n = Ham.norb
        nelec = self.nelec
        na = (nelec + self.spin) // 2
        nb = nelec - na
        tol = max(tol, 1e-12)
        S = None if Ham.ovlp is None else np.asarray(Ham.ovlp)
        if S is not None and S.ndim == 3:
            S = S[0]
        if S is not None and np.allclose(S, np.eye(n), atol=1e-12):
            S = None
        Seye = np.eye(n) if S is None else S

        h1 = np.asarray(Ham.H1["cd"])
        eris = self._eris_s1()
        restricted = self.restricted and len(eris) == 1 and na == nb \
            and h1.shape[0] == 1

        if InitGuess is not None:
            dm = np.asarray(InitGuess)
            if dm.ndim == 2:
                dm = np.asarray([dm * 0.5, dm * 0.5])
        else:
            h1a_g, h1b_g = h1[0], h1[1] if h1.shape[0] == 2 else h1[0]
            if not restricted:
                # seed symmetry breaking: alternating on-site staggered
                # field with opposite sign per spin (AFM-like); a symmetric
                # UHF solution is recovered if it is the true minimum
                pol = 0.1 * np.diag([(-1.0) ** i for i in range(n)])
                h1a_g = h1a_g + pol
                h1b_g = h1b_g - pol
            wa, ca = _eigh_gen(h1a_g, S)
            dm_a = (ca[:, :na] @ ca[:, :na].T)
            wb, cb = _eigh_gen(h1b_g, S)
            dm_b = (cb[:, :nb] @ cb[:, :nb].T)
            dm = np.asarray([dm_a, dm_b])

        diis = DIIS(space=DiisDim)
        e_old = np.inf
        conv = False
        wa = wb = None
        ca = cb = None
        for it in range(MaxIter):
            Fa, Fb = self._fock(dm, h1, eris)
            if restricted:
                Fb = Fa = 0.5 * (Fa + Fb)
            E = self._energy(dm, Fa, Fb, h1)

            erra = Fa @ dm[0] @ Seye - Seye @ dm[0] @ Fa
            errb = Fb @ dm[1] @ Seye - Seye @ dm[1] @ Fb
            err_norm = max(np.max(np.abs(erra)), np.max(np.abs(errb)))
            if err_norm < 1.0:  # DIIS only once errors are sane
                F_flat = diis.update(
                    np.hstack([Fa.ravel(), Fb.ravel()]),
                    xerr=np.hstack([erra.ravel(), errb.ravel()]))
                Fa = F_flat[:n * n].reshape(n, n)
                Fb = F_flat[n * n:].reshape(n, n)
            if level_shift > 0:
                Fa = Fa + level_shift * (Seye - Seye @ dm[0] @ Seye)
                Fb = Fb + level_shift * (Seye - Seye @ dm[1] @ Seye)

            wa, ca = _eigh_gen(Fa, S)
            wb, cb = _eigh_gen(Fb, S)
            dm_new = np.asarray([ca[:, :na] @ ca[:, :na].T,
                                 cb[:, :nb] @ cb[:, :nb].T])
            if damping > 0:
                dm_new = (1 - damping) * dm_new + damping * dm
            ddm = np.max(np.abs(dm_new - dm))
            dm = dm_new
            if abs(E - e_old) < tol and err_norm < np.sqrt(tol) \
                    and ddm < np.sqrt(tol):
                conv = True
                e_old = E
                break
            e_old = E

        if not conv:
            # second chance: direct orbital optimization (always lands on a
            # stationary point; Roothaan oscillation-proof).  If the result
            # is non-aufbau (a saddle), restart from the aufbau density of
            # its canonical Fock -- each restart lowers the energy.
            log.info("embedded HF: Roothaan+DIIS stalled, switching to "
                     "orbital-rotation minimization")
            for attempt in range(6):
                dm, E, ok = self._oo_minimize(dm, h1, eris, na, nb, S,
                                              same_spin=restricted, tol=tol)
                Fa, Fb = self._fock(dm, h1, eris)
                if restricted:
                    Fa = Fb = 0.5 * (Fa + Fb)
                wa, ca = _eigh_gen(Fa, S)
                wb, cb = _eigh_gen(Fb, S)
                dm_chk = np.asarray([ca[:, :na] @ ca[:, :na].T,
                                     cb[:, :nb] @ cb[:, :nb].T])
                ddm = np.max(np.abs(dm_chk - dm))
                if ddm < 1e-5:
                    dm = dm_chk
                    conv = ok
                    break
                log.info("embedded HF: non-aufbau stationary point "
                         "(ddm = %.2e), restarting from aufbau filling", ddm)
                dm = dm_chk
            else:
                log.warn("embedded HF: stuck on a non-aufbau stationary "
                         "point (ddm = %.2e)", ddm)
                conv = ok
            e_old = self._energy(dm, *self._fock(dm, h1, eris), h1)

        if conv and not restricted:
            # UHF stability refinement: Roothaan happily converges to the
            # spin-symmetric SADDLE; re-minimize orbital rotations from the
            # solution and adopt any lower symmetry-broken minimum
            # (plays the role of pyscf's stability analysis used by the
            # reference solver stack).
            dm2, E2, ok2 = self._oo_minimize(dm, h1, eris, na, nb, S,
                                             same_spin=False, tol=tol)
            if ok2 and E2 < e_old - 1e-9:
                log.info("embedded UHF: found lower symmetry-broken "
                         "solution (dE = %.3e)", E2 - e_old)
                dm = dm2
                Fa, Fb = self._fock(dm, h1, eris)
                wa, ca = _eigh_gen(Fa, S)
                wb, cb = _eigh_gen(Fb, S)
                dm_chk = np.asarray([ca[:, :na] @ ca[:, :na].T,
                                     cb[:, :nb] @ cb[:, :nb].T])
                if np.max(np.abs(dm_chk - dm)) < 1e-5:
                    dm = dm_chk
                e_old = self._energy(dm, *self._fock(dm, h1, eris), h1)

        self.converged = conv
        if not conv:
            log.warn("embedded HF not converged")
        self.mo_energy = np.asarray([wa, wb])
        self.mo_coeff = np.asarray([ca, cb])
        occa = np.zeros(n)
        occa[:na] = 1
        occb = np.zeros(n)
        occb[:nb] = 1
        self.mo_occ = np.asarray([occa, occb])
        self.e_tot = e_old
        self.rdm1 = dm if not restricted else dm[:1] * 2.0
        if restricted:
            self.mo_energy = self.mo_energy[:1]
            self.mo_coeff = self.mo_coeff[:1]
            self.mo_occ = self.mo_occ[:1] * 2.0
        return e_old, dm


class SCFSolver(object):
    """HF-as-impurity-solver (reference solver/scf_solver.py:19-200 core):
    run(ImpHam, nelec) -> (rdm1 (spin, n, n), E)."""

    def __init__(self, restricted=False, Sz=0, tol=1e-10, max_cycle=200,
                 **kwargs):
        self.restricted = restricted
        self.Sz = Sz
        self.tol = tol
        self.max_cycle = max_cycle
        self.scf = None
        self.onepdm = None
        self.twopdm = None

    def run(self, Ham, nelec=None, dm0=None, **kwargs):
        if nelec is None:
            raise ValueError("SCFSolver.run requires nelec")
        self.scf = SCF()
        self.scf.set_system(nelec, self.Sz, False, self.restricted)
        self.scf.set_integral(Ham)
        E, dm = self.scf.HF(tol=self.tol, MaxIter=self.max_cycle,
                            InitGuess=dm0)
        if Ham.restricted:
            self.onepdm = (0.5 * (dm[0] + dm[1]))[None]
        else:
            self.onepdm = np.asarray(dm)
        return self.onepdm, E

    def make_rdm2(self, Ham=None):
        """HF 2-RDM from the 1-RDM (for run_dmet_ham)."""
        dm = self.onepdm
        if dm.shape[0] == 1:
            # restricted combined-block convention (matches FCI solver)
            d = dm[0] * 2.0  # total density
            G = (np.einsum("pq, rs -> pqrs", d, d)
                 - 0.5 * np.einsum("ps, rq -> pqrs", d, d))
            self.twopdm = G[None]
        else:
            da, db = dm[0], dm[1]
            Gaa = (np.einsum("pq, rs -> pqrs", da, da)
                   - np.einsum("ps, rq -> pqrs", da, da))
            Gbb = (np.einsum("pq, rs -> pqrs", db, db)
                   - np.einsum("ps, rq -> pqrs", db, db))
            Gab = np.einsum("pq, rs -> pqrs", da, db)
            self.twopdm = np.asarray([Gaa, Gbb, Gab])
        return self.twopdm

    def run_dmet_ham(self, Ham, **kwargs):
        self.make_rdm2()
        r1, r2 = self.onepdm, self.twopdm
        H1 = np.asarray(Ham.H1["cd"])
        H2 = Ham.H2["ccdd"]
        n = Ham.norb
        if Ham.restricted:
            h2 = restore_eri(np.asarray(H2[0]), n, symmetry=1)
            E1 = 2.0 * np.sum(H1[0] * r1[0])
            # restricted combined-block convention: G_tot with 0.5 prefactor
            d = r1[0] * 2.0
            Gtot = (np.einsum("pq, rs -> pqrs", d, d)
                    - 0.5 * np.einsum("ps, rq -> pqrs", d, d))
            E2 = 0.5 * np.einsum("pqrs, pqrs", h2, Gtot)
        else:
            haa = restore_eri(np.asarray(H2[0]), n, symmetry=1)
            hbb = restore_eri(np.asarray(H2[1]), n, symmetry=1)
            hab = restore_eri(np.asarray(H2[2]), n, symmetry=1)
            E1 = np.sum(H1[0] * r1[0]) + np.sum(H1[1] * r1[1])
            E2 = 0.5 * np.einsum("pqrs, pqrs", haa, r2[0]) \
                + 0.5 * np.einsum("pqrs, pqrs", hbb, r2[1]) \
                + np.einsum("pqrs, pqrs", hab, r2[2])
        return E1 + E2 + float(Ham.H0)

    def cleanup(self):
        pass


def ao2mo_Ham(Ham, C):
    """Rotate an Integral into an MO basis (reference solver/scf.py:121-230
    ao2mo_Ham role): H1/H2 transformed per spin; H0 unchanged.

    C: (nao, nmo) or (spin, nao, nmo).  Restricted Integrals stay
    restricted; unrestricted rotate each spin block (H2 spin order
    [aa, bb, ab])."""
    import jax.numpy as jnp
    import jax
    from libdmet_preview_tpu.models.integral import Integral, restore_eri
    C = np.asarray(C)
    n = Ham.norb
    H1 = np.asarray(Ham.H1["cd"])
    spin = H1.shape[0]
    if C.ndim == 2:
        C = np.asarray([C] * spin)
    nmo = C.shape[-1]

    @jax.jit
    def t4(g, ca, cb):
        return jnp.einsum("pqrs, pi, qj, rk, sl -> ijkl", g, ca, ca,
                          cb, cb, optimize=True)

    h1 = np.asarray([C[s].T @ H1[s] @ C[s] for s in range(spin)])
    H2 = Ham.H2["ccdd"]
    if len(H2) == 1:
        g = jnp.asarray(restore_eri(np.asarray(H2[0]), n, 1))
        g_mo = np.asarray(t4(g, jnp.asarray(C[0]), jnp.asarray(C[0])))[None]
    else:
        gs = [jnp.asarray(restore_eri(np.asarray(H2[i]), n, 1))
              for i in range(3)]
        Ca, Cb = jnp.asarray(C[0]), jnp.asarray(C[1])
        g_mo = np.asarray([np.asarray(t4(gs[0], Ca, Ca)),
                           np.asarray(t4(gs[1], Cb, Cb)),
                           np.asarray(t4(gs[2], Ca, Cb))])
    return Integral(nmo, Ham.restricted, Ham.bogoliubov, Ham.H0,
                    {"cd": h1}, {"ccdd": g_mo})


def restore_Ham(Ham_mo, C, ovlp=None):
    """Back-rotate an MO-basis Integral to the original basis (inverse of
    ao2mo_Ham for S-orthonormal C): X_ao = (S C) X_mo (S C)^T, i.e.
    ao2mo_Ham with the rotation (S C)^T."""
    C = np.asarray(C)
    n = C.shape[-2]
    S = np.eye(n) if ovlp is None else np.asarray(ovlp)
    if C.ndim == 2:
        return ao2mo_Ham(Ham_mo, (S @ C).T)
    return ao2mo_Ham(Ham_mo, np.asarray([(S @ C[s]).T
                                         for s in range(C.shape[0])]))


@jax.jit
def _veff_ghf(dm, eri):
    """Single-species (generalized spin-orbital) veff: J - K with full
    exchange (reference solver/scf.py:255-353 _get_veff_ghf role)."""
    vj = jnp.einsum("pqrs, sr -> pq", eri, dm)
    vk = jnp.einsum("psrq, sr -> pq", eri, dm)
    return vj - vk


def GGHF(Ham, nelec, dm0=None, tol=1e-11, max_cycle=200, diis_dim=8,
         v_ext=None):
    """Generalized HF on a dense spin-orbital Integral (reference
    solver/scf.py:765 GGHF / :865 GIHF): one fermion species over all
    norb spin orbitals, F = h + J(rho) - K(rho), aufbau occupation of
    nelec orbitals, Pulay DIIS on the Fock commutator.

    v_ext: optional static 1-body addition (e.g. a fitted -mu*Na+mu*Nb).
    Returns (E, rho, C, mo_energy); E includes Ham.H0 and the v_ext
    one-body contribution."""
    n = Ham.norb
    h1 = np.asarray(Ham.H1["cd"][0])
    if v_ext is not None:
        h1 = h1 + np.asarray(v_ext)
    g = np.asarray(Ham.H2["ccdd"][0])
    if g.ndim == 2:
        g = restore_eri(g, n, 1)
    gj = jnp.asarray(g)

    if dm0 is None:
        ew, ev = np.linalg.eigh(h1)
        rho = ev[:, :nelec] @ ev[:, :nelec].T
    else:
        rho = np.asarray(dm0)
    diis = DIIS(space=diis_dim)
    E_old = np.inf
    for it in range(max_cycle):
        F = h1 + np.asarray(_veff_ghf(jnp.asarray(rho), gj))
        err = F @ rho - rho @ F
        if np.abs(err).max() < 1.0:
            F = diis.update(F.ravel(), xerr=err.ravel()).reshape(n, n)
        ew, ev = np.linalg.eigh(F)
        rho = ev[:, :nelec] @ ev[:, :nelec].T
        E = float(np.sum(h1 * rho)
                  + 0.5 * np.sum(np.asarray(
                      _veff_ghf(jnp.asarray(rho), gj)) * rho))
        if abs(E - E_old) < tol and np.abs(err).max() < np.sqrt(tol):
            E_old = E
            break
        E_old = E
    return E_old + float(Ham.H0), rho, ev, ew


def separate_basis(basis):
    """Split a GSO embedding basis (ncells, nso, neo) into the particle
    (alpha-LO) and hole (beta-LO) row blocks (reference
    spinless_helper.separate_basis)."""
    basis = np.asarray(basis)
    nao = basis.shape[-2] // 2
    return basis[..., :nao, :], basis[..., nao:, :]


def GGHF_mu(Ham, nelec, nelec_target, mu0=0.0, basis=None, dm0=None,
            tol=1e-11, tol_nelec=1e-8, max_cycle=200, mu_bracket=2.0):
    """GSO HF with in-loop chemical-potential fitting (reference
    solver/scf_mu.py:64-286 kernel): the determinant holds a FIXED
    number of transformed particles (nelec spin orbitals occupied) while
    the physical electron count

        n_phys(rho) = tr_a(rho_LO) - tr_b(rho_LO) + nao * ncells

    is driven to nelec_target by a monotone bisection over mu at every
    SCF step, with v_mu = (-mu on particle rows, +mu on hole rows)
    transformed to the embedding basis.

    basis: GSO embedding basis (ncells, nso, neo) -- when None, the
    Hamiltonian orbitals are themselves the particle/hole blocks
    (reference trans_mu_2/_get_nelec_2 convention).
    Returns (E, rho, C, mo_energy, mu)."""
    n = Ham.norb
    h1 = np.asarray(Ham.H1["cd"][0])
    g = np.asarray(Ham.H2["ccdd"][0])
    if g.ndim == 2:
        g = restore_eri(g, n, 1)
    gj = jnp.asarray(g)

    if basis is None:
        nao = n // 2
        Na = np.zeros((n, n))
        Nb = np.zeros((n, n))
        Na[np.arange(nao), np.arange(nao)] = 1.0
        Nb[np.arange(nao, n), np.arange(nao, n)] = 1.0
        n_offset = float(nao)
    else:
        Ra, Rb = separate_basis(basis)
        ncells, nao = Ra.shape[0], Ra.shape[1]
        Na = np.einsum("rap, raq -> pq", Ra, Ra)
        Nb = np.einsum("rap, raq -> pq", Rb, Rb)
        n_offset = float(nao * ncells)
    v_unit = -Na + Nb                      # dv/dmu

    def n_phys(rho):
        return float(np.sum(rho * Na) - np.sum(rho * Nb)) + n_offset

    def fit_mu(F, mu_guess):
        """Monotone bisection: n_phys of the aufbau density of
        F + mu*v_unit is non-decreasing in mu."""
        def n_of(mu):
            ew, ev = np.linalg.eigh(F + mu * v_unit)
            C = ev[:, :nelec]
            return n_phys(C @ C.T)
        lo, hi = mu_guess - mu_bracket, mu_guess + mu_bracket
        k = 0
        while n_of(lo) > nelec_target and k < 30:
            lo -= mu_bracket * 2
            k += 1
        k = 0
        while n_of(hi) < nelec_target and k < 30:
            hi += mu_bracket * 2
            k += 1
        mu = mu_guess
        for _ in range(100):
            mu = 0.5 * (lo + hi)
            nm = n_of(mu)
            if abs(nm - nelec_target) < tol_nelec:
                break
            if nm < nelec_target:
                lo = mu
            else:
                hi = mu
        return mu

    if dm0 is None:
        mu = fit_mu(h1, mu0)
        ew, ev = np.linalg.eigh(h1 + mu * v_unit)
        rho = ev[:, :nelec] @ ev[:, :nelec].T
    else:
        rho, mu = np.asarray(dm0), mu0
    diis = DIIS(space=8)
    E_old = np.inf
    for it in range(max_cycle):
        veff = np.asarray(_veff_ghf(jnp.asarray(rho), gj))
        F0 = h1 + veff
        mu = fit_mu(F0, mu)
        F = F0 + mu * v_unit
        err = F @ rho - rho @ F
        if np.abs(err).max() < 1.0:
            F0 = diis.update(F0.ravel(), xerr=err.ravel()).reshape(n, n)
            mu = fit_mu(F0, mu)
            F = F0 + mu * v_unit
        ew, ev = np.linalg.eigh(F)
        rho = ev[:, :nelec] @ ev[:, :nelec].T
        veff = np.asarray(_veff_ghf(jnp.asarray(rho), gj))
        # energy of the mu-free Hamiltonian (mu is a constraint device)
        E = float(np.sum(h1 * rho) + 0.5 * np.sum(veff * rho))
        if abs(E - E_old) < tol and np.abs(err).max() < np.sqrt(tol):
            E_old = E
            break
        E_old = E
    return E_old + float(Ham.H0), rho, ev, ew, mu
