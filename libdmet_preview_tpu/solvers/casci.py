"""
CASCI impurity solver: FCI in an active space selected by MP2 natural
occupations, HF-frozen core (JAX analog of the reference CASCI
wrapper, /root/reference/libdmet/solver/dmrgci.py:809-1194, with the
MP2-natural-orbital selection of get_orbs).

Also the in-process stand-in for DmrgCI: any FCI-contract solver (e.g. the
external DMRG bridge in solvers/external.py) can be dropped in as the
active-space solver.
"""

import numpy as np
import jax
import jax.numpy as jnp

from libdmet_preview_tpu.utils import logger as log
from libdmet_preview_tpu.models.integral import Integral, restore_eri
from libdmet_preview_tpu.solvers.scf import SCF
from libdmet_preview_tpu.solvers.fci import FCI


def mp2_natural_orbitals(h_mo, g_mo, nocc):
    """Spin-restricted MP2 natural-orbital occupations and rotation.

    h_mo/g_mo in the canonical MO basis (chemist).  Returns (occ, U)
    with U the MO->NO rotation, occupations descending."""
    n = h_mo.shape[0]
    f = h_mo + 2.0 * np.einsum("pqii -> pq", g_mo[:, :, :nocc, :nocc]) \
        - np.einsum("piiq -> pq", g_mo[:, :nocc, :nocc, :])
    eps = np.diag(f)
    eo, ev = eps[:nocc], eps[nocc:]
    # t2[i,j,a,b] = (ia|jb) / (ei + ej - ea - eb)
    g_ovov = g_mo[:nocc, nocc:, :nocc, nocc:]
    denom = (eo[:, None, None, None] + eo[None, None, :, None]
             - ev[None, :, None, None] - ev[None, None, None, :])
    t2 = g_ovov / denom                      # (i, a, j, b)
    # MP2 1-RDM correction (unrelaxed)
    doo = -(2.0 * np.einsum("iajb, kajb -> ik", t2, t2)
            - np.einsum("iajb, kbja -> ik", t2, t2))
    dvv = (2.0 * np.einsum("iajb, icjb -> ac", t2, t2)
           - np.einsum("iajb, ibjc -> ac", t2, t2))
    dm = np.zeros((n, n))
    dm[:nocc, :nocc] = 2.0 * np.eye(nocc) + doo + doo.T
    dm[nocc:, nocc:] = dvv + dvv.T
    w, v = np.linalg.eigh(dm)
    order = np.argsort(w)[::-1]
    return w[order], v[:, order]


class CASCI(object):
    """run(ImpHam, nelec) -> (rdm1, E) with an (ncas, nelecas) active
    space; orbitals = RHF canonical -> MP2 natural orbitals."""

    def __init__(self, ncas, nelecas, restricted=True, Sz=0,
                 fcisolver=None, tol=1e-10, **kwargs):
        assert restricted, "CASCI implemented for restricted references"
        self.ncas = ncas
        self.nelecas = nelecas
        self.Sz = Sz
        self.tol = tol
        self.fcisolver = fcisolver or FCI(restricted=True, Sz=Sz, tol=tol)
        self.onepdm = None
        self.twopdm = None
        self.e_tot = None

    def run(self, Ham, nelec=None, **kwargs):
        if nelec is None:
            raise ValueError("CASCI.run requires nelec")
        n = Ham.norb
        nocc = nelec // 2
        ncore = (nelec - self.nelecas) // 2
        ncas = self.ncas
        assert ncore >= 0 and ncore + ncas <= n

        myscf = SCF()
        myscf.set_system(nelec, 0, False, True)
        myscf.set_integral(Ham)
        e_hf, dm_hf = myscf.HF(tol=1e-11)
        C = myscf.mo_coeff[0]

        h1 = np.asarray(Ham.H1["cd"][0])
        g = restore_eri(np.asarray(Ham.H2["ccdd"][0]), n, 1)
        h_mo = C.T @ h1 @ C
        g_mo = np.asarray(jnp.einsum("pqrs, pi, qj, rk, sl -> ijkl",
                                     jnp.asarray(g), *([jnp.asarray(C)] * 4),
                                     optimize=True))
        # MP2 natural orbitals; keep core/active split by occupation
        occ_no, U = mp2_natural_orbitals(h_mo, g_mo, nocc)
        C_no = C @ U
        C_core = C_no[:, :ncore]
        C_cas = C_no[:, ncore:ncore + ncas]

        dm_core = 2.0 * C_core @ C_core.T
        from libdmet_preview_tpu.solvers.scf import _veff_uhf
        v_core = np.asarray(_veff_uhf(
            jnp.asarray(dm_core * 0.5), jnp.asarray(dm_core * 0.5),
            jnp.asarray(g), jnp.asarray(g), jnp.asarray(g))[0])
        e_core = float(np.sum((h1 + 0.5 * v_core) * dm_core)) + float(Ham.H0)

        h_cas = C_cas.T @ (h1 + v_core) @ C_cas
        g_cas = np.asarray(jnp.einsum(
            "pqrs, pi, qj, rk, sl -> ijkl", jnp.asarray(g),
            *([jnp.asarray(C_cas)] * 4), optimize=True))
        Ham_cas = Integral(ncas, True, False, e_core, {"cd": h_cas[None]},
                           {"ccdd": g_cas[None]})
        rdm_cas, E = self.fcisolver.run(Ham_cas, nelec=self.nelecas)
        # back-transform rdm1 to the site basis (per-spin convention)
        rdm1 = C_cas @ (np.asarray(rdm_cas[0])) @ C_cas.T + 0.5 * dm_core
        self.onepdm = rdm1[None]
        self.e_tot = E
        self._cas = (C_core, C_cas, Ham_cas)
        return self.onepdm, E

    def make_rdm2(self, Ham=None):
        """Full-space spin-summed 2-RDM (chemist (pq|rs), the FCI
        convention E2 = 0.5 sum G_pqrs (pq|rs)): active-space twopdm
        back-transformed with C_cas plus the analytic closed-shell core
        contributions (reference dmrgci.py CASCI make_rdm2 role;
        standard CAS decomposition
          G = G_act + Dc Dc - Dc Dc /2 (exch) + Dc Da cross terms
        with Dc/Da the spin-summed core/active 1-RDMs)."""
        if self.onepdm is None:
            raise RuntimeError("run CASCI before make_rdm2")
        C_core, C_cas, Ham_cas = self._cas
        G_act_cas = np.asarray(self.fcisolver.make_rdm2(Ham_cas))[0]
        G = np.array(jnp.einsum(
            "pqrs, ip, jq, kr, ls -> ijkl", jnp.asarray(G_act_cas),
            *([jnp.asarray(C_cas)] * 4), optimize=True))
        Dc = 2.0 * C_core @ C_core.T
        Da = 2.0 * C_cas @ np.asarray(
            self.fcisolver.onepdm[0]) @ C_cas.T
        G += (np.einsum("pq, rs -> pqrs", Dc, Dc)
              - 0.5 * np.einsum("ps, rq -> pqrs", Dc, Dc))
        G += (np.einsum("pq, rs -> pqrs", Dc, Da)
              + np.einsum("pq, rs -> pqrs", Da, Dc)
              - 0.5 * np.einsum("ps, rq -> pqrs", Dc, Da)
              - 0.5 * np.einsum("ps, rq -> pqrs", Da, Dc))
        self.twopdm = G[None]
        return self.twopdm

    def run_dmet_ham(self, Ham, **kwargs):
        """Evaluate the scaled DMET Hamiltonian's energy with the stored
        rdm1/rdm2 (reference solver contract)."""
        self.make_rdm2()
        h1 = np.asarray(Ham.H1["cd"][0])
        h2 = np.asarray(Ham.H2["ccdd"][0])
        if h2.ndim == 2:
            h2 = restore_eri(h2, Ham.norb, 1)
        E1 = np.einsum("pq, qp", h1, self.onepdm[0]) * 2.0
        E2 = np.einsum("pqrs, pqrs", h2, self.twopdm[0]) * 0.5
        return E1 + E2 + float(Ham.H0)

    def cleanup(self):
        pass


class UCASCI(object):
    """UNRESTRICTED CASCI: UHF reference, per-spin canonical orbitals,
    an (ncas, nelecas) active window straddling the Fermi level in each
    spin channel, spin-dependent FCI (direct_uhf-class kernel) in the
    active space (reference UHF-orbital CAS stack:
    /root/reference/libdmet/solver/dmrgci.py CASCI-with-UHF-orbitals and
    the umc1step.py orbital frame).

    This is the static-correlation solver for spin-polarized d-block
    embeddings (NiO/cuprates) where single-reference UCCSD stalls on the
    near-degenerate d manifold: the d-dominated frontier orbitals land
    in the active window and are solved exactly."""

    def __init__(self, ncas, nelecas, Sz=0, fcisolver=None, tol=1e-10,
                 **kwargs):
        self.ncas = ncas
        if isinstance(nelecas, (tuple, list)):
            self.na_cas, self.nb_cas = nelecas
        else:
            self.na_cas = (nelecas + Sz) // 2
            self.nb_cas = nelecas - self.na_cas
        self.Sz = Sz
        self.tol = tol
        self.fcisolver = fcisolver or FCI(
            restricted=False, Sz=self.na_cas - self.nb_cas, tol=tol)
        self.onepdm = None
        self.twopdm = None
        self.e_tot = None

    @staticmethod
    def _unpack(Ham):
        n = Ham.norb
        H1 = np.asarray(Ham.H1["cd"])
        h1a = H1[0]
        h1b = H1[1] if H1.shape[0] == 2 else H1[0]
        H2 = Ham.H2["ccdd"]
        if len(H2) == 1:
            g = restore_eri(np.asarray(H2[0]), n, symmetry=1)
            g_aa = g_bb = g_ab = g
        else:
            g_aa = restore_eri(np.asarray(H2[0]), n, symmetry=1)
            g_bb = restore_eri(np.asarray(H2[1]), n, symmetry=1)
            g_ab = restore_eri(np.asarray(H2[2]), n, symmetry=1)
        return h1a, h1b, g_aa, g_bb, g_ab

    def run(self, Ham, nelec=None, dm0=None, **kwargs):
        from libdmet_preview_tpu.solvers.scf import _veff_uhf
        if nelec is None:
            raise ValueError("UCASCI.run requires nelec")
        n = Ham.norb
        na = (nelec + self.Sz) // 2
        nb = nelec - na
        ncas = self.ncas
        nca, ncb = na - self.na_cas, nb - self.nb_cas
        log.eassert(nca >= 0 and ncb >= 0 and max(nca, ncb) + ncas <= n,
                    "active window (%d, (%d,%d)) incompatible with "
                    "nelec=(%d,%d), norb=%d", ncas, self.na_cas,
                    self.nb_cas, na, nb, n)

        myscf = SCF()
        myscf.set_system(nelec, self.Sz, False, False)
        myscf.set_integral(Ham)
        myscf.HF(tol=min(self.tol, 1e-10), MaxIter=500, InitGuess=dm0)
        mo = myscf.mo_coeff
        Ca = np.asarray(mo[0])
        Cb = np.asarray(mo[1] if mo.shape[0] == 2 else mo[0])

        h1a, h1b, g_aa, g_bb, g_ab = self._unpack(Ham)
        Cca, Ccb = Ca[:, :nca], Cb[:, :ncb]
        dmca, dmcb = Cca @ Cca.T, Ccb @ Ccb.T
        va, vb = [np.asarray(x) for x in _veff_uhf(
            jnp.asarray(dmca), jnp.asarray(dmcb), jnp.asarray(g_aa),
            jnp.asarray(g_bb), jnp.asarray(g_ab))]
        e_core = (np.sum((h1a + 0.5 * va) * dmca)
                  + np.sum((h1b + 0.5 * vb) * dmcb) + float(Ham.H0))
        Aa = Ca[:, nca:nca + ncas]
        Ab = Cb[:, ncb:ncb + ncas]
        h_a = Aa.T @ (h1a + va) @ Aa
        h_b = Ab.T @ (h1b + vb) @ Ab
        jAa, jAb = jnp.asarray(Aa), jnp.asarray(Ab)
        g_cas_aa = np.asarray(jnp.einsum(
            "pqrs, pi, qj, rk, sl -> ijkl", jnp.asarray(g_aa),
            jAa, jAa, jAa, jAa, optimize=True))
        g_cas_bb = np.asarray(jnp.einsum(
            "pqrs, pi, qj, rk, sl -> ijkl", jnp.asarray(g_bb),
            jAb, jAb, jAb, jAb, optimize=True))
        g_cas_ab = np.asarray(jnp.einsum(
            "pqrs, pi, qj, rk, sl -> ijkl", jnp.asarray(g_ab),
            jAa, jAa, jAb, jAb, optimize=True))
        Ham_cas = Integral(ncas, False, False, e_core,
                           {"cd": np.array([h_a, h_b])},
                           {"ccdd": np.array([g_cas_aa, g_cas_bb,
                                              g_cas_ab])})
        rdm_cas, E = self.fcisolver.run(
            Ham_cas, nelec=self.na_cas + self.nb_cas)
        rdm1_a = Aa @ np.asarray(rdm_cas[0]) @ Aa.T + dmca
        rdm1_b = Ab @ np.asarray(rdm_cas[1]) @ Ab.T + dmcb
        self.onepdm = np.asarray([rdm1_a, rdm1_b])
        self.e_tot = E
        self._cas = (Aa, Ab, dmca, dmcb, Ham_cas,
                     np.asarray(rdm_cas[0]), np.asarray(rdm_cas[1]))
        return self.onepdm, E

    def make_rdm2(self, Ham=None):
        """Spin-resolved full-space 2-RDM blocks [Gaa, Gbb, Gab]
        (chemist, the unrestricted run_dmet_ham convention
        E2 = 0.5 Gaa g_aa + 0.5 Gbb g_bb + Gab g_ab): active blocks
        back-transformed + idempotent-core / core-active mean-field
        terms (spin-resolved CAS decomposition; same algebra as the
        restricted CASCI.make_rdm2 with the spin sum undone)."""
        if self.onepdm is None:
            raise RuntimeError("run UCASCI before make_rdm2")
        Aa, Ab, dmca, dmcb, Ham_cas, da, db = self._cas
        Gaa_c, Gbb_c, Gab_c = [np.asarray(x) for x in
                               self.fcisolver.make_rdm2(Ham_cas)]
        Daa = Aa @ da @ Aa.T
        Dab = Ab @ db @ Ab.T

        def back(G, C1, C2):
            return np.array(jnp.einsum(
                "pqrs, ip, jq, kr, ls -> ijkl", jnp.asarray(G),
                jnp.asarray(C1), jnp.asarray(C1), jnp.asarray(C2),
                jnp.asarray(C2), optimize=True))

        def same_spin(G_act, Dc, Da_):
            G = back(G_act, *([Aa if Dc is dmca else Ab] * 2))
            G += (np.einsum("pq, rs -> pqrs", Dc, Dc)
                  - np.einsum("ps, rq -> pqrs", Dc, Dc))
            G += (np.einsum("pq, rs -> pqrs", Dc, Da_)
                  + np.einsum("pq, rs -> pqrs", Da_, Dc)
                  - np.einsum("ps, rq -> pqrs", Dc, Da_)
                  - np.einsum("ps, rq -> pqrs", Da_, Dc))
            return G

        Gaa = same_spin(Gaa_c, dmca, Daa)
        Gbb = same_spin(Gbb_c, dmcb, Dab)
        Gab = back(Gab_c, Aa, Ab)
        Gab += (np.einsum("pq, rs -> pqrs", dmca, dmcb)
                + np.einsum("pq, rs -> pqrs", dmca, Dab)
                + np.einsum("pq, rs -> pqrs", Daa, dmcb))
        self.twopdm = np.asarray([Gaa, Gbb, Gab])
        return self.twopdm

    def run_dmet_ham(self, Ham, last_aabb=True, **kwargs):
        """Scaled-DMET-Hamiltonian energy with the stored RDMs
        (unrestricted solver contract, as cc.py run_dmet_ham)."""
        if self.twopdm is None:
            self.make_rdm2()
        n = Ham.norb
        H1 = np.asarray(Ham.H1["cd"])
        h1b = H1[1] if H1.shape[0] == 2 else H1[0]
        H2 = Ham.H2["ccdd"]
        h2 = [np.asarray(x) for x in H2]
        h2 = [restore_eri(x, n, 1) if x.ndim == 2 else x for x in h2]
        if len(h2) == 1:
            h2 = [h2[0]] * 3
        r1, r2 = self.onepdm, self.twopdm
        E1 = np.sum(H1[0] * r1[0]) + np.sum(h1b * r1[1])
        E2 = (0.5 * np.einsum("pqrs, pqrs", h2[0], r2[0])
              + 0.5 * np.einsum("pqrs, pqrs", h2[1], r2[1])
              + np.einsum("pqrs, pqrs", h2[2], r2[2]))
        return E1 + E2 + float(Ham.H0)

    def cleanup(self):
        pass


def project_active_space(Ham, nelec, ncas, nelecas, mo_coeff=None):
    """Active-space projection of an embedding Integral (reference
    slater.py:2121-2277 active-space projectors): fold the HF core into
    an effective (ncas, nelecas) Integral.

    Returns (Ham_cas, info) with info = {C_core, C_cas, e_core} for
    back-transforming solver RDMs:
        rdm1_full = C_cas rdm1_cas C_cas^T + 0.5 * dm_core   (per spin)
    """
    import jax.numpy as jnp
    from libdmet_preview_tpu.solvers.scf import _veff_uhf
    n = Ham.norb
    nocc = nelec // 2
    ncore = (nelec - nelecas) // 2
    assert ncore >= 0 and ncore + ncas <= n
    if mo_coeff is None:
        myscf = SCF()
        myscf.set_system(nelec, 0, False, True)
        myscf.set_integral(Ham)
        myscf.HF(tol=1e-11)
        mo_coeff = myscf.mo_coeff[0]
    C = np.asarray(mo_coeff)
    h1 = np.asarray(Ham.H1["cd"][0])
    g = restore_eri(np.asarray(Ham.H2["ccdd"][0]), n, 1)
    C_core = C[:, :ncore]
    C_cas = C[:, ncore:ncore + ncas]
    dm_core = 2.0 * C_core @ C_core.T
    v_core = np.asarray(_veff_uhf(
        jnp.asarray(dm_core * 0.5), jnp.asarray(dm_core * 0.5),
        jnp.asarray(g), jnp.asarray(g), jnp.asarray(g))[0])
    e_core = float(np.sum((h1 + 0.5 * v_core) * dm_core)) + float(Ham.H0)
    h_cas = C_cas.T @ (h1 + v_core) @ C_cas
    g_cas = np.asarray(jnp.einsum(
        "pqrs, pi, qj, rk, sl -> ijkl", jnp.asarray(g),
        *([jnp.asarray(C_cas)] * 4), optimize=True))
    Ham_cas = Integral(ncas, True, False, e_core, {"cd": h_cas[None]},
                       {"ccdd": g_cas[None]})
    info = {"C_core": C_core, "C_cas": C_cas, "e_core": e_core,
            "dm_core": dm_core}
    return Ham_cas, info


class CASSCF(object):
    """Orbital-optimized CASCI with SECOND-ORDER orbital steps
    (reference solver/umc1step.py:1210 / casscf.py:137 capability):
    macro-iterate CAS solve -> analytic orbital optimization.  The
    inner problem is the exact fixed-CI energy functional

        E(kappa) = Tr[h(kappa) D] + 1/2 sum G g(kappa),  C -> C e^kappa

    with the CASCI full-space RDMs (D, G) held fixed; its gradient and
    Hessian-vector products come from jax autodiff through expm + the
    integral rotations, minimized by the trust-region-Newton engine
    (ops.fit.minimize(method='NEWTON'), Steihaug CG) over the
    nonredundant rotations (core-active, core-virtual, active-virtual).
    Any solver with the run/make_rdm2 contract works as the CAS solver
    -- pass the Block-DMRG bridge for DMRG-SCF (reference casscf.py:137;
    tests/test_solvers_extra.py composition test)."""

    def __init__(self, ncas, nelecas, restricted=True, tol=1e-8,
                 max_cycle=30, fcisolver=None):
        assert restricted
        self.ncas = ncas
        self.nelecas = nelecas
        self.tol = tol
        self.max_cycle = max_cycle
        self.fcisolver = fcisolver
        self.onepdm = None
        self.e_tot = None
        self.mo_coeff = None
        self.converged = False

    def run(self, Ham, nelec=None, **kwargs):
        import jax
        import jax.numpy as jnp
        from jax.scipy.linalg import expm as jexpm
        import scipy.linalg as sla
        from libdmet_preview_tpu.ops.fit import minimize as fit_minimize
        if nelec is None:
            raise ValueError("CASSCF.run requires nelec")
        n = Ham.norb
        ncore = (nelec - self.nelecas) // 2
        ncas = self.ncas
        nvirt = n - ncore - ncas
        assert ncore >= 0 and nvirt >= 0

        # start from the CASCI solution's orbitals (HF -> MP2 NOs)
        cas = CASCI(self.ncas, self.nelecas, fcisolver=self.fcisolver)
        _, E = cas.run(Ham, nelec=nelec)
        C_core, C_cas, _ = cas._cas
        C0 = np.hstack([C_core, C_cas])
        resid = np.eye(n) - C0 @ C0.T
        w, v = np.linalg.eigh(resid)
        C_virt = v[:, -nvirt:] if nvirt > 0 else np.zeros((n, 0))
        C_full = np.hstack([C0, C_virt])

        pairs = [(i, j) for i in range(ncore) for j in
                 range(ncore, ncore + ncas)]
        pairs += [(i, j) for i in range(ncore) for j in
                  range(ncore + ncas, n)]
        pairs += [(i, j) for i in range(ncore, ncore + ncas) for j in
                  range(ncore + ncas, n)]
        npar = len(pairs)
        rows = np.array([p[0] for p in pairs], dtype=int)
        cols = np.array([p[1] for p in pairs], dtype=int)

        h1 = jnp.asarray(np.asarray(Ham.H1["cd"][0]))
        g = jnp.asarray(restore_eri(np.asarray(Ham.H2["ccdd"][0]), n, 1))
        H0 = float(Ham.H0)

        def mo_rdms():
            """Full-space (D spin-summed rdm1, G spin-summed rdm2) in
            the CURRENT MO basis (core | act | virt)."""
            G_act = np.asarray(cas.fcisolver.make_rdm2(cas._cas[2]))[0]
            d_act = 2.0 * np.asarray(cas.fcisolver.onepdm[0])
            D = np.zeros((n, n))
            D[:ncore, :ncore] = 2.0 * np.eye(ncore)
            a = slice(ncore, ncore + ncas)
            D[a, a] = d_act
            G = np.zeros((n, n, n, n))
            G[a, a, a, a] = G_act
            Dc = np.zeros((n, n))
            Dc[:ncore, :ncore] = 2.0 * np.eye(ncore)
            Da = np.zeros((n, n))
            Da[a, a] = d_act
            G += (np.einsum("pq, rs -> pqrs", Dc, Dc)
                  - 0.5 * np.einsum("ps, rq -> pqrs", Dc, Dc))
            G += (np.einsum("pq, rs -> pqrs", Dc, Da)
                  + np.einsum("pq, rs -> pqrs", Da, Dc)
                  - 0.5 * np.einsum("ps, rq -> pqrs", Dc, Da)
                  - 0.5 * np.einsum("ps, rq -> pqrs", Da, Dc))
            return jnp.asarray(D), jnp.asarray(G)

        @jax.jit
        def e_kappa(p, Cj, D, G):
            K = jnp.zeros((n, n)).at[rows, cols].set(p)
            K = K - K.T
            C = Cj @ jexpm(K)
            h_mo = C.T @ h1 @ C
            g_mo = jnp.einsum("pqrs, pi, qj, rk, sl -> ijkl", g, C, C,
                              C, C, optimize=True)
            return (jnp.einsum("pq, qp ->", h_mo, D)
                    + 0.5 * jnp.einsum("pqrs, pqrs ->", g_mo, G) + H0)

        grad_fn = jax.jit(jax.grad(e_kappa))

        self.converged = False
        for macro in range(self.max_cycle):
            D, G = mo_rdms()
            Cj = jnp.asarray(C_full)
            g0 = np.asarray(grad_fn(jnp.zeros(npar), Cj, D, G))
            if npar == 0 or np.max(np.abs(g0)) < self.tol * 10:
                self.converged = True
                break

            def fun_grad(p):
                pj = jnp.asarray(p)
                return (float(e_kappa(pj, Cj, D, G)),
                        np.asarray(grad_fn(pj, Cj, D, G)))

            def hvp(x, pvec):
                return np.asarray(jax.jvp(
                    lambda q: grad_fn(q, Cj, D, G),
                    (jnp.asarray(x),), (jnp.asarray(pvec),))[1])

            p_opt, _ = fit_minimize(fun_grad, np.zeros(npar),
                                    method="NEWTON", max_iter=30,
                                    hvp=hvp, gtol=self.tol,
                                    trust_radius=0.4)
            K = np.zeros((n, n))
            K[rows, cols] = p_opt
            K = K - K.T
            C_full = C_full @ sla.expm(K)
            # re-solve the CAS problem in the rotated orbitals
            Ham_cas, info = project_active_space(
                Ham, nelec, ncas, self.nelecas, mo_coeff=C_full)
            rdm_cas, E = cas.fcisolver.run(Ham_cas,
                                           nelec=self.nelecas)
            cas._cas = (info["C_core"], info["C_cas"], Ham_cas)
            cas.onepdm = (info["C_cas"] @ np.asarray(rdm_cas[0])
                          @ info["C_cas"].T
                          + 0.5 * info["dm_core"])[None]

        C_cor = C_full[:, :ncore]
        C_act = C_full[:, ncore:ncore + ncas]
        rdm1 = cas.onepdm
        self.onepdm = np.asarray(rdm1)
        self.e_tot = float(E)
        self.mo_coeff = C_full
        self._cas = (C_cor, C_act, cas._cas[2])
        self.fcisolver = cas.fcisolver
        return self.onepdm, self.e_tot

    def cleanup(self):
        pass


def _gso_core_embed(h1, g, H0, C_core, C_cas):
    """Freeze-core embedding for a SINGLE-SPECIES (generalized spin
    orbital) Hamiltonian: closed-core mean field v_core = J - K with
    exchange coefficient 1, core energy, and the active-window Integral
    (shared by GCASCI and GCASSCF; reference gcasci.py h1e_for_cas /
    gmc_ao2mo.py roles)."""
    ncas = C_cas.shape[1]
    rho_c = C_core @ C_core.T
    gj, rj = jnp.asarray(g), jnp.asarray(rho_c)
    v_core = np.asarray(jnp.einsum("pqrs, sr -> pq", gj, rj)
                        - jnp.einsum("psrq, sr -> pq", gj, rj))
    e_core = float(np.sum((h1 + 0.5 * v_core) * rho_c)) + float(H0)
    h_cas = C_cas.T @ (h1 + v_core) @ C_cas
    g_cas = np.asarray(jnp.einsum(
        "pqrs, pi, qj, rk, sl -> ijkl", gj,
        *([jnp.asarray(C_cas)] * 4), optimize=True))
    return Integral(ncas, True, False, e_core,
                    {"cd": h_cas[None]}, {"ccdd": g_cas[None]})


class GCASCI(object):
    """GSO-frame CASCI on generalized spin orbitals (reference
    /root/reference/libdmet/solver/gcasci.py:1-711 `GCASCI` +
    gso_dmrgci.py:1-141 `DmrgCI` composition; the BCS-frame variant
    bcs_dmrgci.py:1-450 is subsumed by design -- this package runs BCS
    DMET in the GSO frame after the particle-hole transform, so the
    quasiparticle CASCI IS this class on the transformed Integral).

    All orbital counts are SPIN-ORBITAL counts: an (ncas, nelecas)
    window holds ncas spin orbitals and nelecas particles. The reference
    GHF determinant comes from an in-module generalized HF; the active
    window is chosen by canonical orbital energies around the Fermi
    level, or (cas_from_1pdm role, reference gcasci.py:23-54) by natural
    occupations of a supplied dm0. Any solver with the FCI-contract
    (run/make_rdm2 on a restricted-storage spin-orbital Integral) drops
    in as fcisolver -- FCI(ghf=True) in-process, or the Block bridge for
    the DMRG-CI composition."""

    def __init__(self, ncas, nelecas, fcisolver=None, tol=1e-10,
                 nat_orb=False, **kwargs):
        self.ncas = ncas
        self.nelecas = nelecas
        self.tol = tol
        self.nat_orb = nat_orb
        self.fcisolver = fcisolver or FCI(restricted=True, ghf=True,
                                          tol=tol)
        self.onepdm = None
        self.twopdm = None
        self.e_tot = None

    def run(self, Ham, nelec=None, dm0=None, **kwargs):
        if nelec is None:
            raise ValueError("GCASCI.run requires nelec")
        n = Ham.norb
        ncas, nelecas = self.ncas, self.nelecas
        ncore = nelec - nelecas
        assert ncore >= 0 and ncore + ncas <= n

        h1 = np.asarray(Ham.H1["cd"][0])
        g = np.asarray(Ham.H2["ccdd"][0])
        if g.ndim == 2:
            g = restore_eri(g, n, 1)

        from libdmet_preview_tpu.solvers.scf import GGHF
        e_hf, rho_hf, C, mo_e = GGHF(Ham, nelec, dm0=dm0, tol=self.tol)
        if self.nat_orb:
            # natural orbitals of the mean-field density (dm0 if given):
            # occupations descending, core = most occupied
            src = np.asarray(dm0) if dm0 is not None else rho_hf
            w, v = np.linalg.eigh(src)
            C = v[:, ::-1]
        C_core = C[:, :ncore]
        C_cas = C[:, ncore:ncore + ncas]

        Ham_cas = _gso_core_embed(h1, g, Ham.H0, C_core, C_cas)
        rdm_cas, E = self.fcisolver.run(Ham_cas, nelec=nelecas, **kwargs)
        self.onepdm = (C_core @ C_core.T
                       + C_cas @ np.asarray(rdm_cas[0]) @ C_cas.T)[None]
        self.e_tot = float(E)
        self._cas = (C_core, C_cas, Ham_cas)
        return self.onepdm, self.e_tot

    def make_rdm2(self, Ham=None):
        """Full-space spin-orbital 2-RDM, chemist (pq|rs) pairing
        (E2 = 0.5 sum G_pqrs (pq|rs)): embedded active twopdm + the
        single-species HF core/cross terms (exchange coefficient 1, vs
        0.5 in the spin-summed restricted CASCI above)."""
        if self.onepdm is None:
            raise RuntimeError("run GCASCI before make_rdm2")
        C_core, C_cas, Ham_cas = self._cas
        G_act_cas = np.asarray(self.fcisolver.make_rdm2(Ham_cas))[0]
        G = np.array(jnp.einsum(
            "pqrs, ip, jq, kr, ls -> ijkl", jnp.asarray(G_act_cas),
            *([jnp.asarray(C_cas)] * 4), optimize=True))
        Dc = C_core @ C_core.T
        Da = C_cas @ np.asarray(self.fcisolver.onepdm[0]) @ C_cas.T
        G += (np.einsum("pq, rs -> pqrs", Dc, Dc)
              - np.einsum("ps, rq -> pqrs", Dc, Dc))
        G += (np.einsum("pq, rs -> pqrs", Dc, Da)
              + np.einsum("pq, rs -> pqrs", Da, Dc)
              - np.einsum("ps, rq -> pqrs", Dc, Da)
              - np.einsum("ps, rq -> pqrs", Da, Dc))
        self.twopdm = G[None]
        return self.twopdm

    def run_dmet_ham(self, Ham, **kwargs):
        """Scaled-Hamiltonian energy from the stored rdm1/rdm2 (single
        species: E = sum h rho + 0.5 sum g G + H0)."""
        self.make_rdm2()
        h1 = np.asarray(Ham.H1["cd"][0])
        h2 = np.asarray(Ham.H2["ccdd"][0])
        if h2.ndim == 2:
            h2 = restore_eri(h2, Ham.norb, 1)
        E1 = np.einsum("pq, qp", h1, self.onepdm[0])
        E2 = np.einsum("pqrs, pqrs", h2, self.twopdm[0]) * 0.5
        return E1 + E2 + float(Ham.H0)

    def cleanup(self):
        pass


class GCASSCF(object):
    """GSO-frame orbital-optimized CASCI with SECOND-ORDER orbital
    steps on generalized spin orbitals (reference solver/gmc1step.py
    `CASSCF` + gmc2step.py macro iteration; the BCS-frame
    bcs_dmrgscf.py is subsumed by design -- BCS DMET here runs in the
    GSO frame after the particle-hole transform, so the quasiparticle
    CASSCF IS this class on the transformed Integral).

    Macro-iterate: GCASCI solve -> exact fixed-CI orbital minimization

        E(kappa) = Tr[h(kappa) D] + 1/2 sum G g(kappa),  C -> C e^kappa

    over the nonredundant rotations (core-active, core-virtual,
    active-virtual) of the SPIN-ORBITAL space, with gradients and
    Hessian-vector products from jax autodiff through expm + the
    integral rotations, minimized by trust-region Newton
    (ops.fit.minimize(method='NEWTON'), Steihaug CG).  Any
    FCI-contract solver drops in as fcisolver -- FCI(ghf=True)
    in-process, or the Block bridge for GSO DMRG-SCF (reference
    gso_dmrgci + gmc1step composition)."""

    def __init__(self, ncas, nelecas, tol=1e-8, max_cycle=30,
                 fcisolver=None, **kwargs):
        self.ncas = ncas
        self.nelecas = nelecas
        self.tol = tol
        self.max_cycle = max_cycle
        self.fcisolver = fcisolver
        self.onepdm = None
        self.twopdm = None
        self.e_tot = None
        self.mo_coeff = None
        self.converged = False

    def run(self, Ham, nelec=None, dm0=None, **kwargs):
        from jax.scipy.linalg import expm as jexpm
        import scipy.linalg as sla
        from libdmet_preview_tpu.ops.fit import minimize as fit_minimize
        if nelec is None:
            raise ValueError("GCASSCF.run requires nelec")
        n = Ham.norb
        ncas, nelecas = self.ncas, self.nelecas
        ncore = nelec - nelecas
        nvirt = n - ncore - ncas
        assert ncore >= 0 and nvirt >= 0

        cas = GCASCI(ncas, nelecas, fcisolver=self.fcisolver)
        _, E = cas.run(Ham, nelec=nelec, dm0=dm0, **kwargs)
        C_core, C_cas, _ = cas._cas
        C0 = np.hstack([C_core, C_cas])
        w, v = np.linalg.eigh(np.eye(n) - C0 @ C0.T)
        C_virt = v[:, -nvirt:] if nvirt > 0 else np.zeros((n, 0))
        C_full = np.hstack([C0, C_virt])

        pairs = [(i, j) for i in range(ncore)
                 for j in range(ncore, ncore + ncas)]
        pairs += [(i, j) for i in range(ncore)
                  for j in range(ncore + ncas, n)]
        pairs += [(i, j) for i in range(ncore, ncore + ncas)
                  for j in range(ncore + ncas, n)]
        npar = len(pairs)
        rows = np.array([p[0] for p in pairs], dtype=int)
        cols = np.array([p[1] for p in pairs], dtype=int)

        h1_np = np.asarray(Ham.H1["cd"][0])
        g_np = np.asarray(Ham.H2["ccdd"][0])
        if g_np.ndim == 2:
            g_np = restore_eri(g_np, n, 1)
        h1 = jnp.asarray(h1_np)
        g = jnp.asarray(g_np)
        H0 = float(Ham.H0)

        def mo_rdms():
            """Full-space spin-orbital (D, G) in the CURRENT MO basis
            (core | act | virt); single species -> occupation 1 per
            core orbital, exchange coefficient 1 (same decomposition
            as GCASCI.make_rdm2)."""
            G_act = np.asarray(cas.fcisolver.make_rdm2(cas._cas[2]))[0]
            d_act = np.asarray(cas.fcisolver.onepdm[0])
            D = np.zeros((n, n))
            D[:ncore, :ncore] = np.eye(ncore)
            a = slice(ncore, ncore + ncas)
            D[a, a] = d_act
            G = np.zeros((n, n, n, n))
            G[a, a, a, a] = G_act
            Dc = np.zeros((n, n))
            Dc[:ncore, :ncore] = np.eye(ncore)
            Da = np.zeros((n, n))
            Da[a, a] = d_act
            G += (np.einsum("pq, rs -> pqrs", Dc, Dc)
                  - np.einsum("ps, rq -> pqrs", Dc, Dc))
            G += (np.einsum("pq, rs -> pqrs", Dc, Da)
                  + np.einsum("pq, rs -> pqrs", Da, Dc)
                  - np.einsum("ps, rq -> pqrs", Dc, Da)
                  - np.einsum("ps, rq -> pqrs", Da, Dc))
            return jnp.asarray(D), jnp.asarray(G)

        @jax.jit
        def e_kappa(p, Cj, D, G):
            K = jnp.zeros((n, n)).at[rows, cols].set(p)
            K = K - K.T
            C = Cj @ jexpm(K)
            h_mo = C.T @ h1 @ C
            g_mo = jnp.einsum("pqrs, pi, qj, rk, sl -> ijkl", g, C, C,
                              C, C, optimize=True)
            return (jnp.einsum("pq, qp ->", h_mo, D)
                    + 0.5 * jnp.einsum("pqrs, pqrs ->", g_mo, G) + H0)

        grad_fn = jax.jit(jax.grad(e_kappa))

        self.converged = False
        for macro in range(self.max_cycle):
            D, G = mo_rdms()
            Cj = jnp.asarray(C_full)
            g0 = np.asarray(grad_fn(jnp.zeros(npar), Cj, D, G))
            if npar == 0 or np.max(np.abs(g0)) < self.tol * 10:
                self.converged = True
                break

            def fun_grad(p):
                pj = jnp.asarray(p)
                return (float(e_kappa(pj, Cj, D, G)),
                        np.asarray(grad_fn(pj, Cj, D, G)))

            def hvp(x, pvec):
                return np.asarray(jax.jvp(
                    lambda q: grad_fn(q, Cj, D, G),
                    (jnp.asarray(x),), (jnp.asarray(pvec),))[1])

            p_opt, _ = fit_minimize(fun_grad, np.zeros(npar),
                                    method="NEWTON", max_iter=30,
                                    hvp=hvp, gtol=self.tol,
                                    trust_radius=0.4)
            K = np.zeros((n, n))
            K[rows, cols] = p_opt
            K = K - K.T
            C_full = C_full @ sla.expm(K)
            # re-solve the active problem in the rotated orbitals
            C_core = C_full[:, :ncore]
            C_cas = C_full[:, ncore:ncore + ncas]
            Ham_cas = _gso_core_embed(h1_np, g_np, H0, C_core, C_cas)
            rdm_cas, E = cas.fcisolver.run(Ham_cas, nelec=nelecas)
            cas._cas = (C_core, C_cas, Ham_cas)
            cas.onepdm = (C_core @ C_core.T
                          + C_cas @ np.asarray(rdm_cas[0])
                          @ C_cas.T)[None]

        cas.e_tot = float(E)
        self._gcas = cas
        self._cas = cas._cas
        self.onepdm = np.asarray(cas.onepdm)
        self.e_tot = float(E)
        self.mo_coeff = C_full
        self.fcisolver = cas.fcisolver
        return self.onepdm, self.e_tot

    def make_rdm2(self, Ham=None):
        self.twopdm = self._gcas.make_rdm2(Ham)
        return self.twopdm

    def run_dmet_ham(self, Ham, **kwargs):
        return self._gcas.run_dmet_ham(Ham, **kwargs)

    def cleanup(self):
        pass


class UCASSCF(object):
    """UNRESTRICTED orbital-optimized CASCI with SECOND-ORDER orbital
    steps (reference solver/umc1step.py `CASSCF` + umc2step.py macro
    iteration -- the reference's main CASSCF for UHF-frame embeddings):
    macro-iterate UCASCI solve -> exact fixed-CI orbital minimization
    over PER-SPIN nonredundant rotations (core-active, core-virtual,
    active-virtual in each spin channel),

        E(ka, kb) = sum_s Tr[h_s(k) D_s] + 1/2 Gaa.g_aa(k)
                    + 1/2 Gbb.g_bb(k) + Gab.g_ab(k),
        C_s -> C_s e^{k_s},

    with the UCASCI full-space spin-resolved RDMs held fixed; gradients
    and Hessian-vector products from jax autodiff through expm + the
    integral rotations, minimized by trust-region Newton
    (ops.fit.minimize(method='NEWTON'), Steihaug CG).  This is the
    static-correlation refinement for spin-polarized d-block embeddings
    (NiO/cuprate d manifolds) where the UHF orbital window is not
    optimal."""

    def __init__(self, ncas, nelecas, Sz=0, tol=1e-8, max_cycle=30,
                 fcisolver=None, **kwargs):
        self.ncas = ncas
        self.nelecas = nelecas
        self.Sz = Sz
        self.tol = tol
        self.max_cycle = max_cycle
        self.fcisolver = fcisolver
        self.onepdm = None
        self.twopdm = None
        self.e_tot = None
        self.mo_coeff = None
        self.converged = False

    @staticmethod
    def _core_cols(dm, nc):
        """Recover core orbital columns from the idempotent per-spin
        core density (occupied eigenvectors)."""
        if nc == 0:
            return np.zeros((dm.shape[0], 0))
        w, v = np.linalg.eigh(dm)
        return v[:, -nc:]

    def run(self, Ham, nelec=None, dm0=None, **kwargs):
        from jax.scipy.linalg import expm as jexpm
        import scipy.linalg as sla
        from libdmet_preview_tpu.ops.fit import minimize as fit_minimize
        from libdmet_preview_tpu.solvers.scf import _veff_uhf
        if nelec is None:
            raise ValueError("UCASSCF.run requires nelec")
        n = Ham.norb
        ncas = self.ncas
        cas = UCASCI(ncas, self.nelecas, Sz=self.Sz,
                     fcisolver=self.fcisolver)
        _, E = cas.run(Ham, nelec=nelec, dm0=dm0, **kwargs)
        na = (nelec + self.Sz) // 2
        nb = nelec - na
        nca, ncb = na - cas.na_cas, nb - cas.nb_cas
        Aa, Ab, dmca, dmcb, _, _, _ = cas._cas
        h1a, h1b, g_aa, g_bb, g_ab = UCASCI._unpack(Ham)

        def full_C(C_core, C_act):
            C0 = np.hstack([C_core, C_act])
            w, v = np.linalg.eigh(np.eye(n) - C0 @ C0.T)
            nvirt = n - C0.shape[1]
            C_virt = v[:, -nvirt:] if nvirt > 0 else np.zeros((n, 0))
            return np.hstack([C0, C_virt])

        C_full = [full_C(self._core_cols(dmca, nca), Aa),
                  full_C(self._core_cols(dmcb, ncb), Ab)]
        ncs = (nca, ncb)

        def rot_pairs(nc):
            pairs = [(i, j) for i in range(nc)
                     for j in range(nc, nc + ncas)]
            pairs += [(i, j) for i in range(nc)
                      for j in range(nc + ncas, n)]
            pairs += [(i, j) for i in range(nc, nc + ncas)
                      for j in range(nc + ncas, n)]
            rows = np.array([p[0] for p in pairs], dtype=int)
            cols = np.array([p[1] for p in pairs], dtype=int)
            return rows, cols

        rows_a, cols_a = rot_pairs(nca)
        rows_b, cols_b = rot_pairs(ncb)
        npa, npb = len(rows_a), len(rows_b)
        npar = npa + npb

        jh1a, jh1b = jnp.asarray(h1a), jnp.asarray(h1b)
        jgaa, jgbb, jgab = (jnp.asarray(g_aa), jnp.asarray(g_bb),
                            jnp.asarray(g_ab))
        H0 = float(Ham.H0)

        def mo_rdms():
            """Full-space spin-resolved (Da, Db, Gaa, Gbb, Gab) in the
            CURRENT per-spin MO bases (core | act | virt); same CAS
            decomposition as UCASCI.make_rdm2 in the MO frame."""
            Gaa_c, Gbb_c, Gab_c = [np.asarray(x) for x in
                                   cas.fcisolver.make_rdm2(cas._cas[4])]
            da = np.asarray(cas._cas[5])
            db = np.asarray(cas._cas[6])
            out_D, out_G = [], []
            for (nc, d_act, G_act) in ((nca, da, Gaa_c),
                                       (ncb, db, Gbb_c)):
                D = np.zeros((n, n))
                D[:nc, :nc] = np.eye(nc)
                a = slice(nc, nc + ncas)
                D[a, a] = d_act
                Dc = np.zeros((n, n))
                Dc[:nc, :nc] = np.eye(nc)
                Da_ = np.zeros((n, n))
                Da_[a, a] = d_act
                G = np.zeros((n, n, n, n))
                G[a, a, a, a] = G_act
                G += (np.einsum("pq, rs -> pqrs", Dc, Dc)
                      - np.einsum("ps, rq -> pqrs", Dc, Dc))
                G += (np.einsum("pq, rs -> pqrs", Dc, Da_)
                      + np.einsum("pq, rs -> pqrs", Da_, Dc)
                      - np.einsum("ps, rq -> pqrs", Dc, Da_)
                      - np.einsum("ps, rq -> pqrs", Da_, Dc))
                out_D.append(D)
                out_G.append(G)
            # opposite-spin block: no exchange across species
            aA = slice(nca, nca + ncas)
            aB = slice(ncb, ncb + ncas)
            DcA = np.zeros((n, n)); DcA[:nca, :nca] = np.eye(nca)
            DcB = np.zeros((n, n)); DcB[:ncb, :ncb] = np.eye(ncb)
            DaA = np.zeros((n, n)); DaA[aA, aA] = da
            DaB = np.zeros((n, n)); DaB[aB, aB] = db
            Gab = np.zeros((n, n, n, n))
            Gab[aA, aA, aB, aB] = Gab_c
            Gab += (np.einsum("pq, rs -> pqrs", DcA, DcB)
                    + np.einsum("pq, rs -> pqrs", DcA, DaB)
                    + np.einsum("pq, rs -> pqrs", DaA, DcB))
            return (jnp.asarray(out_D[0]), jnp.asarray(out_D[1]),
                    jnp.asarray(out_G[0]), jnp.asarray(out_G[1]),
                    jnp.asarray(Gab))

        @jax.jit
        def e_kappa(p, Cja, Cjb, Da, Db, Gaa, Gbb, Gab):
            Ka = jnp.zeros((n, n)).at[rows_a, cols_a].set(p[:npa])
            Kb = jnp.zeros((n, n)).at[rows_b, cols_b].set(p[npa:])
            Ca = Cja @ jexpm(Ka - Ka.T)
            Cb = Cjb @ jexpm(Kb - Kb.T)
            h_a = Ca.T @ jh1a @ Ca
            h_b = Cb.T @ jh1b @ Cb
            gaa = jnp.einsum("pqrs, pi, qj, rk, sl -> ijkl", jgaa,
                             Ca, Ca, Ca, Ca, optimize=True)
            gbb = jnp.einsum("pqrs, pi, qj, rk, sl -> ijkl", jgbb,
                             Cb, Cb, Cb, Cb, optimize=True)
            gab = jnp.einsum("pqrs, pi, qj, rk, sl -> ijkl", jgab,
                             Ca, Ca, Cb, Cb, optimize=True)
            return (jnp.einsum("pq, qp ->", h_a, Da)
                    + jnp.einsum("pq, qp ->", h_b, Db)
                    + 0.5 * jnp.einsum("pqrs, pqrs ->", gaa, Gaa)
                    + 0.5 * jnp.einsum("pqrs, pqrs ->", gbb, Gbb)
                    + jnp.einsum("pqrs, pqrs ->", gab, Gab) + H0)

        grad_fn = jax.jit(jax.grad(e_kappa))

        self.converged = False
        for macro in range(self.max_cycle):
            Da, Db, Gaa, Gbb, Gab = mo_rdms()
            Cja = jnp.asarray(C_full[0])
            Cjb = jnp.asarray(C_full[1])
            g0 = np.asarray(grad_fn(jnp.zeros(npar), Cja, Cjb, Da, Db,
                                    Gaa, Gbb, Gab))
            if npar == 0 or np.max(np.abs(g0)) < self.tol * 10:
                self.converged = True
                break

            def fun_grad(p):
                pj = jnp.asarray(p)
                return (float(e_kappa(pj, Cja, Cjb, Da, Db, Gaa, Gbb,
                                      Gab)),
                        np.asarray(grad_fn(pj, Cja, Cjb, Da, Db, Gaa,
                                           Gbb, Gab)))

            def hvp(x, pvec):
                return np.asarray(jax.jvp(
                    lambda q: grad_fn(q, Cja, Cjb, Da, Db, Gaa, Gbb,
                                      Gab),
                    (jnp.asarray(x),), (jnp.asarray(pvec),))[1])

            p_opt, _ = fit_minimize(fun_grad, np.zeros(npar),
                                    method="NEWTON", max_iter=30,
                                    hvp=hvp, gtol=self.tol,
                                    trust_radius=0.4)
            Ka = np.zeros((n, n)); Ka[rows_a, cols_a] = p_opt[:npa]
            Kb = np.zeros((n, n)); Kb[rows_b, cols_b] = p_opt[npa:]
            C_full[0] = C_full[0] @ sla.expm(Ka - Ka.T)
            C_full[1] = C_full[1] @ sla.expm(Kb - Kb.T)
            # re-solve the active problem in the rotated orbitals
            Cca = C_full[0][:, :nca]
            Ccb = C_full[1][:, :ncb]
            Aa = C_full[0][:, nca:nca + ncas]
            Ab = C_full[1][:, ncb:ncb + ncas]
            dmca, dmcb = Cca @ Cca.T, Ccb @ Ccb.T
            va, vb = [np.asarray(x) for x in _veff_uhf(
                jnp.asarray(dmca), jnp.asarray(dmcb), jgaa, jgbb,
                jgab)]
            e_core = (np.sum((h1a + 0.5 * va) * dmca)
                      + np.sum((h1b + 0.5 * vb) * dmcb) + H0)
            jAa, jAb = jnp.asarray(Aa), jnp.asarray(Ab)
            g_cas_aa = np.asarray(jnp.einsum(
                "pqrs, pi, qj, rk, sl -> ijkl", jgaa, jAa, jAa, jAa,
                jAa, optimize=True))
            g_cas_bb = np.asarray(jnp.einsum(
                "pqrs, pi, qj, rk, sl -> ijkl", jgbb, jAb, jAb, jAb,
                jAb, optimize=True))
            g_cas_ab = np.asarray(jnp.einsum(
                "pqrs, pi, qj, rk, sl -> ijkl", jgab, jAa, jAa, jAb,
                jAb, optimize=True))
            Ham_cas = Integral(
                ncas, False, False, e_core,
                {"cd": np.array([Aa.T @ (h1a + va) @ Aa,
                                 Ab.T @ (h1b + vb) @ Ab])},
                {"ccdd": np.array([g_cas_aa, g_cas_bb, g_cas_ab])})
            rdm_cas, E = cas.fcisolver.run(
                Ham_cas, nelec=cas.na_cas + cas.nb_cas)
            cas._cas = (Aa, Ab, dmca, dmcb, Ham_cas,
                        np.asarray(rdm_cas[0]), np.asarray(rdm_cas[1]))
            cas.onepdm = np.asarray(
                [Aa @ np.asarray(rdm_cas[0]) @ Aa.T + dmca,
                 Ab @ np.asarray(rdm_cas[1]) @ Ab.T + dmcb])

        cas.e_tot = float(E)
        self._ucas = cas
        self._cas = cas._cas
        self.onepdm = np.asarray(cas.onepdm)
        self.e_tot = float(E)
        self.mo_coeff = np.asarray(C_full)
        self.fcisolver = cas.fcisolver
        return self.onepdm, self.e_tot

    def make_rdm2(self, Ham=None):
        self.twopdm = self._ucas.make_rdm2(Ham)
        return self.twopdm

    def run_dmet_ham(self, Ham, **kwargs):
        return self._ucas.run_dmet_ham(Ham, **kwargs)

    def cleanup(self):
        pass
