"""
Orbital-optimized correlation solvers: OO-MP2 and OO-CCD.

Reference parity: solver/scf_solver.py:19-498 `oomp2`/`ooccd` modes,
which compose gmc1step.GCASSCFBigCAS (internal occ-virt rotations only)
with mp.MP2AsFCISolver (mp.py:147-233) / cc.CCDAsFCISolver.  This
design is a single variational program instead of a two-step macro
iteration: the total correlated energy

    E(kappa) = E_cc( h, g, C e^kappa )

is a pure function of the occ-virt rotation parameters, where the
amplitude solve inside E_cc is the implicit-function `_t_star`
custom-vjp op (solvers/cc.py) -- so `jax.grad` of E(kappa) is the EXACT
fully-relaxed orbital gradient (amplitude response included through the
adjoint/lambda solve), and a quasi-Newton minimization over kappa gives
the orbital-optimized solution directly, no macro restarts.

For OO-MP2 the amplitude residual is truncated to the non-canonical
MP2 (Hylleraas) stationarity condition (cc._residual(mp2=True)), which
keeps the method well-defined under arbitrary occ-virt rotations.

At the stationary point dE/dkappa = 0, so the orbital-response
contribution to the relaxed densities vanishes and the response RDMs at
fixed optimal orbitals (CCSD._energy_rdms) are the fully relaxed OO
densities -- these feed the standard DMET energy functional.

Oracle (tests/test_oo.py): for any TWO-ELECTRON system OO-CCD == FCI
exactly, because by Thouless' theorem the occ-virt rotation absorbs the
missing singles: e^{T1}|HF> = |HF(kappa)>, and CCSD == FCI at 2e.
"""

import numpy as np
import jax
import jax.numpy as jnp

from libdmet_preview_tpu.utils import logger as log
from libdmet_preview_tpu.solvers.cc import CCSD, _e_tot_cc


class OOCCD(CCSD):
    """Orbital-optimized CCD (reference scf_solver.py `ooccd` role).

    run(ImpHam, nelec) -> (rdm1, E) with the standard solver contract;
    restricted=True ties the rotation across spins, otherwise per-spin
    occ-virt rotations (the reference's UHF/GHF OO modes)."""

    freeze_t1 = True
    mp2_residual = False

    def __init__(self, restricted=False, Sz=0, tol=1e-9, max_cycle=200,
                 oo_gtol=1e-6, oo_max_iter=100, **kwargs):
        super(OOCCD, self).__init__(restricted=restricted, Sz=Sz, tol=tol,
                                    max_cycle=max_cycle, **kwargs)
        self.oo_gtol = oo_gtol
        self.oo_max_iter = oo_max_iter
        self.oo_converged = False

    def run(self, Ham, nelec=None, dm0=None, calc_rdm2=False, **kwargs):
        from jax.scipy.linalg import expm as jexpm
        from libdmet_preview_tpu.ops.fit import minimize as fit_minimize
        from libdmet_preview_tpu.solvers.scf import SCF
        if nelec is None:
            raise ValueError("%s.run requires nelec"
                             % self.__class__.__name__)
        n = Ham.norb
        if self.ghf:
            # GSO frame (the reference's GHF-based oomp2/ooccd): one
            # fermion species over all norb spin orbitals -- the beta
            # sector is empty, so the rotation generators below span the
            # full spin-orbital occ-virt space automatically
            na, nb = nelec, 0
            self.scfsolver = SCF()
            self.scfsolver.set_system(nelec, nelec, False, False)
        else:
            na = (nelec + self.Sz) // 2
            nb = nelec - na
            self.scfsolver = SCF()
            self.scfsolver.set_system(nelec, self.Sz, False,
                                      self.restricted)
        self.scfsolver.set_integral(Ham)
        self.scfsolver.HF(tol=min(self.conv_tol, 1e-10), MaxIter=200,
                          InitGuess=dm0)
        mo = self.scfsolver.mo_coeff
        Ca = np.asarray(mo[0])
        Cb = np.asarray(mo[1] if mo.shape[0] == 2 else mo[0])

        h1a, h1b, g_aa, g_bb, g_ab = self._unpack(Ham)
        jh = tuple(jnp.asarray(x) for x in (h1a, h1b, g_aa, g_bb, g_ab))
        jCa, jCb = jnp.asarray(Ca), jnp.asarray(Cb)
        opts = self._opts()

        # occ-virt rotation generators of the reference determinant
        tied = bool(Ham.restricted) and na == nb
        ra = np.repeat(np.arange(na), n - na)
        ca = np.tile(np.arange(na, n), na)
        if tied:
            rb = cb = np.zeros(0, dtype=int)
        else:
            rb = np.repeat(np.arange(nb), n - nb)
            cb = np.tile(np.arange(nb, n), nb)
        npa, npb = len(ra), len(rb)
        npar = npa + npb

        def _rot(p):
            Ka = jnp.zeros((n, n)).at[ra, ca].set(p[:npa])
            Ka = Ka - Ka.T
            Ca_r = jCa @ jexpm(Ka)
            if tied:
                return Ca_r, Ca_r
            Kb = jnp.zeros((n, n)).at[rb, cb].set(p[npa:])
            Kb = Kb - Kb.T
            return Ca_r, jCb @ jexpm(Kb)

        def e_kappa(p):
            Ca_r, Cb_r = _rot(p)
            return _e_tot_cc(*jh, Ca_r, Cb_r, na, nb, opts)

        val_grad = jax.value_and_grad(e_kappa)

        def fun_grad(p):
            v, g = val_grad(jnp.asarray(p))
            return float(v), np.asarray(g)

        if npar:
            p_opt, _ = fit_minimize(fun_grad, np.zeros(npar),
                                    method="BFGS",
                                    max_iter=self.oo_max_iter,
                                    gtol=self.oo_gtol)
            gfin = np.asarray(val_grad(jnp.asarray(p_opt))[1])
            self.oo_converged = bool(np.max(np.abs(gfin)) < 10
                                     * self.oo_gtol)
            if not self.oo_converged:
                log.warn("%s orbital gradient not tight: max|g| = %.3e",
                         self.__class__.__name__, np.max(np.abs(gfin)))
            Ca_o, Cb_o = (np.asarray(c) for c in _rot(jnp.asarray(p_opt)))
        else:
            self.oo_converged = True
            Ca_o, Cb_o = Ca, Cb

        self._mo = (Ca_o, Cb_o, na, nb)
        return self._energy_rdms(Ham, jnp.asarray(Ca_o),
                                 jnp.asarray(Cb_o), na, nb)


class OOMP2(OOCCD):
    """Orbital-optimized MP2 (reference scf_solver.py `oomp2` role):
    the amplitude equation is the non-canonical MP2 stationarity
    condition, orbitals minimized as in OOCCD."""

    energy_fn = staticmethod(_e_tot_cc)
    mp2_residual = True
