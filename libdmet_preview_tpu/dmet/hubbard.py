"""
DMET user-facing API for Hubbard-family lattice models
(JAX rewrite of reference dmet/Hubbard.py + dmet/HubPhSymm.py).

Carries the same vocabulary as the reference so that driver loops translate
one-to-one:  HartreeFock / RHartreeFock, ConstructImpHam, apply_dmu,
SolveImpHam_with_fitting (MuSolver), transformResults, FitVcor, AFInitGuess /
PMInitGuess, addDiag, IterHistory, foldRho_k.
"""

import os
import pickle
from math import copysign

import numpy as np
import jax.numpy as jnp

from libdmet_preview_tpu.utils import logger as log
from libdmet_preview_tpu.utils.misc import Iterable
from libdmet_preview_tpu.models.lattice import (
    ChainLattice, SquareLattice, SquareAFM, Square3Band, Square3BandAFM,
    Square3BandSymm, CubicLattice, HoneycombLattice, BipartiteSquare)
from libdmet_preview_tpu.models.hamiltonian import (
    HubbardHamiltonian as Ham, Hubbard3band, Hubbard3band_ref)
from libdmet_preview_tpu.models.integral import Integral
from libdmet_preview_tpu.ops import mfd, embham, fit as fit_mod
from libdmet_preview_tpu.ops.vcor import (VcorLocal, VcorLocalPhSymm,
                                          VcorDCAPhSymm,
                                          VcorSymm, VcorSymmBogo,
                                          VcorNonLocal, VcorKpoints,
                                          VcorRestricted)
from libdmet_preview_tpu.ops.diis import DIIS, FDiisContext
from libdmet_preview_tpu.ops.fit import (addDiag, make_vcor_trace_unchanged,
                                         vcor_diag_average)
from libdmet_preview_tpu.dmet.quad_fit import quad_fit_mu
from libdmet_preview_tpu import solvers as impurity_solver

foldRho_k = embham.foldRho_k
HF = mfd.HF


# ----------------------------------------------------------------------
# mean field wrappers (reference Hubbard.py:14-41)
# ----------------------------------------------------------------------

def HartreeFock(Lat, v, filling, mu0=None, beta=np.inf, ires=False, **kwargs):
    restricted = v.restricted
    rho, mu, E, res = mfd.HF(Lat, v, filling, restricted, mu0=mu0, beta=beta,
                             ires=True, **kwargs)
    log.result("Chemical potential (mean-field) = %s", mu)
    log.result("Energy per cell (mean-field) = %20.12f", E)
    log.result("Gap (mean-field) = %s", res["gap"])
    if ires:
        return rho, mu, res
    return rho, mu


def RHartreeFock(Lat, v, filling, mu0=None, beta=np.inf, ires=False, **kwargs):
    log.eassert(v.restricted, "RHF requires restricted vcor")
    return HartreeFock(Lat, v, filling, mu0=mu0, beta=beta, ires=ires, **kwargs)


# ----------------------------------------------------------------------
# impurity Hamiltonian (reference HubPhSymm.py:74-100)
# ----------------------------------------------------------------------

def ConstructImpHam(Lat, rho, v, mu=None, matching=True, local=True,
                    int_bath=False, **kwargs):
    log.result("Making embedding basis")
    basis = embham.embBasis(Lat, rho, local=local, **kwargs)
    if matching and basis.shape[0] == 2:
        log.result("Rotating bath to match alpha/beta")
        nimp = Lat.nimp
        basis[:, :, :, nimp:] = _match_bath(basis[:, :, :, nimp:])
    log.result("Constructing impurity Hamiltonian")
    ImpHam, H1e = embham.embHam(Lat, basis, v, local=local, int_bath=int_bath,
                                **kwargs)
    return ImpHam, H1e, basis


def _match_bath(basis_bath):
    shape = basis_bath.shape
    flat = basis_bath.reshape(2, -1, shape[-1])
    return embham.basis_matching(flat).reshape(shape)


def apply_dmu(lattice, ImpHam, basis, dmu, **kwargs):
    """Add -dmu on the impurity orbitals of H1_emb
    (reference Hubbard.py:82-102)."""
    dmu_idx = kwargs.get("dmu_idx", None)
    if dmu_idx is None:
        dmu_idx = lattice.imp_idx
    nao = lattice.nao
    mu_mat = np.zeros((nao, nao))
    mu_mat[dmu_idx, dmu_idx] = -dmu
    spin = 1 if ImpHam.restricted else 2
    for s in range(spin):
        ImpHam.H1["cd"][s] += np.asarray(
            embham.transform_imp(jnp.asarray(basis[s]), jnp.asarray(mu_mat)))
    return ImpHam


def SolveImpHam_with_dmu(lattice, ImpHam, basis, dmu, solver, solver_args={},
                         **kwargs):
    ImpHam = apply_dmu(lattice, ImpHam, basis, dmu, **kwargs)
    result = solver.run(ImpHam, **solver_args)
    ImpHam = apply_dmu(lattice, ImpHam, basis, -dmu, **kwargs)
    return result


# ----------------------------------------------------------------------
# results transform + energy (reference Hubbard.py:43-80,
# slater.py:1716-1840)
# ----------------------------------------------------------------------

def get_H1_scaled(H1, imp_idx, env_idx=None):
    """Democratic partitioning of H1 (reference slater.py:1717-1733)."""
    H1 = np.array(H1, copy=True)
    nbasis = H1.shape[-1]
    if env_idx is None:
        env_idx = np.asarray([i for i in range(nbasis) if i not in imp_idx],
                             dtype=int)
    imp_env = np.ix_(imp_idx, env_idx)
    env_imp = np.ix_(env_idx, imp_idx)
    env_env = np.ix_(env_idx, env_idx)
    for s in range(H1.shape[0]):
        H1[s][imp_env] *= 0.5
        H1[s][env_imp] *= 0.5
        H1[s][env_env] = 0.0
    return H1


def get_H2_scaled(H2, imp_idx, env_idx=None):
    """Democratic partitioning of a 1-fold H2 (reference slater.py:1735-1778,
    5-dim branch): each index contributes 1/4 weight when on the impurity."""
    H2 = np.array(H2, copy=True)
    nbasis = H2.shape[-1]
    if env_idx is None:
        env_idx = np.asarray([i for i in range(nbasis) if i not in imp_idx],
                             dtype=int)
    w = np.zeros(nbasis)
    w[np.asarray(imp_idx, dtype=int)] = 1.0
    factor = 0.25 * (w[:, None, None, None] + w[None, :, None, None]
                     + w[None, None, :, None] + w[None, None, None, :])
    for s in range(H2.shape[0]):
        H2[s] *= factor
    return H2


def transformResults(rhoEmb, E, basis, ImpHam, H1e=None, int_bath=False,
                     **kwargs):
    """rhoEmb -> (rhoImp, E_per_cell, nelec_per_cell)
    (reference Hubbard.py:43-71 + slater.py:1780-1840)."""
    spin = rhoEmb.shape[0]
    nscsites = basis.shape[2]
    nbasis = basis.shape[-1]

    if "lattice" in kwargs and kwargs["lattice"] is not None:
        imp_idx = np.asarray(kwargs.get("imp_idx",
                                        range(kwargs["lattice"].nimp)))
    else:
        imp_idx = np.asarray(kwargs.get("imp_idx", np.arange(nscsites)))
    nelec = 0.0
    for s in range(spin):
        nelec += np.sum(rhoEmb[s, imp_idx, imp_idx])
    nelec *= 2.0 / spin
    rhoImp = rhoEmb[np.ix_(range(spin), imp_idx, imp_idx)]

    if E is None:
        return nelec / nscsites

    lattice = kwargs["lattice"]
    last_dmu = kwargs["last_dmu"]
    dmu_idx = kwargs.get("dmu_idx", None)
    if dmu_idx is None:
        dmu_idx = list(range(nscsites))
    env_idx = np.asarray([i for i in range(nbasis) if i not in imp_idx],
                         dtype=int)

    E2 = E - np.einsum("spq, sqp", ImpHam.H1["cd"], rhoEmb) * (2.0 / spin) \
        - ImpHam.H0

    H1_scaled = np.array(ImpHam.H1["cd"], copy=True)
    dmu_mat = np.zeros((nscsites, nscsites))
    dmu_mat[dmu_idx, dmu_idx] = -last_dmu
    for s in range(spin):
        H1_scaled[s] -= np.asarray(embham.transform_imp(
            jnp.asarray(basis[s]), jnp.asarray(dmu_mat)))
        if lattice.JK_core is not None:
            H1_scaled[s] -= 0.5 * lattice.JK_core[s]
    H1_scaled = get_H1_scaled(H1_scaled, imp_idx, env_idx)

    E1 = np.einsum("spq, sqp", H1_scaled, rhoEmb) * (2.0 / spin)
    Efrag = E1 + E2 + lattice.getH0()

    if int_bath:
        solver = kwargs.get("solver", None)
        solver_args = kwargs.get("solver_args", {})
        kwargs.setdefault("rdm1_emb", rhoEmb)  # reference Hubbard.py:63-64
        Efrag = get_E_dmet(basis, lattice, ImpHam, last_dmu, solver,
                           solver_args=solver_args,
                           imp_idx=list(imp_idx), **{
                               k: v for k, v in kwargs.items()
                               if k in ("add_vcor_to_E", "vcor", "E1",
                                        "rdm1_emb", "veff")})
    log.debug(0, "E0 = %20.12f, E1 = %20.12f, E2 = %20.12f, E = %20.12f",
              lattice.getH0(), E1, E2, Efrag)
    return rhoImp, Efrag / nscsites, nelec / nscsites


def get_H_dmet(basis, lattice, ImpHam, last_dmu, imp_idx=None,
               add_vcor_to_E=False, vcor=None, E1=None, rdm1_emb=None,
               veff=None, **kwargs):
    """Scaled (democratic-partitioning) DMET Hamiltonian for the
    interacting-bath energy functional (reference slater.py:1957-2032).

    E1: optional externally evaluated one-body energy (hcore + J/K from
    the GLOBAL density matrix, the reference's E1-from-glob variant,
    slater.py:2015-2018): the scaled H1 then only removes the locally
    double-counted veff of rdm1_emb and H0 absorbs E1.

    veff: optional lattice veff in the LO basis (stripe (spin, R, n, n)
    or spin-batched R-matrix), typically rebuilt from the correlated
    GLOBAL density matrix (charge self-consistency, reference
    slater.py:1989-1997 / test_csc.py): the core JK term then becomes
    transform_h1(veff) minus the locally double-counted veff of
    rdm1_emb, instead of the mean-field lattice.JK_core."""
    spin = basis.shape[0]
    nbasis = basis.shape[-1]
    if imp_idx is None:
        imp_idx = list(range(lattice.nimp))
    imp_idx = np.asarray(imp_idx)
    env_idx = np.asarray([i for i in range(nbasis) if i not in imp_idx],
                         dtype=int)
    basis_k = lattice.R2k_basis(basis)
    if E1 is not None:
        log.eassert(rdm1_emb is not None, "E1-from-glob needs rdm1_emb")
        veff_loc = np.asarray(embham.get_veff(
            np.asarray(rdm1_emb), jnp.asarray(ImpHam.H2["ccdd"])))
        H1_scaled = get_H1_scaled(-veff_loc / spin, imp_idx, env_idx)
        H2 = np.asarray(ImpHam.H2["ccdd"])
        H2_scaled = get_H2_scaled(H2, imp_idx, env_idx)
        return Integral(nbasis, spin == 1, False,
                        float(np.real(E1)) + lattice.getH0(),
                        {"cd": H1_scaled}, {"ccdd": H2_scaled})
    hcore_k = lattice.getH1(kspace=True)
    H1_scaled = np.array(embham.transform_h1(hcore_k, basis_k))
    if veff is not None:
        # charge self-consistency: JK_core from the provided lattice
        # veff (built from the correlated global rdm1) minus the local
        # double counting (reference slater.py:1989-1997)
        veff = np.asarray(veff)
        if veff.ndim == 3:
            veff = veff[None]
        veff_k = lattice._pairify(lattice.R2k(veff))
        JK_core = np.array(embham.transform_h1(veff_k, basis_k))
        JK_core -= np.asarray(embham.get_veff(
            np.asarray(rdm1_emb) * (2.0 / spin),
            jnp.asarray(ImpHam.H2["ccdd"])))
        for s in range(spin):
            H1_scaled[s] += 0.5 * JK_core[s]
    elif lattice.JK_core is not None:
        for s in range(spin):
            H1_scaled[s] += 0.5 * lattice.JK_core[s]
    if add_vcor_to_E:
        vmat = vcor.get()
        for s in range(spin):
            H1_scaled[s] += 0.5 * np.asarray(embham.transform_local(
                jnp.asarray(basis[s]), jnp.asarray(vmat[s])))
            H1_scaled[s] -= 0.5 * np.asarray(embham.transform_imp(
                jnp.asarray(basis[s]), jnp.asarray(vmat[s])))
    H1_scaled = get_H1_scaled(H1_scaled, imp_idx, env_idx)
    H2 = np.asarray(ImpHam.H2["ccdd"])
    H2_scaled = get_H2_scaled(H2, imp_idx, env_idx)
    return Integral(nbasis, spin == 1, False, lattice.getH0(),
                    {"cd": H1_scaled}, {"ccdd": H2_scaled})


def get_E_dmet(basis, lattice, ImpHam, last_dmu, solver, solver_args={},
               **kwargs):
    ImpHam_scaled = get_H_dmet(basis, lattice, ImpHam, last_dmu, **kwargs)
    return solver.run_dmet_ham(ImpHam_scaled, **solver_args)


# ----------------------------------------------------------------------
# chemical-potential fitting (reference Hubbard.py:117-480)
# ----------------------------------------------------------------------

class MuSolver(object):
    """Adaptive chemical-potential fitter over (possibly multiple)
    impurity problems."""

    def __init__(self, adaptive=True):
        self.adaptive = adaptive
        self.history = []

    def __call__(self, lattice, filling, ImpHam, basis, solver,
                 solver_args={}, delta=0.02, thrnelec=1e-5, step=0.05,
                 **kwargs):
        filling = np.average(filling)
        single_imp = not isinstance(lattice, (list, tuple))
        if single_imp:
            lattice = [lattice]
            ImpHam = [ImpHam]
            basis = [basis]
            solver = [solver]
            solver_args = [solver_args]
        imp_idx = kwargs.pop("imp_idx", None)
        if imp_idx is None:
            imp_idx = [np.arange(l.nimp) for l in lattice]

        def solve(mu):
            rho_col, E_col = [], []
            ntot = 0.0
            for latt, H, B, sol, sargs, iidx in zip(lattice, ImpHam, basis,
                                                    solver, solver_args,
                                                    imp_idx):
                rho_i, E_i = SolveImpHam_with_dmu(latt, H, B, mu, sol, sargs,
                                                  **kwargs)
                rho_col.append(rho_i)
                E_col.append(E_i)
                ntot += transformResults(rho_i, None, B, None, None,
                                         lattice=latt, imp_idx=iidx)
            return rho_col, E_col, ntot

        def apply_all(dmu):
            return [apply_dmu(l, H, B, dmu, **kwargs)
                    for l, H, B in zip(lattice, ImpHam, basis)]

        target = filling * 2.0
        rho0, E0, n0 = solve(0.0)
        record = [(0.0, n0)]
        log.result("nelec = %20.12f (target %20.12f)", n0, target)

        if abs(n0 / target - 1.0) < thrnelec:
            self.history.append(record)
            res = [rho0, E0, ImpHam, 0.0]
        else:
            if self.adaptive:
                pred = self.predict(n0, target)
                if pred is not None:
                    delta = copysign(min(abs(pred), step), pred)
                else:
                    delta = abs(delta) * (-1 if n0 > target else 1)
            else:
                delta = abs(delta) * (-1 if n0 > target else 1)

            rho1, E1, n1 = solve(delta)
            record.append((delta, n1))
            log.result("nelec = %20.12f (target %20.12f)", n1, target)
            if abs(n1 / target - 1.0) < thrnelec:
                ImpHam = apply_all(delta)
                self.history.append(record)
                res = [rho1, E1, ImpHam, delta]
            else:
                nprime = (n1 - n0) / delta
                delta1 = (target - n0) / nprime
                if abs(delta1) > step:
                    delta1 = copysign(step, delta1)
                rho2, E2, n2 = solve(delta1)
                record.append((delta1, n2))
                log.result("nelec = %20.12f (target %20.12f)", n2, target)
                if abs(n2 / target - 1.0) < thrnelec:
                    ImpHam = apply_all(delta1)
                    self.history.append(record)
                    res = [rho2, E2, ImpHam, delta1]
                else:
                    mus = [0.0, delta, delta1]
                    ns = [n0, n1, n2]
                    res = None
                    for _ in range(2):
                        dnext = quad_fit_mu(np.asarray(mus), np.asarray(ns),
                                            filling, step)
                        rho3, E3, n3 = solve(dnext)
                        record.append((dnext, n3))
                        log.result("nelec = %20.12f (target %20.12f)",
                                   n3, target)
                        mus.append(dnext)
                        ns.append(n3)
                        if abs(n3 / target - 1.0) < thrnelec:
                            break
                    ImpHam = apply_all(dnext)
                    self.history.append(record)
                    res = [rho3, E3, ImpHam, dnext]

        if single_imp:
            res[0] = res[0][0]
            res[1] = res[1][0]
            res[2] = res[2][0]
        return res

    def predict(self, nelec, target):
        """Weighted secant prediction from fit history
        (reference Hubbard.py:323-478, simplified to the 2-point rule which
        dominates in practice)."""
        from math import exp
        vals, weights = [], []
        damp = np.e
        sigma2 = 0.00025
        for i, record in enumerate(self.history):
            if len(record) < 2:
                continue
            weight = damp ** (i + 1 - len(self.history))
            (mu1, n1), (mu2, n2) = record[0], record[1]
            if abs(mu2 - mu1) < 1e-12 or abs(n2 - n1) < 1e-12:
                continue
            slope = (n2 - n1) / (mu2 - mu1)
            val = (target - nelec) / slope
            metric = min((target - n1) ** 2 + (nelec - n2) ** 2,
                         (target - n2) ** 2 + (nelec - n1) ** 2)
            weight *= exp(-0.5 * metric / sigma2)
            vals.append(val)
            weights.append(weight)
        if np.sum(weights) > 1e-3:
            dmu = np.dot(vals, weights) / np.sum(weights)
            if abs(dmu) > 0.5:
                dmu = copysign(0.5, dmu)
            return dmu
        return None

    def save(self, filename):
        with open(filename, "wb") as f:
            pickle.dump(self.history, f)

    def load(self, filename):
        if os.path.exists(filename):
            with open(filename, "rb") as f:
                self.history = pickle.load(f)


SolveImpHam_with_fitting = MuSolver(adaptive=True)


# ----------------------------------------------------------------------
# vcor factories + init guesses (reference Hubbard.py:482-549)
# ----------------------------------------------------------------------

def AFInitGuess(ImpSize, U, Filling, polar=None, bogoliubov=False, rand=0.0,
                subA=None, subB=None, trace_zero=False, d_wave=False,
                bogo_res=False):
    if subA is None and subB is None:
        subA, subB = BipartiteSquare(ImpSize)
    nscsites = len(subA) + len(subB)
    shift = U * Filling
    if polar is None:
        polar = shift * Filling
    init_v = np.eye(nscsites) * shift
    if trace_zero:
        init_v[:] = 0.0
    init_p = np.zeros_like(init_v)
    for i in range(nscsites):
        if i in subA:
            init_p[i, i] = polar
        elif i in subB:
            init_p[i, i] = -polar
    v = VcorLocal(False, bogoliubov, nscsites, bogo_res=bogo_res)
    if bogoliubov:
        rng = np.random.RandomState(32499823)
        init_d = (rng.rand(nscsites, nscsites) - 0.5) * rand
        v.assign(np.asarray([init_v + init_p, init_v - init_p, init_d]))
    else:
        v.assign(np.asarray([init_v + init_p, init_v - init_p]))
    return v


def PMInitGuess(ImpSize, U, Filling, bogoliubov=False, rand=0.0):
    nscsites = int(np.prod(ImpSize))
    shift = U * Filling
    init_v = np.eye(nscsites) * shift
    v = VcorLocal(True, bogoliubov, nscsites)
    if bogoliubov:
        init_d = np.zeros((nscsites, nscsites))
        v.assign(np.asarray([init_v, init_v, init_d]))
    else:
        v.assign(np.asarray([init_v, init_v]))
    if rand > 0.0:
        rng = np.random.RandomState(32499823)
        v.update(v.param + (rng.rand(v.length()) - 0.5) * rand)
    return v


# ----------------------------------------------------------------------
# vcor fit wrapper (reference Hubbard.py:1503)
# ----------------------------------------------------------------------

def FitVcor(rho, lattice, basis, vcor, beta, filling=0.5, MaxIter1=300,
            MaxIter2=0, **kwargs):
    return fit_mod.FitVcorTwoStep(rho, lattice, basis, vcor, beta, filling,
                                  MaxIter1=MaxIter1, MaxIter2=MaxIter2,
                                  **kwargs)


# ----------------------------------------------------------------------
# bookkeeping (reference HubPhSymm.py:302-325)
# ----------------------------------------------------------------------

class IterHistory(object):
    def __init__(self):
        self.history = []

    def update(self, energy, err, nelec, dvcor, dc):
        if not self.history:
            self.history.append([energy, energy, err, nelec, dvcor,
                                 dc.nDim, dc.iNext])
        else:
            self.history.append([energy, energy - self.history[-1][0], err,
                                 nelec, dvcor, dc.nDim, dc.iNext])
        log.section("\nDMET Progress\n")
        log.result("  Iter         Energy                 dE"
                   "                RdmErr               Nelec"
                   "                 dVcor      DIIS")
        for idx, item in enumerate(self.history):
            log.result(" %3d %20.12f %15.3e %20.12f %20.12f %20.5e %2d %2d",
                       idx, *item)

    def write_table(self, filename="./table.txt"):
        with open(filename, "w") as f:
            f.write("  Iter  Energy  dE  RdmErr  Nelec  dVcor  DIIS\n")
            for idx, item in enumerate(self.history):
                f.write(" %3d %20.12f %15.3e %20.12f %20.12f %20.5e %2d %2d\n"
                        % ((idx,) + tuple(item)))
