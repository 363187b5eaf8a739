"""
Ab initio DMET on DIAMOND with GTH pseudopotentials -- the north-star
solid workload (BASELINE.json), entirely through the native integral
engine: GTH-SZV sp valence basis + GTH-PADE pseudopotentials
(McMurchie-Davidson general-l integrals, Ewald-split periodic Coulomb,
AFT ERIs; no PySCF anywhere).

Builds the fcc 2-atom primitive cell on a BvK torus, runs supercell RHF,
Lowdin-localizes, and performs one interacting-bath DMET iteration with
a CCSD impurity solver.  The HF-solver identity (DMET(HF) == lattice HF)
validates the full embedding chain at ~1e-8.

Runtime: ~90 s (one-time integral generation on the host).
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import time

import numpy as np
import libdmet_preview_tpu  # noqa: F401
import libdmet_preview_tpu.dmet.hubbard as dmet
from libdmet_preview_tpu.models.abinitio import make_diamond_lattice
from libdmet_preview_tpu.ops import embham
from libdmet_preview_tpu.ops.vcor import VcorLocal
from libdmet_preview_tpu.solvers import CCSD, SCFSolver

t0 = time.time()
Lat, meta = make_diamond_lattice(nk=2)
nsc = Lat.nscsites
print("diamond (C2, GTH-SZV/GTH-PADE) x %d cells: nao=%d  built in %.0fs"
      % (Lat.ncells, meta["cell"].nao, time.time() - t0))
print("supercell RHF:  E/cell = %.8f" % (meta["E_hf"] / Lat.ncells))

vcor = VcorLocal(True, False, nsc)
vcor.assign(np.zeros((2, nsc, nsc)))
rho, Mu, res = dmet.RHartreeFock(Lat, vcor, 0.5, None, ires=True)
print("lattice mean field: E/cell = %.8f  gap = %.3f" % (res["E"],
                                                         res["gap"]))

ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                          int_bath=True)
basis_k = Lat.R2k_basis(basis)
rho_mf = np.asarray(embham.foldRho_k(Lat.rdm1_lo_k, basis_k))
nel = int(round(np.trace(rho_mf[0])))
nel += nel % 2

hf = SCFSolver(restricted=True)
rhoEmb, EEmb = hf.run(ImpHam, nelec=nel)
_, E_hf, _ = dmet.transformResults(rhoEmb, EEmb, basis, ImpHam, H1e,
                                   lattice=Lat, last_dmu=0.0,
                                   int_bath=True, solver=hf,
                                   solver_args={"nelec": nel})
print("DMET(HF)/cell   = %.8f   (identity check: %.2e)"
      % (E_hf * nsc, E_hf * nsc - meta["E_hf"] / Lat.ncells))

cc = CCSD(restricted=True, tol=1e-8)
rhoEmb, EEmb = cc.run(ImpHam, nelec=nel)
_, E_cc, n_cc = dmet.transformResults(rhoEmb, EEmb, basis, ImpHam, H1e,
                                      lattice=Lat, last_dmu=0.0,
                                      int_bath=True, solver=cc,
                                      solver_args={"nelec": nel})
print("DMET(CCSD)/cell = %.8f   E_corr/cell = %.6f  nelec = %.4f"
      % (E_cc * nsc, E_cc * nsc - meta["E_hf"] / Lat.ncells, n_cc * nsc))
print("total %.0fs" % (time.time() - t0))
