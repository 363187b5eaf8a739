#!/usr/bin/env python
"""
One-shot DMET on the 3-band Emery (cuprate) model with literature
parameters (reference analog: the Hubbard3band workflows).  UHF mean
field, CuO2-cell Schmidt bath, FCI impurity with a chemical-potential
fit; prints the charge-transfer hole distribution.

Run: python examples/05_threeband_cuprate.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import numpy as np
import libdmet_preview_tpu.dmet.hubbard as dmet
from libdmet_preview_tpu.models.lattice import Square3Band
from libdmet_preview_tpu.models.hamiltonian import Hubbard3band_ref
from libdmet_preview_tpu.solvers import FCI

Lat = Square3Band(2, 2, 1, 1)
Ham = Hubbard3band_ref(Lat, name="Hanke")
Lat.set_Ham(Ham, use_hcore_as_emb_ham=True)
nlo = Lat.nscsites
vcor = dmet.VcorLocal(False, False, nlo)
vcor.update(np.zeros(vcor.length()))
filling = 5.0 / 6.0            # one hole per CuO2

rho, Mu = dmet.HartreeFock(Lat, vcor, filling, None)
ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                          int_bath=False)
solver = FCI(restricted=False, tol=1e-11)
mu_solver = dmet.MuSolver(adaptive=True)
solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
last_dmu = 0.0
for it in range(25):
    rhoEmb, E_emb, ImpHam, dmu = mu_solver(Lat, filling, ImpHam, basis,
                                           solver, solver_args, step=0.3)
    last_dmu += dmu
    rhoImp, EnergyImp, nelecImp = dmet.transformResults(
        rhoEmb, E_emb, basis, ImpHam, H1e, lattice=Lat,
        last_dmu=last_dmu, int_bath=False, solver=solver,
        solver_args=solver_args)
    if abs(nelecImp - 2 * filling) < 5e-7:
        break

occ = np.sum(np.asarray(rhoImp), axis=0).diagonal()
hole = 2.0 - occ
print("nelec per CuO2       : %.6f  (target %.6f)"
      % (nelecImp * nlo, 2 * filling * nlo))
print("DMET energy per site : %.8f" % EnergyImp)
print("hole distribution    : d %.4f  px %.4f  py %.4f"
      % (hole[0], hole[1], hole[2]))
