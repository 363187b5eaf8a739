#!/usr/bin/env python
"""
Ab initio DMET on a hydrogen ring with the NATIVE Gaussian integral
engine -- no PySCF (reference analog: examples/dmet/02-dmet-hchain.py).
Interacting bath, IAO valence + PAO virtuals (3-21G), CCSD solver.

Run: python examples/03_abinitio_h_ring.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import numpy as np
from libdmet_preview_tpu.models.abinitio import make_h_ring_lattice
import libdmet_preview_tpu.dmet.hubbard as dmet
from libdmet_preview_tpu.solvers.cc import CCSD

Lat, meta = make_h_ring_lattice(ncells=3, atoms_per_cell=2, r_bond=1.8,
                                basis="3-21g", localization="iao",
                                minimal_ref="sto-6g")
nlo, ncells = meta["nlo"], Lat.ncells
print("molecular RHF total energy: %.10f" % meta["E_hf"])

vcor = dmet.VcorLocal(True, False, nlo)
vcor.update(np.zeros(vcor.length()))
filling = meta["mole"].nelectron / (2.0 * meta["mole"].nao)

rho, mu, res = dmet.RHartreeFock(Lat, vcor, filling, None, ires=True)
ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=False,
                                          int_bath=True)
solver = CCSD(restricted=True, tol=1e-9)
nelec_emb = (Lat.ncore + Lat.nval) * 2
rhoEmb, E_emb = solver.run(ImpHam, nelec=nelec_emb)
rhoImp, E, nelec = dmet.transformResults(
    rhoEmb, E_emb, basis, ImpHam, H1e, lattice=Lat, last_dmu=0.0,
    int_bath=True, solver=solver, solver_args={"nelec": nelec_emb})
print("DMET(CCSD) total energy:    %.10f" % (E * nlo * ncells))
print("correlation energy/cell:    %.6f"
      % (E * nlo - meta["E_hf"] / ncells))
