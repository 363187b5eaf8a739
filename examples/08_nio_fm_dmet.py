"""Ferromagnetic NiO ab initio DMET (reference example
/root/reference/examples/dmet/04-dmet-nio-fm/nio_fm.py, which fixes
cell.spin = 4 per double cell through PySCF KUHF + GDF).

Same native stack and rhombohedral double cell as the AFM flagship
(examples/07), but both Ni aligned: fixed-Sz supercell UHF
(n_alpha - n_beta = 4 per cell), spin-resolved lattice filling, and
interacting-bath UHF-DMET on the net-spin embedding.

Shares the integral disk cache with example 07 (same cell) -- only the
UHF state differs.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import os

import jax
jax.config.update("jax_enable_x64", True)
import numpy as np

import libdmet_preview_tpu.dmet.hubbard as dmet
from libdmet_preview_tpu.models.abinitio import make_nio_fm_lattice
from libdmet_preview_tpu.ops import embham
from libdmet_preview_tpu.ops.vcor import VcorLocal
from libdmet_preview_tpu.solvers import SCFSolver

cache = os.path.join(os.path.dirname(__file__), os.pardir, ".cache")
Lat, meta = make_nio_fm_lattice(nk=2, cache_file=cache)
nsc = Lat.nscsites
cell = meta["cell"]
na, nb = meta["nelec_ab"]
print("supercell UHF  E/cell = %.8f   (n_a - n_b = %d)"
      % (meta["E_hf"] / 2, na - nb))
print("aligned Ni d moments (Lowdin): %+0.4f / %+0.4f"
      % tuple(meta["mag_ni"]))

# lattice mean field at spin-resolved filling
filling = (na / (Lat.ncells * nsc), nb / (Lat.ncells * nsc))
vcor = VcorLocal(False, False, nsc)
vcor.assign(np.zeros((2, nsc, nsc)))
rho, Mu, res = dmet.HartreeFock(Lat, vcor, filling, None, ires=True)
print("lattice MF == supercell UHF: |dE| = %.2e"
      % abs(res["E"] - meta["E_hf"] / 2))

# interacting-bath UHF-DMET on the net-spin embedding
ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=True,
                                          int_bath=True)
basis_k = Lat.R2k_basis(basis)
rho_mf = np.asarray(embham.foldRho_k(Lat.rdm1_lo_k, basis_k))
nel = int(round(np.trace(rho_mf[0]) + np.trace(rho_mf[1])))
sz = int(round(np.trace(rho_mf[0]) - np.trace(rho_mf[1])))
hf = SCFSolver(restricted=False, Sz=sz)
rhoEmb, EEmb = hf.run(ImpHam, nelec=nel, dm0=rho_mf, MaxIter=500)
_, E_dmet, _ = dmet.transformResults(
    rhoEmb, EEmb, basis, ImpHam, H1e, lattice=Lat, last_dmu=0.0,
    int_bath=True, solver=hf, solver_args={"nelec": nel})
print("IB UHF-DMET E/cell = %.8f  (identity |dE| = %.2e)"
      % (E_dmet * nsc, abs(E_dmet * nsc - meta["E_hf"] / 2)))
