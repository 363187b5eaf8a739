"""Antiferromagnetic NiO ab initio DMET -- the d-electron flagship.

Native end to end: general-l GTH pseudopotentials (s/p/d nonlocal
projectors, C1-C4 local terms), a generated minimal valence basis
(Ni 3s/4s/3p/3d, O 2s/2p), AFM-II rhombohedral double cell on an
nk-cell BvK torus, spin-polarized supercell UHF with an AFM guess,
Lowdin localization, interacting-bath UHF-DMET with bath matching.

The reference runs this workload through PySCF KUHF + GDF
(/root/reference/examples/dmet/03-dmet-nio-afm/nio_afm.py); here every
integral comes from the in-repo McMurchie-Davidson/Ewald engine.

Integral generation is cached under .cache/ (first run ~10 min).
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import os

import jax
jax.config.update("jax_enable_x64", True)
import numpy as np

import libdmet_preview_tpu.dmet.hubbard as dmet
from libdmet_preview_tpu.models.abinitio import make_nio_afm_lattice
from libdmet_preview_tpu.ops import embham
from libdmet_preview_tpu.ops.vcor import VcorLocal
from libdmet_preview_tpu.solvers import MP2, SCFSolver, UCCSD

cache = os.path.join(os.path.dirname(__file__), os.pardir, ".cache")
Lat, meta = make_nio_afm_lattice(nk=2, cache_file=cache)
nsc = Lat.nscsites
cell = meta["cell"]
print("supercell UHF  E/cell = %.8f" % (meta["E_hf"] / 2))
print("staggered Ni d moment (Lowdin): %+0.4f / %+0.4f" %
      tuple(meta["mag_ni"]))

Filling = cell.nelectron / (2 * 2.0 * nsc)
vcor = VcorLocal(False, False, nsc)
vcor.assign(np.zeros((2, nsc, nsc)))
rho, Mu, res = dmet.HartreeFock(Lat, vcor, Filling, None, ires=True)
print("lattice MF     E/cell = %.8f  (identity dE = %.1e)"
      % (res["E"], abs(res["E"] - meta["E_hf"] / 2)))

ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor, matching=True,
                                          int_bath=True)
basis_k = Lat.R2k_basis(basis)
rho_mf = np.asarray(embham.foldRho_k(Lat.rdm1_lo_k, basis_k))
nel = int(round(np.trace(rho_mf[0]) + np.trace(rho_mf[1])))

hf = SCFSolver(restricted=False)
rhoEmb, EEmb = hf.run(ImpHam, nelec=nel, dm0=rho_mf, MaxIter=500)
_, E_hfdmet, _ = dmet.transformResults(
    rhoEmb, EEmb, basis, ImpHam, H1e, lattice=Lat, last_dmu=0.0,
    int_bath=True, solver=hf, solver_args={"nelec": nel})
print("IB UHF-DMET    E/cell = %.8f  (identity dE = %.1e)"
      % (E_hfdmet * nsc, abs(E_hfdmet * nsc - meta["E_hf"] / 2)))

mp = MP2(restricted=False)
rhoMP, EMP = mp.run(ImpHam, nelec=nel, dm0=rho_mf)
_, E_mpdmet, _ = dmet.transformResults(
    rhoMP, EMP, basis, ImpHam, H1e, lattice=Lat, last_dmu=0.0,
    int_bath=True, solver=mp, solver_args={"nelec": nel})
print("IB UMP2-DMET   E/cell = %.8f  (E_corr/cell = %.6f)"
      % (E_mpdmet * nsc, (E_mpdmet - E_hfdmet) * nsc))
# UCCSD on this embedding needs level_shift >= 0.3 (the bare
# amplitude iteration diverges on the near-degenerate d manifold):
# cc = UCCSD(restricted=False, tol=1e-6, level_shift=0.3)
