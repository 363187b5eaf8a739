"""Antiferromagnetic CuO2 plane ab initio DMET -- the cuprate parent layer.

Native end to end: Cu q11 GTH-PADE pseudopotential (4s/3d valence) with
the generated tpu-szv basis, sqrt2 x sqrt2 AFM double cell (2 Cu + 4 O)
with vacuum along z, jellium-compensated (CuO2)^2- charge state,
spin-polarized supercell UHF with a staggered d9 guess, Lowdin
localization, interacting-bath UHF-DMET with bath matching.

This is the ab initio analog of the reference's 3-band/cuprate
order-parameter analysis (/root/reference/libdmet/utils/
get_order_param.py:18-576); the model-Hamiltonian version is
examples/05_threeband_cuprate.py.

Integral generation is cached under .cache/ (first run is slow; the
range-separated ERI driver converges the sharp Cu d/s pairs).
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import os

import jax
jax.config.update("jax_enable_x64", True)
import numpy as np

import libdmet_preview_tpu.dmet.hubbard as dmet
from libdmet_preview_tpu.models.abinitio import make_cuo2_afm_lattice
from libdmet_preview_tpu.ops import embham
from libdmet_preview_tpu.ops.vcor import VcorLocal
from libdmet_preview_tpu.solvers import MP2, SCFSolver

cache = os.path.join(os.path.dirname(__file__), os.pardir, ".cache")
Lat, meta = make_cuo2_afm_lattice(nk=2, cache_file=cache)
nsc = Lat.nscsites
cell = meta["cell"]
print("supercell UHF  E/cell = %.8f" % (meta["E_hf"] / 2))
print("staggered Cu d moment (Lowdin): %+0.4f / %+0.4f" %
      tuple(meta["mag_d"]))

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
print("IB UMP2-DMET   E/cell = %.8f  (E_corr = %.4f)"
      % (E_mpdmet * nsc, (E_mpdmet - E_hfdmet) * nsc))
