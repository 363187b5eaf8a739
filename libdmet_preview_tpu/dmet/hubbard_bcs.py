"""
BCS / Hartree-Fock-Bogoliubov DMET facade
(reference analog: /root/reference/libdmet/dmet/HubbardBCS.py and
routine/bcs.py).

Implementation note: the HFB/BdG problem is mathematically identical to a
GHF problem in the particle-hole transformed (GSO) frame -- the pairing
Delta a^dag b^dag becomes the number-conserving one-body block
[[v_a, D], [D^T, -v_b^T]].  So this facade drives the spinless machinery
(ops/spinless.py) with a Bogoliubov vcor: one code path covers
both the reference's bcs.py (Nambu) and spinless.py (GSO) stacks, and the
embedded problem stays a plain number-conserving FCI/CC solve instead of
requiring the reference's generated-code pairing integral transforms
(libdmet/integral/).
"""

import numpy as np

from libdmet_preview_tpu.ops import spinless
from libdmet_preview_tpu.ops.vcor import VcorLocal
from libdmet_preview_tpu.dmet.hubbard_gso import (
    GSOHam, GHartreeFock, ConstructImpHam, SolveImpHam_with_fitting,
    transformResults, copy_integral, apply_dmu)
from libdmet_preview_tpu.models.lattice import (
    ChainLattice, SquareLattice, CubicLattice)
from libdmet_preview_tpu.models.hamiltonian import HubbardHamiltonian as Ham

extractRdm = spinless.extract_rdm


def HartreeFockBogoliubov(gham, vcor, filling, mu0=0.0, beta=np.inf,
                          **kwargs):
    """HFB mean field: GHF of the transformed frame with the Bogoliubov
    vcor combined into the GSO one-body (reference HubbardBCS.py:9-48).
    Returns (GRho_R, mu, res); extract (rho_A, rho_B, kappa) with
    extractRdm(GRho_R[0])."""
    vmat = spinless.combine_vcor(np.asarray(vcor.get()))
    return GHartreeFock(gham, filling, mu0=mu0, vcor_mat=vmat, beta=beta,
                        **kwargs)


def VcorSC(nao, restricted=True):
    """Local Bogoliubov vcor [v, v, D]: full symmetric pairing block
    (s-wave onsite AND bond-wise d-wave structures)."""
    return VcorLocal(restricted, True, nao)


def FitVcor(GRhoEmb, lattice, basis, vcor, gham, mu, MaxIter=300,
            **kwargs):
    return spinless.FitVcorGSOEmb(GRhoEmb, lattice, basis, vcor,
                                  gham.GH1_k, mu, MaxIter=MaxIter, **kwargs)
