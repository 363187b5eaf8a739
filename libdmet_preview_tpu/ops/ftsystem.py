"""
Finite-temperature occupations and chemical-potential search (JAX
rewrite of reference routine/ftsystem.py:24-292).

Two layers:
  * numpy host versions used by the one-shot mean-field driver (cheap, exact
    brentq mu search);
  * jnp versions (smooth, jit/vmap/grad-safe) used inside the jitted
    correlation-potential fit at finite beta, where d(occ)/d(mu) and
    d(occ)/d(eps) come from autodiff instead of the reference's hand-derived
    get_rho_grad/get_dw_dv (ftsystem.py:147-292).
"""

import numpy as np
import jax.numpy as jnp
from scipy.optimize import brentq

FIT_TOL = 1e-12


def fermi_smearing_occ(mu, mo_energy, beta):
    """Fermi-Dirac occupations, numpy, overflow-safe."""
    mo_energy = np.asarray(mo_energy)
    mu_arr = np.asarray(mu).reshape(-1, *([1] * (mo_energy.ndim - 1))) \
        if np.ndim(mu) > 0 else mu
    de = beta * (mo_energy - mu_arr)
    occ = np.zeros_like(mo_energy, dtype=float)
    idx = de < 100
    occ[idx] = 1.0 / (np.exp(de[idx]) + 1.0)
    return occ


def gaussian_smearing_occ(mu, mo_energy, beta):
    from scipy.special import erfc
    mo_energy = np.asarray(mo_energy)
    return 0.5 * erfc((mo_energy - mu) * beta)


def find_mu(nelec, mo_energy, beta, mu0=None, f_occ=fermi_smearing_occ,
            tol=FIT_TOL):
    """Brentq mu search on sorted energies (reference ftsystem.py:72-106)."""
    mo_energy = np.sort(np.asarray(mo_energy).ravel())

    def cost(mu):
        return f_occ(mu, mo_energy, beta).sum() - nelec

    nelec_int = int(np.round(nelec))
    if nelec_int >= len(mo_energy):
        lval = mo_energy[-1] - 1.0 / beta
        rval = mo_energy[-1] + max(10.0, 1.0 / beta)
    elif nelec_int <= 0:
        lval = mo_energy[0] - max(10.0, 1.0 / beta)
        rval = mo_energy[0] + 1.0 / beta
    else:
        lval = mo_energy[nelec_int - 1] - 1.0 / beta
        rval = mo_energy[nelec_int] + 1.0 / beta
    if cost(lval) * cost(rval) > 0:
        lval -= max(100.0, 1.0 / beta)
        rval += max(100.0, 1.0 / beta)
    return brentq(cost, lval, rval, xtol=tol, rtol=tol, maxiter=10000)


# ----------------------------------------------------------------------
# jnp versions (jit-safe)
# ----------------------------------------------------------------------

def fermi_occ_jnp(mu, ew, beta):
    return jnp.where(beta * (ew - mu) < 100.0,
                     1.0 / (jnp.exp(jnp.minimum(beta * (ew - mu), 100.0)) + 1.0),
                     0.0)


def find_mu_jnp(nelec, ew, beta, n_iter=80):
    """Bisection mu search, fixed iteration count (jit-safe).

    ew: flat (or any-shape) orbital energies; nelec: target total occupation.
    """
    lo = jnp.min(ew) - jnp.maximum(10.0, 1.0 / beta)
    hi = jnp.max(ew) + jnp.maximum(10.0, 1.0 / beta)

    def body(_, bounds):
        lo, hi = bounds
        mid = 0.5 * (lo + hi)
        n_mid = jnp.sum(fermi_occ_jnp(mid, ew, beta))
        too_low = n_mid < nelec
        return (jnp.where(too_low, mid, lo), jnp.where(too_low, hi, mid))

    import jax.lax as lax
    lo, hi = lax.fori_loop(0, n_iter, body, (lo, hi))
    return 0.5 * (lo + hi)


def make_rdm1(mo_coeff, mo_occ):
    return (mo_coeff * mo_occ).dot(mo_coeff.conj().T)
