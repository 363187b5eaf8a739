"""
Orbital localization by metric maximization over orthogonal rotations
(reference analogs: lo/ibo.py:39-300 Pipek-Mezey/IBO with IAO charges,
lo/edmiston.py:31-300 Edmiston-Ruedenberg via a CIAH kernel).

Design: one generic maximizer -- the rotation is parametrized
as C exp(K) with K antisymmetric, the metric is a pure jax function, and
scipy BFGS drives jitted value/grad kernels (replacing the reference's
hand-coded CIAH second-order loop)."""

import numpy as np
import jax
import jax.numpy as jnp

from libdmet_preview_tpu.utils import logger as log


def _maximize_rotation(C0, metric_fn, tol=1e-9, maxiter=2000, seed=7,
                       n_start=1):
    """Maximize metric_fn(C0 @ exp(K)) over antisymmetric K.

    n_start > 1 runs a pool of random starting rotations and keeps the
    best maximum (the reference's ER model variant with a random-start
    pool, edmiston.py:31-300) -- localization landscapes have spurious
    stationary points."""
    from scipy.optimize import minimize as sp_minimize
    from jax.scipy.linalg import expm
    nmo = C0.shape[1]
    tri = np.tril_indices(nmo, -1)
    nrot = len(tri[0])
    C0j = jnp.asarray(C0)

    def unpack(p):
        K = jnp.zeros((nmo, nmo)).at[tri].set(p)
        return K - K.T

    def neg_metric(p):
        C = C0j @ expm(unpack(p))
        return -metric_fn(C)

    vg = jax.jit(jax.value_and_grad(neg_metric))

    def fun(p):
        v, g = vg(jnp.asarray(p))
        return float(v), np.asarray(g)

    import scipy.linalg as sla
    rng = np.random.RandomState(seed)
    best = None
    for trial in range(max(1, int(n_start))):
        scale = 1e-3 if trial == 0 else 0.5
        x0 = rng.randn(nrot) * scale
        res = sp_minimize(fun, x0, jac=True, method="BFGS",
                          options={"gtol": tol, "maxiter": maxiter})
        if best is None or res.fun < best.fun:
            best = res
    K = np.asarray(unpack(jnp.asarray(best.x)))
    return C0 @ sla.expm(K), -float(best.fun)


def pm_metric(C, ao_slices, S=None, power=2):
    """Pipek-Mezey metric sum_{i,A} Q_A(i)^power with Mulliken charges.

    ao_slices: list of AO index arrays per atom/fragment.  For an
    orthonormal (Lowdin/IAO) basis S = None -> Q_A(i) = sum_{mu in A}
    C_mu_i^2, which is the IBO construction when C is expressed in IAOs
    (reference ibo.py:39)."""
    total = 0.0
    if S is not None:
        SC = S @ C
    for A in ao_slices:
        if S is None:
            Q = jnp.sum(C[jnp.asarray(A), :] ** 2, axis=0)
        else:
            Q = jnp.sum(C[jnp.asarray(A), :] * SC[jnp.asarray(A), :],
                        axis=0)
        total = total + jnp.sum(Q ** power)
    return total


def er_metric(C, eri):
    """Edmiston-Ruedenberg metric sum_i (ii|ii) (reference edmiston.py)."""
    return jnp.einsum("pi, qi, ri, si, pqrs ->", C, C, C, C,
                      jnp.asarray(eri), optimize=True)


def localize_pm(C_occ, ao_slices, S=None, **kwargs):
    """Pipek-Mezey (or IBO when the basis is IAO) localization of the
    occupied orbitals.  Returns (C_loc, metric)."""
    return _maximize_rotation(np.asarray(C_occ),
                              lambda C: pm_metric(C, ao_slices, S=S),
                              **kwargs)


def localize_er(C_occ, eri, **kwargs):
    """Edmiston-Ruedenberg localization.  Returns (C_loc, metric)."""
    return _maximize_rotation(np.asarray(C_occ),
                              lambda C: er_metric(C, eri), **kwargs)


def ibo_metric(C, C_iao, S, atom_slices, power=4):
    """IBO metric (reference ibo.py:39-300): PM charges computed from
    IAO populations, quartic power (Knizia's IBO choice).

    C: (nao, nmo) occupied MOs; C_iao: (nao, niao) S-orthonormal IAOs;
    atom_slices: list of (start, stop) IAO index ranges per atom."""
    proj = jnp.einsum("pm, pq, qi -> mi", jnp.asarray(C_iao),
                      jnp.asarray(S), C, optimize=True)   # <iao_m | i>
    val = 0.0
    for (a, b) in atom_slices:
        Q = jnp.sum(proj[a:b] ** 2, axis=0)               # q_A(i)
        val = val + jnp.sum(Q ** power)
    return val


def localize_ibo(C_occ, C_iao, S, atom_slices, **kwargs):
    """Intrinsic bond orbitals: maximize the quartic IAO-charge metric
    over orthogonal rotations of the occupied space."""
    return _maximize_rotation(
        np.asarray(C_occ),
        lambda C: ibo_metric(C, C_iao, S, atom_slices), **kwargs)
