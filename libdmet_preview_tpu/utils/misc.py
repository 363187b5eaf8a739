"""
Small tensor helpers (JAX rewrite of reference utils/misc.py:34-298).

Everything here is shape-static and jit-safe unless noted; host-only helpers
(index bookkeeping) use numpy.
"""

import numpy as np
import jax.numpy as jnp

Iterable = (list, tuple, np.ndarray)


def max_abs(x):
    x = np.asarray(x)
    if x.size == 0:
        return 0.0
    if np.iscomplexobj(x):
        return float(np.abs(x).max())
    return float(max(np.max(x), -np.min(x)))


def mdot(*args):
    """Chained matrix product (host / numpy)."""
    r = args[0]
    for a in args[1:]:
        r = np.dot(r, a)
    return r


def add_spin_dim(H, spin, non_spin_dim=3):
    """Ensure H has a leading spin axis of length `spin` (broadcasting if 1)."""
    H = np.asarray(H)
    if H.ndim == non_spin_dim:
        H = H[None]
    assert H.ndim == non_spin_dim + 1
    if H.shape[0] < spin:
        H = np.asarray([H[0]] * spin)
    return H


def add_spin_dim_jnp(H, spin, non_spin_dim=3):
    if H.ndim == non_spin_dim:
        H = H[None]
    if H.shape[0] < spin:
        H = jnp.broadcast_to(H, (spin,) + H.shape[1:])
    return H


def tril_indices(n):
    return np.tril_indices(n)


def tril_diag_indices(n):
    """Indices of diagonal elements within a packed-tril vector of size n(n+1)/2."""
    return np.cumsum(np.arange(1, n + 1)) - 1


def triu_diag_indices(n):
    """Indices of diagonal elements in combinations_with_replacement(range(n), 2) order."""
    # pairs (i, j) with i <= j, row-major: index of (i, i)
    idx = []
    k = 0
    for i in range(n):
        idx.append(k)
        k += n - i
    return np.asarray(idx)


def pack_tril(A):
    """Pack the lower triangle of the last two axes."""
    A = np.asarray(A)
    n = A.shape[-1]
    idx = np.tril_indices(n)
    return A[..., idx[0], idx[1]]


def unpack_tril(Ap, n=None):
    Ap = np.asarray(Ap)
    npair = Ap.shape[-1]
    if n is None:
        n = int(round((np.sqrt(8 * npair + 1) - 1) / 2))
    out = np.zeros(Ap.shape[:-1] + (n, n), dtype=Ap.dtype)
    idx = np.tril_indices(n)
    out[..., idx[0], idx[1]] = Ap
    out_t = np.swapaxes(out, -1, -2).copy()
    out_t[..., idx[1][idx[0] == idx[1]], idx[1][idx[0] == idx[1]]] = 0.0
    d = np.arange(n)
    out_t[..., d, d] = 0.0
    return out + out_t


def format_idx(idx_list):
    return ", ".join(map(str, idx_list))
