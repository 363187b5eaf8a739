"""
k <-> R transforms for stripe lattice operators (complex-free).

Replaces reference system/fourier.py:129-256.  k-space arrays are (re, im)
real-pair tuples and the DFT over the (small) cell mesh is a cos/sin
matmul (see ops/zlinalg.py).

Conventions (match reference fourier.py:160-178):
  FFTtoK: A(k) = sum_R e^{-i k.R} A(R)
  FFTtoT: A(R) = (1/Nk) sum_k e^{+i k.R} A(k)
"""

from libdmet_preview_tpu.ops import zlinalg

IMAG_DISCARD_TOL = 1e-5


def FFTtoK(A, kmesh):
    """Stripe R -> k; returns (re, im) pair."""
    return zlinalg.R2k(A, kmesh)


def FFTtoT(B, kmesh, tol=IMAG_DISCARD_TOL):
    """k pair -> stripe R (real part)."""
    return zlinalg.k2R(B, kmesh, real=True)


def R2k(A, kmesh, keep_complex=True):
    return zlinalg.R2k(A, kmesh)


def k2R(B, kmesh, tol=IMAG_DISCARD_TOL, real=True):
    return zlinalg.k2R(B, kmesh, real=real)


def get_phase(kmesh):
    """Complex phase matrix e^{+i k.R} (host-side, numpy; for tests)."""
    cos_t, sin_t = zlinalg.dft_tables(tuple(int(x) for x in kmesh))
    return cos_t + 1j * sin_t


# ----------------------------------------------------------------------
# k2gamma folding / supercell tools (reference fourier.py:354-800)
# ----------------------------------------------------------------------

def k2gamma(A_k, kmesh):
    """Fold a k-resolved operator to the Gamma-point supercell matrix
    (reference fold_h1/k2gamma role): the (nsites, nsites) block-circulant
    real matrix whose blocks are A(R)."""
    import numpy as np
    import itertools as it
    A_R = zlinalg.k2R(A_k, kmesh, real=True)
    A_R = np.asarray(A_R)
    lead = A_R.shape[:-3]
    nk, n, m = A_R.shape[-3:]
    kmesh = [int(x) for x in kmesh]
    cells = list(it.product(*[range(x) for x in kmesh]))
    idx = {c: i for i, c in enumerate(cells)}
    out = np.zeros(lead + (nk * n, nk * m))
    for i, ci in enumerate(cells):
        for j, cj in enumerate(cells):
            # lattice stripe convention: block (ci, cj) = A[(ci - cj) mod N]
            d = tuple((np.asarray(ci) - np.asarray(cj)) % kmesh)
            out[..., i * n:(i + 1) * n, j * m:(j + 1) * m] = A_R[..., idx[d], :, :]
    return out


def gamma2k(A_sc, kmesh, n):
    """Inverse of k2gamma: extract the stripe from the supercell matrix
    and transform to k (assumes block-circulant A_sc)."""
    import numpy as np
    nk = int(np.prod([int(x) for x in kmesh]))
    stripe = np.asarray([A_sc[..., R * n:(R + 1) * n, 0:n]
                         for R in range(nk)])
    stripe = np.moveaxis(stripe, 0, -3)
    return zlinalg.R2k(stripe, kmesh)


def wigner_seitz_images(kmesh, dim_sizes=None):
    """Minimal-image cell vectors and degeneracy weights for band
    interpolation (reference fourier.py Wigner-Seitz supercell).

    Returns (R_ws list of arrays, weights) where each stripe cell index R
    maps to all equivalent images R + N*kmesh of minimal norm; weights =
    1/#images."""
    import numpy as np
    import itertools as it
    kmesh = [int(x) for x in kmesh]
    cells = list(it.product(*[range(x) for x in kmesh]))
    R_ws, weights = [], []
    for c in cells:
        c = np.asarray(c, dtype=float)
        images = []
        best = None
        for shift in it.product(*[(-1, 0, 1)] * len(kmesh)):
            img = c + np.asarray(shift) * np.asarray(kmesh)
            d = float(np.dot(img, img))
            if best is None or d < best - 1e-9:
                best = d
                images = [img]
            elif abs(d - best) <= 1e-9:
                images.append(img)
        R_ws.append(np.asarray(images))
        weights.append(1.0 / len(images))
    return R_ws, np.asarray(weights)


def band_velocity(H_R_stripe, kmesh, kpts_frac):
    """Group velocity dE_n/dk at arbitrary fractional k-points by
    Hellmann-Feynman through the Wigner-Seitz interpolated H(k)
    (reference fourier.py:707-800 role).  1D/any-D, H_R_stripe real
    (nk, n, n).  Returns (bands (nkpt, n), velocity (nkpt, dim, n))."""
    import numpy as np
    H_R = np.asarray(H_R_stripe)
    R_ws, w = wigner_seitz_images(kmesh)
    kpts = np.asarray(kpts_frac, dtype=float)
    nkpt = len(kpts)
    n = H_R.shape[-1]
    dim = kpts.shape[1]
    bands = np.zeros((nkpt, n))
    vel = np.zeros((nkpt, dim, n))
    for ik, kf in enumerate(kpts):
        Hk = np.zeros((n, n), dtype=complex)
        dHk = np.zeros((dim, n, n), dtype=complex)
        for R_imgs, wt, HR in zip(R_ws, w, H_R):
            for img in R_imgs:
                ph = np.exp(-2j * np.pi * np.dot(kf, img)) * wt
                Hk += ph * HR
                dHk += (-2j * np.pi * img)[:, None, None] * ph * HR
        ew, ev = np.linalg.eigh(Hk)
        bands[ik] = ew
        for d in range(dim):
            vel[ik, d] = np.real(np.einsum("pi, pq, qi -> i",
                                           ev.conj(), dHk[d], ev))
    return bands, vel


def fold_mo_k2gamma(C_k, mo_energy, kmesh, make_real=True):
    """Fold k-resolved MOs to Gamma-point supercell MOs (reference
    fourier.py:354-609 fold_kmf/unfold_mo_coeff role).

    C_k: (re, im) pair (nk, n, nmo); mo_energy: (nk, nmo).
    Returns (C_sc, e_sc, ok): C_sc (nk*n, nk*nmo) supercell MO matrix
    (columns energy-sorted), e_sc the sorted energies, ok per-column
    real-gauge success flags (time-reversal-paired columns are real up to
    gauge; make_real fixes the gauge via lo.lowdin.make_real_columns)."""
    import numpy as np
    import itertools as it
    from libdmet_preview_tpu.lo.lowdin import make_real_columns
    C_re, C_im = np.asarray(C_k[0]), np.asarray(C_k[1])
    nk, n, nmo = C_re.shape
    kmesh = [int(x) for x in kmesh]
    kfrac = np.asarray(list(it.product(*[np.fft.fftfreq(m)
                                         for m in kmesh])))
    cells = np.asarray(list(it.product(*[range(m) for m in kmesh])),
                       dtype=float)
    phase = np.exp(2j * np.pi * (cells @ kfrac.T)) / np.sqrt(nk)  # (R, k)
    C = C_re + 1j * C_im
    # C_sc[(R p), (k m)] = e^{+ik.R} C_k[p, m] / sqrt(nk)
    C_sc = np.einsum("Rk, kpm -> Rpkm", phase, C).reshape(nk * n, nk * nmo)
    e_sc = np.asarray(mo_energy).reshape(nk * nmo)
    order = np.argsort(e_sc, kind="mergesort")
    C_sc = C_sc[:, order]
    e_sc = e_sc[order]
    if not make_real:
        return C_sc, e_sc, None
    # k/-k partner columns are degenerate; rotate each degenerate group
    # to a real basis (exists by time reversal)
    re, im = C_sc.real.copy(), C_sc.imag.copy()
    ok = np.zeros(nk * nmo, dtype=bool)
    start = 0
    tolg = 1e-8 * max(1.0, float(np.abs(e_sc).max()))
    for i in range(1, nk * nmo + 1):
        if i == nk * nmo or e_sc[i] - e_sc[start] > tolg:
            blk = C_sc[:, start:i]
            # real span: eigenvectors of the real part of the projector
            P = (blk @ blk.conj().T).real
            w, v = np.linalg.eigh(P)
            nb = i - start
            re[:, start:i] = v[:, -nb:]
            im[:, start:i] = 0.0
            ok[start:i] = w[-nb:] > 1.0 - 1e-7
            start = i
    return re if make_real else C_sc, e_sc, ok
