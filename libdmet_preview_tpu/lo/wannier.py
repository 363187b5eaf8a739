"""
Wannier-style localized orbitals
(reference /root/reference/libdmet/lo/pywannier90.py:73-700 W90 driver and
lo/proj_wannier.py:288-400 projection guesses).

The reference drives the external wannier90 library through ctypes.  This
build keeps the same *capability* -- a k-resolved set of
localized orbitals spanning selected bands from initial guesses -- via the
analytic projection method (the proj_wannier path, which is also what
wannier90 uses as its starting point):

    A(k) = C_mo(k)^H S(k) g        (project guesses onto the bands)
    U(k) = A(k) (A^H A)^{-1/2}     (per-k Lowdin orthonormalization)
    C_lo(k) = C_mo(k) U(k)

For isolated bands this is the global minimum of the gauge-invariant
spread part; SCDM (lo/scdm.py) covers the disentangled/smeared case.
All arithmetic is host-side numpy (complex allowed off-device).
"""

import numpy as np

from libdmet_preview_tpu.utils import logger as log


def _as_complex(A):
    A = A if not isinstance(A, (tuple, list)) else \
        np.asarray(A[0]) + 1j * np.asarray(A[1])
    return np.asarray(A)


def proj_wannier(C_mo_k, guess, ovlp_k=None, band_idx=None):
    """Projected Wannier gauge (reference proj_wannier.py:288-400).

    C_mo_k: (nk, nao, nmo) complex or (re, im) pair; guess: (nao, nlo)
    real initial-guess orbitals (e.g. unit vectors on target AOs);
    ovlp_k: optional (nk, nao, nao); band_idx: bands to span (default
    the first nlo).  Returns complex (nk, nao, nlo)."""
    C = _as_complex(C_mo_k)
    nk = C.shape[0]
    guess = np.asarray(guess)
    nlo = guess.shape[-1]
    if band_idx is None:
        band_idx = np.arange(nlo)
    out = np.empty((nk, C.shape[1], nlo), dtype=complex)
    for k in range(nk):
        Cb = C[k][:, band_idx]
        S = np.eye(C.shape[1]) if ovlp_k is None else _as_complex(ovlp_k)[k]
        A = Cb.conj().T @ S @ guess
        u, s, vt = np.linalg.svd(A, full_matrices=False)
        if s.min() < 1e-8:
            log.warn("proj_wannier: near-singular projection at k=%d "
                     "(min sv %.2e) -- guesses poorly overlap the bands",
                     k, s.min())
        out[k] = Cb @ (u @ vt)
    return out


def get_C_ao_lo_wannier(lattice, C_mo_k, guess, ovlp_k=None, band_idx=None):
    """Lattice-facing wrapper (reference make_basis.py:26-133
    get_C_ao_lo_wannier role): projected-Wannier C_ao_lo as a (re, im)
    pair shaped (1, nk, nao, nlo), directly usable as the lattice LO
    basis."""
    C = proj_wannier(C_mo_k, guess, ovlp_k=ovlp_k, band_idx=band_idx)
    return (np.ascontiguousarray(C.real)[None],
            np.ascontiguousarray(C.imag)[None])


class W90(object):
    """Native maximally-localized-Wannier driver with the reference's W90
    surface (reference pywannier90.py:73-640: make_win / get_A_mat /
    get_M_mat / kernel / export_AME).  Where the reference shells out to
    the external wannier90 Fortran library, this class runs the in-repo
    Marzari-Vanderbilt engine (lo/maxloc.py) -- the spread minimization is
    one jitted device program batched over all k-points.

    Parameters
    ----------
    C_mo_k  : (nk, norb, nband) complex Bloch coefficients on an
              orthonormal per-cell basis (kmesh_kpts_frac ordering), or a
              (re, im) pair.
    kmesh   : mesh sizes (tuple of 3).
    latt_vec: (3, 3) lattice vectors (rows).
    num_wann: number of Wannier functions (must equal nband; band
              disentanglement is covered by lo.scdm.scdm_smear).
    tau     : (norb, 3) orbital centers in Cartesian coords.
    guess   : (norb, num_wann) initial-guess orbitals for the projected
              starting gauge (default: identity gauge).
    """

    def __init__(self, C_mo_k, kmesh, latt_vec, num_wann, tau=None,
                 guess=None, band_idx=None):
        from libdmet_preview_tpu.lo import maxloc
        C = _as_complex(C_mo_k)
        if band_idx is not None:
            C = C[:, :, band_idx]
        if C.shape[-1] != num_wann:
            raise ValueError(
                "W90: nband (%d) != num_wann (%d); select bands with "
                "band_idx or disentangle with lo.scdm.scdm_smear first"
                % (C.shape[-1], num_wann))
        self.C_mo_k = C
        self.kmesh = tuple(int(x) for x in kmesh)
        self.latt_vec = np.asarray(latt_vec, dtype=float).reshape(3, 3)
        self.num_wann = int(num_wann)
        self.tau = tau
        self.guess = guess
        self.bv = maxloc.kmesh_bvectors(self.latt_vec, self.kmesh)
        self.kpts_frac = maxloc.kmesh_kpts_frac(self.kmesh)
        self.U_matrix = None
        self.wann_centers = None
        self.wann_spreads = None
        self.omega = None
        self.mo_energy_kpts = None

    # -- reference-shaped building blocks ------------------------------
    def get_M_mat(self):
        """(nk, nb, nw, nw) overlap tensor M^{(k,b)} (the .mmn content)."""
        from libdmet_preview_tpu.lo import maxloc
        M, _ = maxloc.mmn_from_C(self.C_mo_k, self.kmesh, self.latt_vec,
                                 tau=self.tau, bv=self.bv)
        return M

    def get_A_mat(self):
        """(nk, nw, nw) projection matrices A(k) = C(k)^H g (the .amn
        content; identity-gauge fallback when no guess is set)."""
        if self.guess is None:
            nk = self.C_mo_k.shape[0]
            return np.tile(np.eye(self.num_wann, dtype=complex)[None],
                           (nk, 1, 1))
        return np.einsum("kpm, pn -> kmn", self.C_mo_k.conj(),
                         np.asarray(self.guess))

    def kernel(self, A_matrix=None, M_matrix=None, max_iter=500,
               step=1.0, tol=1e-10):
        """Run the MV minimization.  Returns C_loc_k (nk, norb, nw)."""
        from libdmet_preview_tpu.lo import maxloc
        M0 = self.get_M_mat() if M_matrix is None else M_matrix
        U0 = None
        A = A_matrix if A_matrix is not None else (
            self.get_A_mat() if self.guess is not None else None)
        if A is not None:
            # Lowdin-orthonormalize the projection into a unitary gauge
            u, s, vt = np.linalg.svd(A, full_matrices=False)
            U0 = u @ vt
        U, info = maxloc.max_loc_U(M0, self.bv, U0=U0, max_iter=max_iter,
                                   step=step, tol=tol)
        self.U_matrix = np.asarray(U)
        self.omega = info["omega"]
        self.info = info
        self.wann_centers = info["centers"]
        # per-function spreads: diagonal decomposition of Omega
        Mf = np.asarray(maxloc._rotate_M(
            jnp_asarray(M0), jnp_asarray(self.U_matrix),
            self.bv["nb_idx"]))
        d = np.einsum("kbnn -> kbn", Mf)
        nk = Mf.shape[0]
        w_b, b_cart = self.bv["w_b"], self.bv["b_cart"]
        q = np.angle(d) + np.einsum("bx, nx -> bn", b_cart,
                                    self.wann_centers)[None]
        self.wann_spreads = (
            np.einsum("b, kbn -> n", w_b,
                      1.0 - np.abs(d) ** 2 + q ** 2) / nk
            + np.einsum("b, kbmn -> n", w_b,
                        np.abs(Mf) ** 2) / nk
            - np.einsum("b, kbn -> n", w_b, np.abs(d) ** 2) / nk)
        log.info("W90: Omega %.8f (I %.8f, D %.2e, OD %.2e), %d iters",
                 info["omega"], info["omega_I"], info["omega_D"],
                 info["omega_OD"], info["n_iter"])
        return np.einsum("kpm, kmn -> kpn", self.C_mo_k, self.U_matrix)

    # -- wannier90 text-format interop ---------------------------------
    def make_win(self, fname=None):
        """Minimal .win (reference make_win pywannier90.py:179-227)."""
        lines = ["num_wann = %d" % self.num_wann,
                 "num_bands = %d" % self.C_mo_k.shape[-1],
                 "begin unit_cell_cart"]
        for v in self.latt_vec * 0.529177210903:   # bohr -> angstrom
            lines.append(" %.10f %.10f %.10f" % tuple(v))
        lines += ["end unit_cell_cart",
                  "mp_grid = %d %d %d" % self.kmesh, "begin kpoints"]
        for k in self.kpts_frac:
            lines.append(" %.10f %.10f %.10f" % tuple(k))
        lines.append("end kpoints")
        text = "\n".join(lines) + "\n"
        if fname:
            with open(fname, "w") as f:
                f.write(text)
        return text

    def export_AME(self, prefix="wannier90"):
        """Write .amn / .mmn / .eig in the wannier90 text format
        (reference export_AME pywannier90.py:568-614), so a real
        wannier90 binary elsewhere can consume this build's overlaps."""
        nk, nb = self.C_mo_k.shape[0], self.C_mo_k.shape[-1]
        nw, nnb = self.num_wann, len(self.bv["w_b"])
        A = self.get_A_mat()
        with open(prefix + ".amn", "w") as f:
            f.write("generated by libdmet_preview_tpu\n")
            f.write("%d %d %d\n" % (nb, nk, nw))
            for k in range(nk):
                for n in range(nw):
                    for m in range(nb):
                        z = A[k, m, n]
                        f.write("%5d %4d %4d  %17.12f %17.12f\n"
                                % (m + 1, n + 1, k + 1, z.real, z.imag))
        M = self.get_M_mat()
        kmesh = np.array(self.kmesh)
        with open(prefix + ".mmn", "w") as f:
            f.write("generated by libdmet_preview_tpu\n")
            f.write("%d %d %d\n" % (nb, nk, nnb))
            pts = self.kpts_frac * kmesh
            for k in range(nk):
                for b in range(nnb):
                    k2 = self.bv["nb_idx"][k, b]
                    # reciprocal-lattice shift when k+b wraps the BZ
                    g = np.rint((pts[k] + self.bv["b_int"][b] - pts[k2])
                                / kmesh).astype(int)
                    f.write("%5d %5d  %3d %3d %3d\n"
                            % (k + 1, k2 + 1, g[0], g[1], g[2]))
                    for n in range(nb):
                        for m in range(nb):
                            z = M[k, b, m, n]
                            f.write("  %17.12f %17.12f\n"
                                    % (z.real, z.imag))
        if self.mo_energy_kpts is not None:
            with open(prefix + ".eig", "w") as f:
                for k in range(nk):
                    for m in range(nb):
                        f.write("%5d %5d  %17.12f\n"
                                % (m + 1, k + 1,
                                   self.mo_energy_kpts[k][m]))


def jnp_asarray(x):
    import jax.numpy as jnp
    return jnp.asarray(x)
