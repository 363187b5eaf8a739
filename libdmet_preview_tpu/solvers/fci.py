"""
Full CI impurity solver.

Replaces the reference's pyscf direct_spin1/direct_uhf wrappers
(solver/fci.py:41-430) with a jit-compiled determinant-string sigma algorithm:

  * string enumeration + single-excitation link tables are built once on host
    (numpy, cached per (norb, nelec));
  * the sigma vector is computed as
        t1[pq] = E_pq c        (scatter-add over links)
        g      = h2e . t1      (one (n^2 x n^2) x (n^2 x na*nb) GEMM)
        sigma  = sum_pq E_pq g (scatter-add over links)
    which is the Knowles-Handy algorithm with the dense contraction in the
    middle as one GEMM;
  * Davidson iterations run as a host loop over the jitted sigma;
  * rdm1/rdm2 are single GEMMs over the same t1 tensors.

Solver contract matches the reference (run -> (rdm1, E), run_dmet_ham,
onepdm/twopdm, cleanup), cf. solver/fci.py:78-305.
"""

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp

from libdmet_preview_tpu.utils import logger as log


# ----------------------------------------------------------------------
# string tables (host)
# ----------------------------------------------------------------------

@lru_cache(maxsize=None)
def make_strings(norb, nelec):
    """All nelec-bit strings over norb orbitals, pyscf cistring order
    (ascending binary value)."""
    if nelec == 0:
        return np.asarray([0], dtype=np.int64)
    if nelec > norb:
        raise ValueError("nelec > norb")
    strings = []

    def gen(orb, remaining, current):
        if remaining == 0:
            strings.append(current)
            return
        if orb >= norb:
            return
        # choose orbitals in increasing order -> ascending binary strings
        gen(orb + 1, remaining, current)
        gen(orb + 1, remaining - 1, current | (1 << orb))

    gen(0, nelec, 0)
    return np.asarray(sorted(strings), dtype=np.int64)


@lru_cache(maxsize=None)
def num_strings(norb, nelec):
    from math import comb
    return comb(norb, nelec)


@lru_cache(maxsize=None)
def make_link_table(norb, nelec):
    """Link table: for each string I, entries (pq=a*norb+i, J, sign) with
    E_{a i} |I> = sign |J>.  Shape (nstr, nlink, 3), nlink =
    nelec*(norb-nelec+1)."""
    strings = make_strings(norb, nelec)
    addr = {int(s): i for i, s in enumerate(strings)}
    nstr = len(strings)
    nlink = nelec * (norb - nelec) + nelec
    tab = np.zeros((nstr, nlink, 3), dtype=np.int32)
    for I, s in enumerate(strings):
        k = 0
        occ = [o for o in range(norb) if (s >> o) & 1]
        vir = [o for o in range(norb) if not (s >> o) & 1]
        for i in occ:
            # diagonal E_ii
            tab[I, k] = (i * norb + i, I, 1)
            k += 1
        for i in occ:
            for a in vir:
                s1 = (int(s) & ~(1 << i)) | (1 << a)
                # parity: number of occupied orbitals between i and a
                lo, hi = (i, a) if i < a else (a, i)
                nperm = bin(int(s) >> (lo + 1) & ((1 << (hi - lo - 1)) - 1)).count("1")
                sign = 1 - 2 * (nperm & 1)
                tab[I, k] = (a * norb + i, addr[s1], sign)
                k += 1
        assert k == nlink
    return tab


@lru_cache(maxsize=None)
def _flat_links(norb, nelec):
    """Flattened link arrays (I, pq, J, sign) as device-ready int32/float64."""
    tab = make_link_table(norb, nelec)
    nstr, nlink, _ = tab.shape
    I = np.repeat(np.arange(nstr, dtype=np.int32), nlink)
    pq = tab[:, :, 0].ravel()
    J = tab[:, :, 1].ravel()
    sign = tab[:, :, 2].ravel().astype(np.float64)
    return I, pq, J, sign


# ----------------------------------------------------------------------
# jitted kernels
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnums=(2,))
def _apply_links(ci, links, norb):
    """t1[pq, J, Ib] = sum_links sign * ci[I, Ib] (alpha-string application).

    ci: (na, nb); links: (I, pq, J, sign) flat arrays.
    Returns (norb*norb, na, nb)."""
    I, pq, J, sign = links
    na, nb = ci.shape
    t1 = jnp.zeros((norb * norb, na, nb), dtype=ci.dtype)
    contrib = sign[:, None] * ci[I]
    return t1.at[pq, J].add(contrib)


@partial(jax.jit, static_argnums=(2,))
def _apply_links_T(g, links, norb):
    """sigma[J, Ib] += sign * g[pq, I, Ib]  (second link application)."""
    I, pq, J, sign = links
    na = g.shape[1]
    nb = g.shape[2]
    sigma = jnp.zeros((na, nb), dtype=g.dtype)
    contrib = sign[:, None] * g[pq, I]
    return sigma.at[J].add(contrib)


def _sigma_rhf(h2e, ci, links_a, links_b, norb):
    """H*ci for spin-restricted integrals (same h for both spins)."""
    na, nb = ci.shape
    t1 = _apply_links(ci, links_a, norb)
    t1b = _apply_links(ci.T, links_b, norb)
    t1 = t1 + t1b.transpose(0, 2, 1)
    g = (h2e.reshape(norb * norb, norb * norb)
         @ t1.reshape(norb * norb, na * nb)).reshape(norb * norb, na, nb)
    sigma = _apply_links_T(g, links_a, norb)
    sigma_b = _apply_links_T(g.transpose(0, 2, 1), links_b, norb)
    return sigma + sigma_b.T


def _sigma_uhf(h2e_aa, h2e_ab, h2e_bb, ci, links_a, links_b, norb):
    """H*ci with spin-dependent absorbed integrals.

    h2e_ab in chemist (alpha alpha | beta beta)."""
    na, nb = ci.shape
    nn = norb * norb
    t1a = _apply_links(ci, links_a, norb)  # (nn, na, nb)
    t1b = _apply_links(ci.T, links_b, norb).transpose(0, 2, 1)  # (nn, na, nb)
    g_a = (h2e_aa.reshape(nn, nn) @ t1a.reshape(nn, -1)
           + h2e_ab.reshape(nn, nn) @ t1b.reshape(nn, -1)).reshape(nn, na, nb)
    g_b = (h2e_bb.reshape(nn, nn) @ t1b.reshape(nn, -1)
           + h2e_ab.reshape(nn, nn).T @ t1a.reshape(nn, -1)).reshape(nn, na, nb)
    sigma = _apply_links_T(g_a, links_a, norb)
    sigma_b = _apply_links_T(g_b.transpose(0, 2, 1), links_b, norb)
    return sigma + sigma_b.T


# ----------------------------------------------------------------------
# integral preparation (absorb one-body into two-body; pyscf convention)
# ----------------------------------------------------------------------

def absorb_h1e_rhf(h1e, eri, norb, nelec_tot):
    h2e = np.array(eri, copy=True)
    f1e = h1e - np.einsum("jiik->jk", h2e) * 0.5
    f1e *= 1.0 / (nelec_tot + 1e-100)
    for k in range(norb):
        h2e[k, k, :, :] += f1e
        h2e[:, :, k, k] += f1e
    return h2e * 0.5


def absorb_h1e_uhf(h1e, eri, norb, nelec_tot):
    """(h1a, h1b), (g_aa, g_ab, g_bb) -> absorbed (h2e_aa, h2e_ab, h2e_bb);
    mirrors pyscf.fci.direct_uhf.absorb_h1e."""
    h1a, h1b = h1e
    g_aa, g_ab, g_bb = [np.array(x, copy=True) for x in eri]
    f1a = h1a - np.einsum("jiik->jk", g_aa) * 0.5
    f1b = h1b - np.einsum("jiik->jk", g_bb) * 0.5
    f1a *= 1.0 / (nelec_tot + 1e-100)
    f1b *= 1.0 / (nelec_tot + 1e-100)
    for k in range(norb):
        g_aa[k, k, :, :] += f1a
        g_aa[:, :, k, k] += f1a
        g_ab[k, k, :, :] += f1b
        g_ab[:, :, k, k] += f1a
        g_bb[k, k, :, :] += f1b
        g_bb[:, :, k, k] += f1b
    return g_aa * 0.5, g_ab * 0.5, g_bb * 0.5


def make_hdiag(h1e, eri, norb, nelec):
    """Diagonal of H over determinants (host, numpy).

    h1e: (h1a, h1b); eri: (g_aa, g_ab, g_bb) chemist notation."""
    nea, neb = nelec
    h1a, h1b = h1e
    g_aa, g_ab, g_bb = eri
    sa = make_strings(norb, nea)
    sb = make_strings(norb, neb)
    occ_a = np.asarray([[o for o in range(norb) if (s >> o) & 1] for s in sa],
                       dtype=int).reshape(len(sa), nea)
    occ_b = np.asarray([[o for o in range(norb) if (s >> o) & 1] for s in sb],
                       dtype=int).reshape(len(sb), neb)
    jdiag_aa = np.einsum("iijj->ij", g_aa)
    kdiag_aa = np.einsum("ijji->ij", g_aa)
    jdiag_ab = np.einsum("iijj->ij", g_ab)
    jdiag_bb = np.einsum("iijj->ij", g_bb)
    kdiag_bb = np.einsum("ijji->ij", g_bb)

    e_a = h1a[occ_a, occ_a].sum(axis=1) if nea else np.zeros(len(sa))
    e_b = h1b[occ_b, occ_b].sum(axis=1) if neb else np.zeros(len(sb))
    # same-spin two-body
    ja = 0.5 * (jdiag_aa[occ_a[:, :, None], occ_a[:, None, :]].sum(axis=(1, 2))
                - kdiag_aa[occ_a[:, :, None], occ_a[:, None, :]].sum(axis=(1, 2))) \
        if nea else np.zeros(len(sa))
    jb = 0.5 * (jdiag_bb[occ_b[:, :, None], occ_b[:, None, :]].sum(axis=(1, 2))
                - kdiag_bb[occ_b[:, :, None], occ_b[:, None, :]].sum(axis=(1, 2))) \
        if neb else np.zeros(len(sb))
    hdiag = (e_a + ja)[:, None] + (e_b + jb)[None, :]
    if nea and neb:
        cross = jdiag_ab[occ_a].sum(axis=1)  # (na, norb): sum_i (ii|pp)
        hdiag = hdiag + cross[:, occ_b].sum(axis=-1)
    return hdiag


# ----------------------------------------------------------------------
# Davidson eigensolver (host loop over jitted sigma)
# ----------------------------------------------------------------------

def davidson(matvec, hdiag, x0=None, tol=1e-11, max_cycle=200,
             max_space=30, n_keep=4, guard_cap=8):
    """Lowest eigenpair by Davidson with THICK RESTART and GUARD ROOTS.

    Thick restart: when the subspace is full it collapses onto the
    lowest Ritz vectors (their matvec images are linear combinations of
    the stored ones, so the restart costs no extra sigma builds) instead
    of a single-vector restart -- keeps the convergence history
    (reference delegates to pyscf lib.davidson).

    Guard roots (cold start only): single-root Davidson has a symmetry
    trap -- if the Ritz minimum of the current subspace lies in an
    H-invariant sector (e.g. the spin-swap-antisymmetric triplet
    determinants of an Sz=0 FCI block), every preconditioned residual
    stays in that sector and the iteration converges, with a genuinely
    ZERO residual, to the lowest EXCITED state of that sector -- even
    when the subspace already overlaps the true ground state.  A fixed
    number of guard roots cannot fix this either: a degenerate excited
    manifold (the 3-fold triplet in a GHF-frame FCI space) absorbs any
    fixed count.  The robust rule used here: keep converging Ritz roots
    UPWARD until some converged root sits STRICTLY ABOVE root 0; the
    higher root's residual expansion necessarily probes the
    complementary sector, after which the lowest Ritz pair flips to the
    global ground state.  Warm starts (x0 from a previous solve of a
    nearby Hamiltonian) keep the fast single-root path."""
    n = hdiag.size
    hd = hdiag.ravel()
    queue = []
    cold = x0 is None
    rng = np.random.RandomState(7)
    if cold:
        # Seed a small block of lowest-diagonal determinants (a cheap
        # pspace guess: after the queue drains, the Ritz step IS the
        # dense diagonalization of this determinant sub-block) -- but
        # ADMIX dense noise into every seed.  Pure determinant seeds are
        # poison when they include symmetry-image pairs (e.g. the
        # spin-swap partners of an Sz=0 block): the projected H then
        # block-diagonalizes over the symmetry sectors, eigh returns
        # sector-PURE Ritz vectors, and since H preserves the sectors the
        # preconditioned-residual expansion refines only the sector of
        # the current Ritz minimum.  A mixed seed keeps every Ritz vector
        # mixed, so both sector Krylov spaces grow and the global ground
        # state is found (Krylov of a mixed vector = direct sum of the
        # sector Krylov spaces).
        order = np.argsort(hd)
        def _noisy(k):
            ek = np.zeros(n)
            ek[k] = 1.0
            r = rng.randn(n)
            return ek + (0.1 / np.linalg.norm(r)) * r
        x0 = _noisy(order[0])
        for k in order[1:min(4, n)]:
            queue.append(_noisy(k))
    ctol = max(tol * 10, 1e-9)
    gap_tol = max(tol * 100, 1e-8)
    guard_cap = int(max(2, min(guard_cap, n))) if cold else 1
    xs, ax = [], []
    theta, u, rnorm = None, None, np.inf
    e_last = None
    pend = [np.asarray(x0, dtype=np.float64).ravel()]
    n_rand = 0
    for it in range(max_cycle):
        added = 0
        for y in pend:
            y = np.array(y, dtype=np.float64)
            # twice-orthogonalize against the subspace (numerical safety)
            for _ in range(2):
                for xi in xs:
                    y = y - xi * np.dot(xi, y)
            ny = np.linalg.norm(y)
            if ny < 1e-12:
                continue
            y = y / ny
            xs.append(y)
            ax.append(np.asarray(matvec(y)).ravel())
            added += 1
        if not added:
            # every candidate collapsed into the span
            if queue:
                pend = [queue.pop(0)]
                continue
            if len(xs) >= n or rnorm < ctol or n_rand >= 3:
                break
            n_rand += 1
            pend = [rng.randn(n)]
            continue
        m = len(xs)
        Hs = np.empty((m, m))
        for i in range(m):
            for j in range(m):
                Hs[i, j] = np.dot(xs[i], ax[j])
        Hs = 0.5 * (Hs + Hs.T)
        w, v = np.linalg.eigh(Hs)
        # residuals of ascending Ritz roots, up to the first CONVERGED
        # root strictly above root 0 (subspace algebra only, no matvecs)
        k = min(guard_cap, m)
        us, resids, rnorms = [], [], []
        guards_ok = m >= n
        for r in range(k):
            ur = sum(v[i, r] * xs[i] for i in range(m))
            Aur = sum(v[i, r] * ax[i] for i in range(m))
            rr = Aur - w[r] * ur
            us.append(ur)
            resids.append(rr)
            rnorms.append(np.linalg.norm(rr))
            if r > 0 and rnorms[r] < ctol and w[r] > w[0] + gap_tol:
                guards_ok = True
                break
        if not cold:
            guards_ok = True
        theta, u, rnorm = w[0], us[0], rnorms[0]
        # residual threshold sets the VECTOR quality: near-degenerate
        # states mix as rnorm/gap, so keep it tight (3-band px/py
        # symmetry test)
        conv0 = (e_last is not None and abs(theta - e_last) < tol
                 and rnorm < ctol)
        if conv0 and guards_ok and not queue:
            return theta, u
        e_last = theta
        # expand the (up to 2) lowest unconverged roots among those seen
        pend = []
        for r in range(len(rnorms)):
            if rnorms[r] > ctol:
                denom = hd - w[r]
                denom = np.where(np.abs(denom) < 1e-10, 1e-10, denom)
                pend.append(resids[r] / denom)
                if len(pend) >= 2:
                    break
        if queue:
            pend.append(queue.pop(0))
        if m >= max_space:
            # thick restart: keep the lowest Ritz pairs, enough to cover
            # the roots being converged
            keep = min(max(n_keep, len(rnorms) + 1), m)
            xs_new, ax_new = [], []
            for r in range(keep):
                uk = sum(v[i, r] * xs[i] for i in range(m))
                auk = sum(v[i, r] * ax[i] for i in range(m))
                for jx, xj in enumerate(xs_new):   # safety re-orth
                    c = np.dot(xj, uk)
                    uk = uk - c * xj
                    auk = auk - c * ax_new[jx]
                nk_ = np.linalg.norm(uk)
                if nk_ < 1e-10:
                    continue
                xs_new.append(uk / nk_)
                ax_new.append(auk / nk_)
            xs, ax = xs_new, ax_new
    if rnorm > ctol:
        log.warn("FCI Davidson not fully converged: resid=%.2e", rnorm)
    return theta, u


# ----------------------------------------------------------------------
# kernel + rdm
# ----------------------------------------------------------------------

def fci_kernel(h1e, eri, norb, nelec, ecore=0.0, tol=1e-11, ci0=None,
               max_cycle=100):
    """Solve for the FCI ground state.

    h1e: (n, n) or (h1a, h1b); eri: (n,)*4 or (g_aa, g_ab, g_bb) chemist.
    Returns (E, ci) with E including ecore.
    """
    nea, neb = nelec
    restricted_ints = (not isinstance(h1e, (tuple, list))) and np.asarray(h1e).ndim == 2
    links_a = tuple(jnp.asarray(x) for x in _flat_links(norb, nea))
    links_b = tuple(jnp.asarray(x) for x in _flat_links(norb, neb))
    na, nb = num_strings(norb, nea), num_strings(norb, neb)

    if restricted_ints:
        h2e = jnp.asarray(absorb_h1e_rhf(np.asarray(h1e), np.asarray(eri),
                                         norb, nea + neb))
        sig = jax.jit(lambda c: _sigma_rhf(h2e, c, links_a, links_b, norb))
        hdiag = make_hdiag((np.asarray(h1e),) * 2,
                           (np.asarray(eri),) * 3, norb, nelec)
    else:
        h1a, h1b = h1e
        g_aa, g_ab, g_bb = eri
        ha, hab, hb = absorb_h1e_uhf((np.asarray(h1a), np.asarray(h1b)),
                                     (np.asarray(g_aa), np.asarray(g_ab),
                                      np.asarray(g_bb)), norb, nea + neb)
        ha, hab, hb = jnp.asarray(ha), jnp.asarray(hab), jnp.asarray(hb)
        sig = jax.jit(lambda c: _sigma_uhf(ha, hab, hb, c, links_a, links_b, norb))
        hdiag = make_hdiag((np.asarray(h1a), np.asarray(h1b)),
                           (np.asarray(g_aa), np.asarray(g_ab), np.asarray(g_bb)),
                           norb, nelec)

    def matvec(x):
        return np.asarray(sig(jnp.asarray(x.reshape(na, nb)))).ravel()

    x0 = None if ci0 is None else np.asarray(ci0).ravel()
    e, ci = davidson(matvec, hdiag, x0=x0, tol=tol, max_cycle=max_cycle)
    return e + ecore, ci.reshape(na, nb)


@partial(jax.jit, static_argnums=(3,))
def _trans_rdm1s(ci, links_a, links_b, norb):
    """Spin-resolved rdm1: gamma[s][p, q] = <E^s_pq>."""
    t1a = _apply_links(ci, links_a, norb)
    t1b = _apply_links(ci.T, links_b, norb).transpose(0, 2, 1)
    ga = jnp.einsum("xab, ab -> x", t1a, ci).reshape(norb, norb)
    gb = jnp.einsum("xab, ab -> x", t1b, ci).reshape(norb, norb)
    return ga, gb


@partial(jax.jit, static_argnums=(3,))
def _make_rdm2(ci, links_a, links_b, norb):
    """Spin-resolved rdm2 (chemist, reordered):
      G_ss'[p,q,r,s] = <E^s_pq E^s'_rs> - delta_qr delta_ss' <E^s_ps>
    Returns (G_aa, G_bb, G_ab)."""
    nn = norb * norb
    t1a = _apply_links(ci, links_a, norb).reshape(nn, -1)
    t1b = _apply_links(ci.T, links_b, norb).transpose(0, 2, 1).reshape(nn, -1)
    # <c| E_pq = (E_qp c)^T
    perm = (jnp.arange(nn).reshape(norb, norb).T).ravel()
    ta_left = t1a[perm]
    tb_left = t1b[perm]
    Gaa = (ta_left @ t1a.T).reshape(norb, norb, norb, norb)
    Gbb = (tb_left @ t1b.T).reshape(norb, norb, norb, norb)
    Gab = (ta_left @ t1b.T).reshape(norb, norb, norb, norb)
    ga = jnp.einsum("xab, ab -> x", t1a.reshape(nn, *ci.shape), ci).reshape(norb, norb)
    gb = jnp.einsum("xab, ab -> x", t1b.reshape(nn, *ci.shape), ci).reshape(norb, norb)
    eye = jnp.eye(norb)
    Gaa = Gaa - jnp.einsum("qr, ps -> pqrs", eye, ga)
    Gbb = Gbb - jnp.einsum("qr, ps -> pqrs", eye, gb)
    return Gaa, Gbb, Gab


def make_rdm1s(ci, norb, nelec):
    links_a = tuple(jnp.asarray(x) for x in _flat_links(norb, nelec[0]))
    links_b = tuple(jnp.asarray(x) for x in _flat_links(norb, nelec[1]))
    ga, gb = _trans_rdm1s(jnp.asarray(ci), links_a, links_b, norb)
    # symmetrize: gamma_pq = <p^+ q>; transition tensor gives <E_pq>
    ga = np.asarray(ga)
    gb = np.asarray(gb)
    return 0.5 * (ga + ga.T), 0.5 * (gb + gb.T)


def make_rdm2s(ci, norb, nelec):
    links_a = tuple(jnp.asarray(x) for x in _flat_links(norb, nelec[0]))
    links_b = tuple(jnp.asarray(x) for x in _flat_links(norb, nelec[1]))
    Gaa, Gbb, Gab = _make_rdm2(jnp.asarray(ci), links_a, links_b, norb)
    return np.asarray(Gaa), np.asarray(Gbb), np.asarray(Gab)


# ----------------------------------------------------------------------
# solver class (reference contract)
# ----------------------------------------------------------------------

class FCI(object):
    """FCI impurity solver with the reference's interface
    (solver/fci.py:41-305): run(ImpHam, nelec=...) -> (rdm1, E)."""

    def __init__(self, restricted=False, Sz=0, tol=1e-11, max_cycle=200,
                 ghf=False, **kwargs):
        self.restricted = restricted
        self.Sz = Sz
        self.ghf = ghf
        self.conv_tol = tol
        self.max_cycle = max_cycle
        self.ci = None
        self.onepdm = None
        self.twopdm = None
        self.norb = None
        self.nelec = None
        self.optimized = False
        self._last_ints = None

    def run(self, Ham, nelec=None, guess=None, calc_rdm2=False, **kwargs):
        norb = Ham.norb
        if nelec is None:
            raise ValueError("FCI.run requires nelec")
        if self.ghf:
            # spinless / generalized-spin-orbital FCI: a single fermion
            # species over all norb orbitals (reference solver/fci.py
            # ghf=True path); nelec counts transformed particles
            return self._run_ghf(Ham, nelec, calc_rdm2=calc_rdm2, **kwargs)
        nelec_a = (nelec + self.Sz) // 2
        nelec_b = (nelec - self.Sz) // 2
        assert nelec_a >= 0 and nelec_b >= 0 and nelec_a + nelec_b == nelec
        self.nelec = (nelec_a, nelec_b)
        self.norb = norb

        if Ham.restricted:
            h1 = np.asarray(Ham.H1["cd"][0])
            h2 = np.asarray(Ham.H2["ccdd"][0])
            ints = (h1, h2)
        else:
            h1 = (np.asarray(Ham.H1["cd"][0]), np.asarray(Ham.H1["cd"][1]))
            H2 = Ham.H2["ccdd"]
            # libdmet order [aa, bb, ab] -> (g_aa, g_ab, g_bb)
            ints = (h1, (np.asarray(H2[0]), np.asarray(H2[2]), np.asarray(H2[1])))

        ci0 = self.ci if (self.ci is not None and
                          self.ci.shape == (num_strings(norb, nelec_a),
                                            num_strings(norb, nelec_b))) else None
        if Ham.restricted:
            E, self.ci = fci_kernel(ints[0], ints[1], norb, self.nelec,
                                    ecore=float(Ham.H0), tol=self.conv_tol,
                                    ci0=ci0, max_cycle=self.max_cycle)
        else:
            E, self.ci = fci_kernel(ints[0], ints[1], norb, self.nelec,
                                    ecore=float(Ham.H0), tol=self.conv_tol,
                                    ci0=ci0, max_cycle=self.max_cycle)
        ga, gb = make_rdm1s(self.ci, norb, self.nelec)
        if Ham.restricted:
            # spin dimension 1, half of the total rdm (reference fci.py:268)
            self.onepdm = (0.5 * (ga + gb))[None]
        else:
            self.onepdm = np.asarray([ga, gb])
        if calc_rdm2:
            self.make_rdm2(Ham)
        self.E = E
        self.optimized = True
        return self.onepdm, E

    def _run_ghf(self, Ham, nelec, calc_rdm2=False, **kwargs):
        norb = Ham.norb
        self.nelec = (nelec, 0)
        self.norb = norb
        h1 = np.asarray(Ham.H1["cd"][0])
        h2 = np.asarray(Ham.H2["ccdd"][0])
        ci0 = self.ci if (self.ci is not None and
                          self.ci.shape == (num_strings(norb, nelec), 1)) \
            else None
        E, self.ci = fci_kernel(h1, h2, norb, self.nelec,
                                ecore=float(Ham.H0), tol=self.conv_tol,
                                ci0=ci0, max_cycle=self.max_cycle)
        ga, gb = make_rdm1s(self.ci, norb, self.nelec)
        self.onepdm = ga[None]
        if calc_rdm2:
            self.make_rdm2(Ham)
        self.E = E
        self.optimized = True
        return self.onepdm, E

    def make_rdm2(self, Ham):
        if self.ghf:
            Gaa, Gbb, Gab = make_rdm2s(self.ci, self.norb, self.nelec)
            self.twopdm = Gaa[None]
            return self.twopdm
        Gaa, Gbb, Gab = make_rdm2s(self.ci, self.norb, self.nelec)
        if Ham.restricted:
            self.twopdm = (Gaa + Gbb + Gab + Gab.transpose(2, 3, 0, 1))[None]
        else:
            self.twopdm = np.asarray([Gaa, Gbb, Gab])
        return self.twopdm

    def run_dmet_ham(self, Ham, last_aabb=True, **kwargs):
        """Evaluate energy of the scaled DMET Hamiltonian with the stored
        rdm1/rdm2 (reference fci.py:205-259)."""
        self.make_rdm2(Ham)
        r1 = self.onepdm
        r2 = self.twopdm
        if self.ghf:
            h1 = np.asarray(Ham.H1["cd"][0])
            h2 = np.asarray(Ham.H2["ccdd"][0])
            E1 = np.einsum("pq, qp", h1, r1[0])
            E2 = np.einsum("pqrs, pqrs", h2, r2[0]) * 0.5
            return E1 + E2 + Ham.H0
        if Ham.restricted:
            h1 = np.asarray(Ham.H1["cd"][0])
            h2 = np.asarray(Ham.H2["ccdd"][0])
            if h2.ndim == 2:
                from libdmet_preview_tpu.models.integral import restore_eri
                h2 = restore_eri(h2, Ham.norb, 1)
            E1 = np.einsum("pq, qp", h1, r1[0]) * 2.0
            E2 = np.einsum("pqrs, pqrs", h2, r2[0]) * 0.5
        else:
            h1 = np.asarray(Ham.H1["cd"])
            H2 = Ham.H2["ccdd"]
            from libdmet_preview_tpu.models.integral import restore_eri
            h2 = [np.asarray(x) for x in H2]
            h2 = [restore_eri(x, Ham.norb, 1) if x.ndim == 2 else x for x in h2]
            # h2 order [aa, bb, ab]; r2 = (Gaa, Gbb, Gab)
            E1 = np.einsum("spq, sqp", h1, r1)
            E2 = (0.5 * np.einsum("pqrs, pqrs", h2[0], r2[0])
                  + 0.5 * np.einsum("pqrs, pqrs", h2[1], r2[1])
                  + np.einsum("pqrs, pqrs", h2[2], r2[2]))
        E = E1 + E2 + Ham.H0
        return E

    def cleanup(self):
        pass
