"""
Correlation-potential fitting (JAX rewrite of reference
routine/slater.py:820-1714 + routine/fit.py).

FitVcorEmb minimizes || rho_mf(param) - rho_corr ||_F over the embedding
space.  The whole objective -- assemble V_emb from the parameter vector,
generalized eigh, zero-T occupation, density build, residual -- is one jitted
function; the gradient is the analytic occ-virt first-order perturbation
formula (the reference's slater.py:1092-1230) evaluated on device, batched
over spin.  The outer optimizer is a host CG/BFGS loop driving the jitted
value/grad kernels.
"""

import copy
import numpy as np
import jax
import jax.numpy as jnp
from functools import partial

from libdmet_preview_tpu.utils import logger as log
from libdmet_preview_tpu.utils.misc import Iterable
from libdmet_preview_tpu.ops import embham


# ----------------------------------------------------------------------
# vcor helpers (reference slater.py:758-818)
# ----------------------------------------------------------------------

def addDiag(v, val, idx_range=None):
    rep = v.get()
    spin = rep.shape[0]
    if not isinstance(val, Iterable):
        val = [val] * spin
    if idx_range is None:
        idx_range = getattr(v, "idx_range", list(range(rep.shape[-1])))
    rep = np.array(rep, copy=True)
    for s in range(min(spin, 2)):
        rep[s, idx_range, idx_range] += val[s]
    v.assign(rep)
    return v


def vcor_diag_average(v, idx_range=None):
    rep = v.get()
    if idx_range is None:
        idx_range = getattr(v, "idx_range", list(range(rep.shape[-1])))
    return np.average(rep[:, idx_range, idx_range], axis=1)


def keep_vcor_trace_fixed(v_new, v_old):
    """GSO/Bogoliubov trace fix (reference spinless.py:747): remove the
    mu-absorbable drift -- an EQUAL diagonal shift on va and vb maps to
    -mu_matrix in the combined GSO frame -- by subtracting
    0.5*(avg diag dva - avg diag dvb) from both normal diagonals."""
    dv = np.asarray(v_new.get()) - np.asarray(v_old.get())
    d = 0.5 * (np.average(np.diagonal(dv[0]))
               - np.average(np.diagonal(dv[1])))
    addDiag(v_new, -d)
    return v_new


def make_vcor_trace_unchanged(v_new, v_old, idx_range=None):
    v_mat_old = v_old.get()
    v_mat_new = v_new.get()
    if idx_range is None:
        idx_range = getattr(v_new, "idx_range", list(range(v_mat_new.shape[-1])))
    dv_ave = np.average((v_mat_new - v_mat_old)[:, idx_range, idx_range], axis=1)
    addDiag(v_new, -dv_ave, idx_range=idx_range)
    return v_new


# ----------------------------------------------------------------------
# dV/dparam in the embedding basis
# ----------------------------------------------------------------------

def get_dV_dparam(vcor, basis, basis_k=None, kmesh=None):
    """dV_emb/dparam, dense (nparam, spin, neo, neo).

    basis: (spin, ncells, nlo, neo) R-space (reference slater.py:851-908).
    Non-local vcors transform through k space (requires basis_k, kmesh)."""
    b = jnp.asarray(basis)
    if vcor.islocal():
        grad = jnp.asarray(vcor.gradient()[:, :basis.shape[0]])
        dV = jnp.einsum("sRpi, Pspq, sRqj -> Psij", b, grad, b,
                        optimize=True)
        return np.asarray(dV)
    # non-local: per-param translation-invariant stripes
    from libdmet_preview_tpu.ops import zlinalg
    spin = basis.shape[0]
    gradR = vcor.gradient_R()[:, :spin]      # (P, spin, ncells, n, n)
    P = gradR.shape[0]
    flat = gradR.reshape(P * spin, *gradR.shape[2:])
    g_re, g_im = zlinalg.R2k(flat, tuple(int(x) for x in kmesh))
    g_re = np.asarray(g_re).reshape(P, spin, *gradR.shape[2:])
    g_im = np.asarray(g_im).reshape(P, spin, *gradR.shape[2:])
    b_re, b_im = (jnp.asarray(x) for x in basis_k)
    nk = gradR.shape[2]
    vb_re = jnp.einsum("Pskpq, skqj -> Pskpj", jnp.asarray(g_re), b_re) \
        - jnp.einsum("Pskpq, skqj -> Pskpj", jnp.asarray(g_im), b_im)
    vb_im = jnp.einsum("Pskpq, skqj -> Pskpj", jnp.asarray(g_re), b_im) \
        + jnp.einsum("Pskpq, skqj -> Pskpj", jnp.asarray(g_im), b_re)
    dV = (jnp.einsum("skpi, Pskpj -> Psij", b_re, vb_re)
          + jnp.einsum("skpi, Pskpj -> Psij", b_im, vb_im)) / nk
    return np.asarray(dV)


# ----------------------------------------------------------------------
# jitted objective / gradient kernels
# ----------------------------------------------------------------------

@partial(jax.jit, static_argnames=("nelec", "thr_deg"))
def _fit_rho(param, embH1, dV, ovlp_chol_inv, fit_mask, nelec, thr_deg=1e-3):
    """Return (rho1_masked, ew, ev_orth) for the current parameters.

    Generalized eigenproblem handled by the Cholesky congruence
    L^-1 H L^-H; for orthonormal embedding bases L = I.
    nelec: per-spin occupation tuple (static).
    """
    spin = embH1.shape[0]
    Li = ovlp_chol_inv
    Heff = embH1 + jnp.einsum("P, Psij -> sij", param, dV)
    Horth = jnp.einsum("spq, sqr, skr -> spk", Li, Heff, Li)
    ew, ev = jnp.linalg.eigh(Horth)

    occs = []
    for s in range(spin):
        ne = nelec[s]
        mu = 0.5 * (ew[s, ne - 1] + ew[s, ne])
        below = (ew[s] < mu - thr_deg).astype(embH1.dtype)
        deg = (jnp.abs(ew[s] - mu) <= thr_deg).astype(embH1.dtype)
        nrem = ne - jnp.sum(below)
        frac = jnp.where(jnp.sum(deg) > 0, nrem / jnp.maximum(jnp.sum(deg), 1.0), 0.0)
        occs.append(below + frac * deg)
    ewocc = jnp.stack(occs)
    rho_orth = jnp.einsum("spi, si, sqi -> spq", ev, ewocc, ev)
    # back to the original (non-orthogonal) basis: C = Li^T C'
    rho1 = jnp.einsum("sqp, sqr, srk -> spk", Li, rho_orth, Li)
    rho1_masked = rho1 * fit_mask
    return rho1_masked, ew, ev, ewocc


@partial(jax.jit, static_argnames=("nelec", "thr_deg"))
def _fit_err(param, embH1, dV, ovlp_chol_inv, fit_mask, rho_target, nelec,
             thr_deg=1e-3):
    spin = embH1.shape[0]
    rho1, _, _, _ = _fit_rho(param, embH1, dV, ovlp_chol_inv, fit_mask, nelec,
                             thr_deg)
    drho = rho1 - rho_target
    return jnp.linalg.norm(drho) / jnp.sqrt(1.0 * spin)


@partial(jax.jit, static_argnames=("nelec", "thr_deg"))
def _fit_err_grad(param, embH1, dV, ovlp_chol_inv, fit_mask, rho_target,
                  nelec, thr_deg=1e-3):
    """Analytic zero-T gradient via occ-virt perturbation theory
    (reference slater.py:1092-1155), batched over spin on device."""
    spin = embH1.shape[0]
    neo = embH1.shape[-1]
    rho1, ew, ev, ewocc = _fit_rho(param, embH1, dV, ovlp_chol_inv, fit_mask,
                                   nelec, thr_deg)
    drho = rho1 - rho_target
    val = jnp.linalg.norm(drho)
    val_safe = jnp.maximum(val, 1e-30)

    Li = ovlp_chol_inv
    # chain rule through rho_orig = Li^T rho_orth Li:
    # dw/drho_orth = Li (dw/drho_orig) Li^T
    D = jnp.einsum("spq, sqr, skr -> spk", Li, drho, Li)
    Gs = []
    for s in range(spin):
        ne = nelec[s]
        eocc, evirt = ew[s, :ne], ew[s, ne:]
        Cocc, Cvirt = ev[s][:, :ne], ev[s][:, ne:]
        e_mn = 1.0 / (eocc[None, :] - evirt[:, None])
        temp = (Cvirt.T @ D[s] @ Cocc) * e_mn / (val_safe * jnp.sqrt(1.0 * spin))
        A = Cvirt @ temp @ Cocc.T
        Gs.append(A + A.T)
    G = jnp.stack(Gs)
    # transform back through the congruence: dH_orth = Li dH Li^T
    # => dw/dH = Li^T G_orth Li
    G = jnp.einsum("sqp, sqr, srk -> spk", Li, G, Li)
    grad = jnp.einsum("Psij, sij -> P", dV, G)
    err = val / jnp.sqrt(1.0 * spin)
    return err, grad


# ----------------------------------------------------------------------
# device optimizer: the same Polak-Ribiere CG as minimize_cg below, but as
# ONE traced lax.while_loop program -- the entire vcor fit runs in a single
# device dispatch (no host round trip per objective evaluation)
# ----------------------------------------------------------------------

def _cg_engine(fg, x0, max_iter, ytol, gtol, dx_tol=1e-7):
    """lax.while_loop Polak-Ribiere CG with backtracking-Armijo search.
    fg: traceable x -> (f, grad).  Returns (x, f, max|g|)."""
    from jax import lax
    f0, g0 = fg(x0)
    ytol = jnp.asarray(ytol, x0.dtype)
    gtol = jnp.asarray(gtol, x0.dtype)
    done0 = jnp.max(jnp.abs(g0)) < gtol * 0.1

    def cond(st):
        return (~st[7]) & (st[6] < max_iter)

    def body(st):
        x, f, g, d, step0, n_small, it, _ = st
        dg0 = jnp.dot(g, d)
        d = jnp.where(dg0 >= 0, -g, d)
        dg = jnp.where(dg0 >= 0, -jnp.dot(g, g), dg0)

        def ls_cond(ls):
            return (~ls[3]) & (ls[4] < 30)

        def ls_body(ls):
            alpha, fN, gN, found, j = ls
            f_try, g_try = fg(x + alpha * d)
            ok = f_try <= f + 1e-4 * alpha * dg
            fN = jnp.where(ok, f_try, fN)
            gN = jnp.where(ok, g_try, gN)
            return (jnp.where(ok, alpha, alpha * 0.4), fN, gN,
                    found | ok, j + 1)

        alpha, f_new, g_new, found, _ = lax.while_loop(
            ls_cond, ls_body,
            (step0, f, g, jnp.asarray(False), jnp.asarray(0, jnp.int32)))

        step0_new = jnp.clip(alpha * 2.5, 1e-4, 1.0)
        dx = jnp.max(jnp.abs(alpha * d)) if d.size else jnp.asarray(
            0.0, x.dtype)
        beta_pr = jnp.maximum(0.0, jnp.dot(g_new, g_new - g)
                              / jnp.maximum(jnp.dot(g, g), 1e-30))
        d_new = -g_new + beta_pr * d
        df = f - f_new
        n_small_new = jnp.where(df < ytol, n_small + 1, 0)
        done = (~found) | (n_small_new >= 2) | (dx < dx_tol) \
            | (jnp.max(jnp.abs(g_new)) < gtol * 0.1)
        x_out = jnp.where(found, x + alpha * d, x)
        f_out = jnp.where(found, f_new, f)
        g_out = jnp.where(found, g_new, g)
        d_out = jnp.where(found, d_new, d)
        return (x_out, f_out, g_out, d_out, step0_new, n_small_new,
                it + 1, done)

    st = lax.while_loop(cond, body, (
        x0, f0, g0, -g0, jnp.asarray(1.0, x0.dtype),
        jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32), done0))
    return st[0], st[1], jnp.max(jnp.abs(st[2]))


def _solve_spd(A, b):
    """f64 Cholesky solve of the damped (SPD) LM normal equations."""
    from jax.scipy.linalg import cho_factor, cho_solve
    return cho_solve(cho_factor(A), b)


def _lm_loop(state, p0, spin, max_iter, ytol, gtol, lam0=1e-3):
    """The LM accept/reject loop of the finite-T LM fit engine.
    state: traceable p -> (err, J (P, m), r (m,)) with
    err = sqrt(r.r / spin); grad err = J r / (err spin)."""
    from jax import lax
    P = p0.shape[0]
    eyeP = jnp.eye(P, dtype=p0.dtype)

    err0, J0, r0 = state(p0)
    g0 = (J0 @ r0) / jnp.maximum(err0 * spin, 1e-300)
    done0 = jnp.max(jnp.abs(g0)) < gtol * 0.1

    def cond(st):
        return (~st[7]) & (st[6] < max_iter)

    def body(st):
        p, err, J, r, lam, n_small, it, _ = st
        A = J @ J.T
        Ad = A + lam * jnp.diag(jnp.diag(A)) \
            + (1e-10 * jnp.trace(A) / P + 1e-30) * eyeP
        dp = _solve_spd(Ad, -(J @ r))
        p_try = p + dp
        err_t, J_t, r_t = state(p_try)
        ok = err_t < err
        p_n = jnp.where(ok, p_try, p)
        err_n = jnp.where(ok, err_t, err)
        J_n = jnp.where(ok, J_t, J)
        r_n = jnp.where(ok, r_t, r)
        lam_n = jnp.where(ok, jnp.maximum(lam / 3.0, 1e-12), lam * 8.0)
        df = err - err_n
        n_small_n = jnp.where(df < ytol, n_small + 1, 0)
        g = (J_n @ r_n) / jnp.maximum(err_n * spin, 1e-300)
        done = (n_small_n >= 2) | (jnp.max(jnp.abs(g)) < gtol * 0.1) \
            | (lam_n > 1e8)
        return (p_n, err_n, J_n, r_n, lam_n, n_small_n, it + 1, done)

    st = lax.while_loop(cond, body, (
        p0, err0, J0, r0, jnp.asarray(lam0, p0.dtype),
        jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32), done0))
    p_f, err_f, J_f, r_f = st[0], st[1], st[2], st[3]
    g_f = (J_f @ r_f) / jnp.maximum(err_f * spin, 1e-300)
    return p_f, err_f, jnp.max(jnp.abs(g_f))


@partial(jax.jit, static_argnames=("nelec2", "max_iter", "spin"))
def _fit_lm_finite_t(p0, embH1, dV, Li, mask, target, ytol, gtol,
                     nelec2, beta, max_iter, spin):
    """Finite-T FitVcorEmb objective (overlap-Cholesky rotation Li +
    residual mask, identical to _fit_cg_finite_t) minimized by LM with
    the exact Daleckii-Krein Jacobian.  With W = Li[s]^T V the chain
    rule collapses to batched matmuls shared across all P directions:

      M_P = W^T dV_P W,
      dRho1_P = mask o (W (K o M_P - dmu_P diag f') W^T),
      dmu_P = sum_i f'_i (M_P)_ii / sum_i f'_i          [dN = 0]

    (K the degenerate-safe divided-difference table), so one LM
    iteration costs one eigh per spin, where CG pays 2-3 per step.
    Returns (p, err, max|grad err|) as _cg_engine does."""
    from libdmet_preview_tpu.ops import zlinalg as _zl
    n = embH1.shape[-1]
    P = p0.shape[0]

    def state(p):
        Heff = embH1 + jnp.einsum("P, Psij -> sij", p, dV)
        Horth = jnp.einsum("spq, sqr, skr -> spk", Li, Heff, Li)
        errs = 0.0
        Js, rs = [], []
        for s in range(spin):
            ew, V = _zl.eigh_sym(Horth[s])
            mu = _zl._bisect_mu(ew, 0.5 * nelec2[s], beta)
            occ = _zl._fermi(ew, mu, beta)
            W = Li[s].T @ V
            rho1 = jnp.einsum("pi, i, qi -> pq", W, occ, W)
            d = rho1 * mask[s] - target[s]
            f, K = _zl._fermi_K(ew, mu, beta)
            fp = -beta * f * (1.0 - f)
            denom = jnp.sum(fp)
            safe = jnp.abs(denom) > 1e-300
            inv_den = jnp.where(safe, 1.0 / jnp.where(safe, denom, 1.0),
                                0.0)
            tmp = jnp.einsum("Ppq, qj -> Ppj", dV[:, s], W)
            M = jnp.einsum("pi, Ppj -> Pij", W, tmp)
            dmu = jnp.einsum("Pii, i -> P", M, fp) * inv_den
            core = K[None] * M - dmu[:, None, None] * jnp.diag(fp)[None]
            J = jnp.einsum("pi, Pij, qj -> Ppq", W, core, W) \
                * mask[s][None]
            Js.append(J.reshape(P, n * n))
            rs.append(d.reshape(n * n))
            errs = errs + jnp.sum(d * d)
        err = jnp.sqrt(errs / spin)
        return err, jnp.concatenate(Js, axis=1), jnp.concatenate(rs)

    return _lm_loop(state, p0, spin, max_iter, ytol, gtol)


@partial(jax.jit, static_argnames=("nelec", "thr_deg", "max_iter"))
def _fit_cg_zero_t(p0, embH1, dV, Li, mask, target, ytol, gtol, nelec,
                   thr_deg, max_iter):
    def fg(p):
        return _fit_err_grad(p, embH1, dV, Li, mask, target, nelec=nelec,
                             thr_deg=thr_deg)
    return _cg_engine(fg, p0, max_iter, ytol, gtol)


@partial(jax.jit, static_argnames=("nelec2", "beta", "max_iter", "spin"))
def _fit_cg_finite_t(p0, embH1, dV, Li, mask, target, ytol, gtol, nelec2,
                     beta, max_iter, spin):
    from libdmet_preview_tpu.ops.zlinalg import rho_fermi_real

    def err(p):
        Heff = embH1 + jnp.einsum("P, Psij -> sij", p, dV)
        Horth = jnp.einsum("spq, sqr, skr -> spk", Li, Heff, Li)
        errs = 0.0
        for s in range(spin):
            r_re, _ = rho_fermi_real(Horth[s], nelec2[s], beta)
            rho1 = jnp.einsum("qp, qr, rk -> pk", Li[s], r_re,
                              Li[s]) * mask[s]
            errs = errs + jnp.sum((rho1 - target[s]) ** 2)
        return jnp.sqrt(errs / spin)

    fg = jax.value_and_grad(err)
    return _cg_engine(fg, p0, max_iter, ytol, gtol)


# ----------------------------------------------------------------------
# host optimizer: CG with ytol/gtol stopping (reference fit.py semantics)
# ----------------------------------------------------------------------

def minimize_cg(fun_grad, x0, max_iter=300, ytol=1e-7, gtol=1e-3, dx_tol=1e-7):
    """Polak-Ribiere CG with backtracking-Armijo line search."""
    x = np.asarray(x0, dtype=float).copy()
    f, g = fun_grad(x)
    d = -g
    n_small = 0
    step0 = 1.0
    for it in range(max_iter):
        gnorm = np.max(np.abs(g))
        if gnorm < gtol * 0.1:
            break
        # line search
        dg = np.dot(g, d)
        if dg >= 0:
            d = -g
            dg = -np.dot(g, g)
        alpha = step0
        f_new, g_new = None, None
        for _ in range(30):
            x_new = x + alpha * d
            f_try, g_try = fun_grad(x_new)
            if f_try <= f + 1e-4 * alpha * dg:
                f_new, g_new = f_try, g_try
                break
            alpha *= 0.4
        if f_new is None:
            break
        step0 = min(max(alpha * 2.5, 1e-4), 1.0)
        dx = np.max(np.abs(alpha * d)) if d.size else 0.0
        beta = max(0.0, np.dot(g_new, g_new - g) / max(np.dot(g, g), 1e-30))
        d = -g_new + beta * d
        df = f - f_new
        x, f, g = x_new, f_new, g_new
        if df < ytol:
            n_small += 1
            if n_small >= 2:
                break
        else:
            n_small = 0
        if dx < dx_tol:
            break
    return x, f, np.max(np.abs(g))


def get_active_projector(act_idx, rdm1, tol=1e-9):
    """Active-space projector from selected LOs (reference
    slater.py:2121-2194 get_active_projector, orthonormal-LO supercell
    form): span of the occupied and virtual components of the chosen
    columns,

      P_occ = rho[:, act],  P_virt = (I - rho)[:, act],

    each orthonormalized after dropping singular directions.

    act_idx: LO indices; rdm1: (spin, nsites, nsites) real supercell LO
    density in the repo's PER-SPIN convention (restricted occupations
    <= 1, as returned by mfd.HF — the reference's spin-traced input is
    halved there; here no scaling is applied).
    Returns (P (spin, nsites, nact'), nocc (spin,)) with nocc the number
    of occupied-derived columns per spin."""
    act_idx = np.asarray(act_idx, dtype=int)
    rdm1 = np.asarray(rdm1)
    if rdm1.ndim == 2:
        rdm1 = rdm1[None]
    spin = rdm1.shape[0]
    nsites = rdm1.shape[-1]
    Ps, nocc = [], []
    for s in range(spin):
        r = rdm1[s]
        cols = []
        for block in (r[:, act_idx], (np.eye(nsites) - r)[:, act_idx]):
            g = block.T @ block
            ew, ev = np.linalg.eigh(g)
            keep = ew > tol
            X = block @ ev[:, keep]
            if X.shape[-1]:
                # Lowdin orthonormalization
                gs = X.T @ X
                w, V = np.linalg.eigh(gs)
                X = X @ (V / np.sqrt(w)) @ V.T
            cols.append(X)
        Ps.append(np.hstack(cols))
        nocc.append(cols[0].shape[-1])
    return np.asarray(Ps), np.asarray(nocc, dtype=int)


def make_rdm1_P(fock, vcor_mat, P, nocc, project_back=True):
    """Mean-field density of the ACTIVE-projected problem P^T (F + u) P
    (reference slater.py:2226-2300 make_rdm1_P, supercell form).

    fock: (spin, nsites, nsites); vcor_mat: (spin, nsites, nsites) or
    None; P: (spin, nsites, nact); nocc: per-spin occupation counts.
    Returns the PER-SPIN rdm1 (repo convention, matching mfd.HF),
    projected back to the full LO space when project_back."""
    fock = np.asarray(fock)
    if fock.ndim == 2:
        fock = fock[None]
    spin = fock.shape[0]
    out = []
    for s in range(spin):
        F = fock[s]
        if vcor_mat is not None:
            F = F + np.asarray(vcor_mat)[s]
        Fa = P[s].T @ F @ P[s]
        ew, ev = np.linalg.eigh(Fa)
        C = ev[:, :int(nocc[s])]
        r = C @ C.T
        if project_back:
            r = P[s] @ r @ P[s].T
        out.append(r)
    return np.asarray(out)


def get_active_projector_full(P):
    """Full-space projection operator P P^T per spin (orthonormal LOs;
    reference slater.py:2195-2225)."""
    P = np.asarray(P)
    return np.einsum("spi, sqi -> spq", P, P)


def FitVcorEmb(rho, lattice, basis, vcor, beta, MaxIter=300, imp_fit=False,
               imp_idx=None, det=False, det_idx=None, CG_check=False,
               BFGS=False, **kwargs):
    """Fit vcor in the fixed embedding basis (reference slater.py:909-1330).

    Returns (vcor, err_begin, err_end)."""
    param_begin = vcor.param.copy()
    basis = np.asarray(basis)
    spin = basis.shape[0]
    neo = basis.shape[-1]
    basis_k = lattice.R2k_basis(basis)

    nelec = kwargs.get("nelec", None)
    if nelec is None:
        ne = lattice.ncore + lattice.nval
        nelec = (ne,) * spin
    elif not isinstance(nelec, Iterable):
        nelec = (int(nelec),) * spin
    else:
        nelec = tuple(int(x) for x in nelec)
    thr_deg = float(kwargs.get("tol_deg", 1e-3))

    if lattice.use_hcore_as_emb_ham:
        fock_k = lattice.getH1(kspace=True)
    else:
        fock_k = lattice.getFock(kspace=True)
    ovlp_k = lattice.get_ovlp(kspace=True)

    embH1 = np.asarray(embham.transform_h1(fock_k, basis_k))
    vcor_mat = kwargs.get("vcor_mat", None)
    if vcor_mat is not None:
        embH1 = embH1 + np.asarray(vcor_mat)
    ovlp_emb = np.asarray(embham.transform_h1(ovlp_k, basis_k))

    # Cholesky factor of the embedding overlap (identity for orthonormal LOs)
    Li = np.empty_like(ovlp_emb)
    for s in range(spin):
        L = np.linalg.cholesky(ovlp_emb[s])
        Li[s] = np.linalg.inv(L)

    P_act = kwargs.get("P_act", None)
    if P_act is not None:
        # restrict the vcor response to the active subspace: project the
        # embedding basis by P P^T before building dV/dparam (reference
        # slater.py:881 C_lo_eo = multiply_basis(P_act, basis_k))
        P_full = get_active_projector_full(np.asarray(P_act))
        if P_full.shape[0] == 1 and spin == 2:
            P_full = np.broadcast_to(P_full, (2,) + P_full.shape[1:])
        ncells, nlo = basis.shape[1], basis.shape[2]
        bP = np.stack([
            (P_full[s] @ basis[s].reshape(ncells * nlo, neo)
             ).reshape(ncells, nlo, neo) for s in range(spin)])
        dV = get_dV_dparam(vcor, bP, basis_k=lattice.R2k_basis(bP),
                           kmesh=lattice.kmesh)
    else:
        dV = get_dV_dparam(vcor, basis, basis_k=basis_k,
                           kmesh=lattice.kmesh)

    # fit index mask (imp_fit / det options; reference slater.py:986-1018)
    if imp_fit:
        imp_idx, det_idx = list(range(lattice.nimp)), []
    elif det:
        imp_idx, det_idx = [], list(range(lattice.nimp))
    elif imp_idx is None:
        if det_idx is None:
            imp_idx, det_idx = list(range(neo)), []
        else:
            imp_idx = []
    elif det_idx is None:
        det_idx = []
    mask = np.zeros((spin, neo, neo))
    ii = np.asarray(imp_idx, dtype=int)
    if ii.size:
        mask[np.ix_(range(spin), ii, ii)] = 1.0
    dd = np.asarray(det_idx, dtype=int)
    if dd.size:
        mask[:, dd, dd] = 1.0

    rho = np.asarray(rho)
    if kwargs.get("idem_fit", False):
        # fit against the idempotent part of the correlated rdm1:
        # occupy its natural orbitals with assignocc (reference
        # slater.py:975-978 / slater_helper.py:380 get_rdm1_idem)
        from libdmet_preview_tpu.ops import mfd
        rho_idem = np.empty_like(rho)
        for s in range(spin):
            ew, ev = np.linalg.eigh(rho[s])
            ew, ev = -ew[::-1], ev[:, ::-1]
            ewocc, _, _ = mfd.assignocc(ew, int(nelec[s]), beta, mu0=-0.5)
            rho_idem[s] = (ev * ewocc) @ ev.T
        rho = rho_idem
    rho_target = rho * mask

    args = (jnp.asarray(embH1), jnp.asarray(dV), jnp.asarray(Li),
            jnp.asarray(mask), jnp.asarray(rho_target))

    if beta == np.inf and kwargs.get("C_act", None) is not None:
        # zero-T active-space fit: the closed-form occ-virt rotation
        # gradient of _fit_err_grad has no projected-residual variant;
        # a large effective beta through the degenerate-safe Fermi op is
        # exact for any gapped embedding spectrum (occupations within
        # ~exp(-beta*gap) of the step function).
        beta = 1e6
    if beta < np.inf:
        # finite temperature: differentiate straight through the
        # degenerate-safe Fermi-density op (zlinalg.zrho_fermi custom JVP
        # == reference ftsystem.get_rho_grad analytic machinery)
        from libdmet_preview_tpu.ops.zlinalg import rho_fermi_real
        embH1_j = jnp.asarray(embH1)
        dV_j = jnp.asarray(dV)
        mask_j = jnp.asarray(mask)
        target_j = jnp.asarray(rho_target)
        Li_j = jnp.asarray(Li)
        nelec2 = tuple(2 * int(x) for x in nelec)  # doubled spectrum

        C_act = kwargs.get("C_act", None)
        if C_act is not None:
            # active-space residual: || C^T (rho1 - rho) C || over the
            # active embedding columns (reference slater.py:1083-1088)
            C_act = np.asarray(C_act)
            if C_act.ndim == 2:
                C_act = C_act[None]
            if C_act.shape[0] == 1 and spin == 2:
                C_act = np.broadcast_to(C_act, (2,) + C_act.shape[1:])
            C_j = jnp.asarray(C_act)
            tgt_act = jnp.einsum("spi, spq, sqj -> sij", C_j,
                                 jnp.asarray(rho), C_j)

        def err_ft(p):
            Heff = embH1_j + jnp.einsum("P, Psij -> sij", p, dV_j)
            Horth = jnp.einsum("spq, sqr, skr -> spk", Li_j, Heff, Li_j)
            errs = 0.0
            for s in range(spin):
                r_re, _ = rho_fermi_real(Horth[s], nelec2[s], float(beta))
                rho1 = jnp.einsum("qp, qr, rk -> pk", Li_j[s], r_re,
                                  Li_j[s])
                if C_act is not None:
                    d = C_j[s].T @ rho1 @ C_j[s] - tgt_act[s]
                else:
                    d = rho1 * mask_j[s] - target_j[s]
                errs = errs + jnp.sum(d ** 2)
            return jnp.sqrt(errs / spin)

        err_vg = jax.jit(jax.value_and_grad(err_ft))

        def fun_grad(p):
            e, g = err_vg(jnp.asarray(p))
            return float(e), np.asarray(g)
    else:
        def fun_grad(p):
            e, g = _fit_err_grad(jnp.asarray(p), *args, nelec=nelec,
                                 thr_deg=thr_deg)
            return float(e), np.asarray(g)

    err_begin = fun_grad(vcor.param)[0]
    if kwargs.get("test_grad", False):
        _test_grad(vcor.param, fun_grad)

    method = kwargs.get("method", "CG").upper()
    ytol = kwargs.get("ytol", 1e-7)
    gtol = kwargs.get("gtol", 1e-3)
    if method in ("CG", "LM") and kwargs.get("C_act", None) is not None:
        # the fused lax.while_loop CG engine bakes in the mask residual;
        # active-space residuals go through the host-driven CG instead
        x, err_end, gnorm = minimize_cg(fun_grad, vcor.param,
                                        max_iter=MaxIter, ytol=ytol,
                                        gtol=gtol)
        x, err_end, gnorm = np.asarray(x), float(err_end), float(gnorm)
    elif method in ("CG", "LM"):
        # whole fit in ONE device dispatch (lax.while_loop engine).
        # Finite-T engines: Polak-Ribiere CG (default), or with
        # method="LM" Levenberg-Marquardt with the shared-eigh
        # Daleckii-Krein Jacobian (see _fit_lm_finite_t).
        p0 = jnp.asarray(vcor.param)
        if beta < np.inf:
            use_lm = method == "LM"
            if use_lm:
                x, err_end, gnorm = _fit_lm_finite_t(
                    p0, embH1_j, dV_j, Li_j, mask_j, target_j, ytol,
                    gtol, nelec2, float(beta), int(MaxIter), spin)
            else:
                x, err_end, gnorm = _fit_cg_finite_t(
                    p0, embH1_j, dV_j, Li_j, mask_j, target_j, ytol,
                    gtol, nelec2, float(beta), int(MaxIter), spin)
        else:
            x, err_end, gnorm = _fit_cg_zero_t(
                p0, jnp.asarray(embH1), jnp.asarray(dV), jnp.asarray(Li),
                jnp.asarray(mask), jnp.asarray(rho_target), ytol, gtol,
                nelec, thr_deg, int(MaxIter))
        x, err_end, gnorm = np.asarray(x), float(err_end), float(gnorm)
    else:
        x, err_end = minimize(fun_grad, vcor.param, method=method,
                              max_iter=MaxIter)
        gnorm = float(np.max(np.abs(fun_grad(x)[1])))

    if CG_check or BFGS or gnorm > 1e-3:
        from scipy import optimize as opt
        res = opt.minimize(lambda p: fun_grad(p)[0], x,
                           jac=lambda p: fun_grad(p)[1],
                           method="BFGS" if BFGS else "CG",
                           options={"maxiter": min(len(x) * 10, MaxIter),
                                    "gtol": max(gnorm * 0.1, 5e-5)})
        if res.fun < err_end:
            x, err_end = res.x, float(res.fun)

    vcor.update(x)
    log.info("FitVcorEmb: err %20.12f -> %20.12f (|g|=%.2e)",
             err_begin, err_end, gnorm)
    return vcor, err_begin, err_end


def _test_grad(param0, fun_grad, dx=1e-5):
    f0, g_ana = fun_grad(param0)
    g_num = np.zeros_like(g_ana)
    for i in range(len(param0)):
        p1 = param0.copy()
        p1[i] += dx
        p2 = param0.copy()
        p2[i] -= dx
        g_num[i] = (fun_grad(p1)[0] - fun_grad(p2)[0]) / (2 * dx)
    log.info("grad check: max |ana - num| = %.3e",
             np.abs(g_ana - g_num).max())
    return g_ana, g_num


def FitVcorFull(rho, lattice, basis, vcor, beta, filling, MaxIter=20,
                imp_fit=False, **kwargs):
    """Whole-lattice fit stage (reference slater.py:1352-1683): re-solve the
    lattice mean field at each step and match the folded rdm1.
    imp_fit restricts the residual to the impurity block (reference
    slater.py:1454-1470 fit index handling)."""
    from libdmet_preview_tpu.ops import mfd

    basis = np.asarray(basis)
    spin = basis.shape[0]
    neo = basis.shape[-1]
    basis_k = lattice.R2k_basis(basis)
    rho_target = np.asarray(rho)
    restricted = (spin == 1)
    mask = np.ones((spin, neo, neo))
    if imp_fit:
        mask[:] = 0.0
        ii = np.arange(lattice.nimp)
        mask[np.ix_(range(spin), ii, ii)] = 1.0
        rho_target = rho_target * mask

    if beta < np.inf and vcor.islocal():
        # gradient path: the WHOLE cost -- lattice Fock + vcor, one
        # global-mu Fermi density over (spin x k) via the zrho_fermi
        # custom-vjp op, embedding fold, masked residual -- is a single
        # jitted value_and_grad program (replaces the reference's
        # hand-derived full-fit gradient, slater.py:1456-1640)
        from libdmet_preview_tpu.ops.zlinalg import zrho_fermi
        from libdmet_preview_tpu.ops.mfd import check_nelec
        from libdmet_preview_tpu.utils.misc import add_spin_dim

        Fock_k = lattice.getFock(kspace=True)
        f_re, f_im = np.asarray(Fock_k[0]), np.asarray(Fock_k[1])
        if f_re.ndim == 3:
            f_re, f_im = f_re[None], f_im[None]
        f_re = add_spin_dim(f_re, spin, non_spin_dim=3)
        f_im = add_spin_dim(f_im, spin, non_spin_dim=3)
        nk, nlo = f_re.shape[1], f_re.shape[-1]
        # single mu across spin channels and k (mfd.HF convention for
        # scalar filling); electron count on the DOUBLED spectrum
        nelec2 = check_nelec(spin * nk * 2 * nlo * float(filling))[0]
        grad_tab = jnp.asarray(np.asarray(vcor.gradient())[:, :spin])
        fr_j, fi_j = jnp.asarray(f_re), jnp.asarray(f_im)
        br_j, bi_j = (jnp.asarray(x) for x in basis_k)
        mask_j = jnp.asarray(mask)
        tgt_j = jnp.asarray(rho_target)

        def err_full(p):
            F_re = fr_j + jnp.einsum("P, Psij -> sij", p,
                                     grad_tab)[:, None]
            r_re, r_im, _ = zrho_fermi(
                F_re.reshape(spin * nk, nlo, nlo),
                fi_j.reshape(spin * nk, nlo, nlo), nelec2, float(beta))
            rk = (r_re.reshape(spin, nk, nlo, nlo),
                  r_im.reshape(spin, nk, nlo, nlo))
            remb = embham._trans_inv_k_pair(br_j, bi_j, rk[0], rk[1])
            d = remb * mask_j - tgt_j
            return jnp.linalg.norm(d) / jnp.sqrt(1.0 * spin)

        err_vg = jax.jit(jax.value_and_grad(err_full))

        def fun_grad(p):
            e, g = err_vg(jnp.asarray(p))
            return float(e), np.asarray(g)

        p0 = vcor.param.copy()
        err_begin = fun_grad(p0)[0]
        x, err_end, gnorm = minimize_cg(fun_grad, p0, max_iter=MaxIter,
                                        ytol=kwargs.get("ytol", 1e-8),
                                        gtol=kwargs.get("gtol", 1e-4))
        if kwargs.get("CG_check", False) or kwargs.get("BFGS", False) \
                or gnorm > 1e-3:
            from scipy import optimize as opt
            r = opt.minimize(lambda p: fun_grad(p)[0], x,
                             jac=lambda p: fun_grad(p)[1],
                             method="BFGS" if kwargs.get("BFGS") else "CG",
                             options={"maxiter": MaxIter,
                                      "gtol": max(gnorm * 0.1, 5e-5)})
            if r.fun < err_end:
                x, err_end = r.x, float(r.fun)
        vcor.update(np.asarray(x))
        return vcor, err_begin, float(err_end)

    def cost(p):
        vcor.update(p)
        rhoT, mu, _, res = mfd.HF(lattice, vcor, filling, restricted,
                                  beta=beta, ires=True)
        rho1 = np.asarray(embham.foldRho_k(res["rho_k"], basis_k)) * mask
        return float(np.linalg.norm(rho1 - rho_target) / np.sqrt(spin))

    from scipy import optimize as opt
    p0 = vcor.param.copy()
    err_begin = cost(p0)
    res = opt.minimize(cost, p0, method="Powell",
                       options={"maxiter": MaxIter, "xtol": 1e-7})
    if res.fun <= err_begin:
        vcor.update(res.x)
        return vcor, err_begin, float(res.fun)
    vcor.update(p0)
    return vcor, err_begin, err_begin


def FitVcorTwoStep(rho, lattice, basis, vcor, beta, filling, MaxIter1=300,
                   MaxIter2=0, **kwargs):
    """Two-step fit wrapper (reference slater.py:1684-1714)."""
    vcor_new = copy.deepcopy(vcor)
    err_begin = err_end = None
    if MaxIter1 > 0:
        vcor_new, err_begin, err_end = FitVcorEmb(rho, lattice, basis,
                                                  vcor_new, beta,
                                                  MaxIter=MaxIter1, **kwargs)
    if MaxIter2 > 0:
        vcor_new, err_begin2, err_end = FitVcorFull(rho, lattice, basis,
                                                    vcor_new, beta, filling,
                                                    MaxIter=MaxIter2, **kwargs)
        if err_begin is None:
            err_begin = err_begin2
    log.result("residue (begin) = %20.12f", err_begin)
    log.result("residue (end)   = %20.12f", err_end)
    return vcor_new, err_end


def cvx_frac(mo_coeff, rho_target, nelec, tol=1e-10):
    """Convex fractional-occupation fit (reference fit.py:362-460 cvx_frac
    role, solved in closed form instead of via CVXPY).

    Find occupations 0 <= w <= 1 (per spin channel convention of the
    caller) with sum(w) = nelec minimizing || C diag(w) C^T - rho ||_F.
    For orthonormal C the objective separates and the optimum is the
    Euclidean projection of d = diag(C^T rho C) onto the capped simplex:
    w = clip(d + lam, 0, 1) with lam fixed by the trace -- a scalar
    bisection, no SDP solver needed."""
    C = np.asarray(mo_coeff)
    d = np.diag(C.T @ np.asarray(rho_target) @ C).copy()
    n = d.size
    assert 0.0 <= nelec <= n + 1e-9

    def trace(lam):
        return float(np.clip(d + lam, 0.0, 1.0).sum())

    lo, hi = -1.0 - d.max(), 1.0 - d.min() + 1.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if trace(mid) < nelec:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol:
            break
    w = np.clip(d + 0.5 * (lo + hi), 0.0, 1.0)
    return w


def minimize(fun_grad, x0, method="CG", max_iter=300, **kwargs):
    """Optimizer dispatcher (reference fit.py:17-40 minimize): 'CG' uses
    the in-repo jitted-kernel CG (minimize_cg); 'BFGS'/'trust-ncg'/'SD'
    map to scipy / plain steepest descent.  fun_grad(x) -> (f, grad)."""
    import numpy as np
    method = method.upper()
    if method == "CG":
        x, f, _ = minimize_cg(fun_grad, x0, max_iter=max_iter, **kwargs)
        return x, f
    if method in ("BFGS", "TRUST-NCG", "TRUSTNCG"):
        from scipy import optimize as opt
        name = "BFGS" if method == "BFGS" else "trust-ncg"
        extra = {}
        if name == "trust-ncg":
            # scipy requires a hessp for trust-ncg: finite-difference on
            # the gradient
            def hessp(x, p):
                eps = 1e-6
                g1 = fun_grad(np.asarray(x) + eps * np.asarray(p))[1]
                g0 = fun_grad(np.asarray(x))[1]
                return (np.asarray(g1) - np.asarray(g0)) / eps
            extra["hessp"] = hessp
        options = {"maxiter": max_iter}
        if "gtol" in kwargs:
            options["gtol"] = kwargs["gtol"]
        res = opt.minimize(lambda x: [np.asarray(v) for v in fun_grad(x)][0],
                           np.asarray(x0), jac=lambda x: np.asarray(
                               fun_grad(x)[1]),
                           method=name, options=options,
                           **extra)
        return np.asarray(res.x), float(res.fun)
    if method in ("AH", "NEWTON", "NEWTON-CG"):
        # device second-order minimizer (the reference's CIAH
        # augmented-Hessian role, fit_helper.py:678-969): trust-region
        # Newton steps with Hessian-VECTOR products only.  When
        # `hvp` is provided (e.g. jax.jvp through the gradient) it is
        # used directly; otherwise forward differences on fun_grad.
        hvp = kwargs.get("hvp", None)
        x = np.array(x0, dtype=float)
        tr = kwargs.get("trust_radius", 0.5)
        ytol = kwargs.get("ytol", 1e-10)
        f, g = fun_grad(x)
        f = float(f)
        for _ in range(max_iter):
            gn = np.asarray(g)
            if np.max(np.abs(gn)) < kwargs.get("gtol", 1e-6):
                break

            if hvp is None:
                def hv(p, _x=x, _g=gn):
                    eps = 1e-6 / max(np.linalg.norm(p), 1e-30)
                    g1 = np.asarray(fun_grad(_x + eps * p)[1])
                    return (g1 - _g) / eps
            else:
                def hv(p, _x=x):
                    return np.asarray(hvp(_x, p))

            # truncated CG (Steihaug): solve H d = -g within the radius
            d = np.zeros_like(x)
            r = gn.copy()
            p = -r
            rs = float(r @ r)
            for _ in range(min(len(x), 50)):
                Hp = hv(p)
                pHp = float(p @ Hp)
                if pHp <= 1e-14 * float(p @ p):
                    # negative curvature: walk to the boundary
                    a_bnd = (tr - np.linalg.norm(d)) \
                        / max(np.linalg.norm(p), 1e-30)
                    d = d + a_bnd * p
                    break
                alpha = rs / pHp
                d_new = d + alpha * p
                if np.linalg.norm(d_new) > tr:
                    a_bnd = (tr - np.linalg.norm(d)) \
                        / max(np.linalg.norm(p), 1e-30)
                    d = d + a_bnd * p
                    break
                d = d_new
                r = r + alpha * Hp
                rs_new = float(r @ r)
                if rs_new < 1e-18:
                    break
                p = -r + (rs_new / rs) * p
                rs = rs_new

            f_new, g_new = fun_grad(x + d)
            f_new = float(f_new)
            pred = -float(gn @ d) - 0.5 * float(d @ hv(d))
            rho = (f - f_new) / max(pred, 1e-30)
            if f_new < f:
                x = x + d
                df = f - f_new
                f, g = f_new, g_new
                if rho > 0.75 and np.linalg.norm(d) > 0.8 * tr:
                    tr = min(tr * 2.0, 10.0)
                if df < ytol:
                    break
            else:
                tr *= 0.25
                if tr < 1e-10:
                    break
        return x, float(f)
    if method == "SD":
        x = np.array(x0, dtype=float)
        step = kwargs.get("step", 0.1)
        f_old = None
        for _ in range(max_iter):
            f, g = fun_grad(x)
            f = float(f)
            if f_old is not None and abs(f - f_old) < kwargs.get(
                    "ytol", 1e-9):
                break
            x = x - step * np.asarray(g)
            f_old = f
        f, _ = fun_grad(x)
        return x, float(f)
    raise ValueError("unknown method %s" % method)
