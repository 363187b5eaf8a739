"""
Fused single-program DMET lattice iteration (the hot path of
SURVEY 3.3: lattice mean field -> Schmidt bath -> embedding transform ->
vcor fit, reference routine/mfd.py:235 + slater.py:117-220 + slater.py:909).

The facade path (ops.mfd.HF -> ops.embham.embBasis -> ops.fit.FitVcorEmb)
orchestrates these stages from the host; every stage boundary costs a
host<->device round trip and a handful of small dispatches.  This module
compiles the WHOLE lattice-side iteration into one XLA program:

  * mean field on the time-reversal-irreducible half mesh via the
    weighted degenerate-safe Fermi-density op (zlinalg.zrho_fermi_w),
  * Gram-eigh Schmidt bath (one GEMM + a tiny eigh instead of a tall SVD),
  * embedding H1 / dV transforms as batched einsums,
  * the vcor fit in the fixed embedding basis as the SAME device
    Polak-Ribiere CG used by ops.fit.FitVcorEmb (ops.fit._cg_engine),

so one DMET lattice iteration = one dispatch, and iterations can be
chained with lax.scan (see chain_iterations) to amortize the fetch.

Scope: model lattices with orthonormal LOs and a LOCAL vcor (the flagship
Hubbard-family workloads); restricted or unrestricted.  Finite beta
(use ~1e3+ for an effectively zero-T gapped system).
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from libdmet_preview_tpu.ops import zlinalg
from libdmet_preview_tpu.ops.eri_transform import eri_from_factors
from libdmet_preview_tpu.ops.fit import _cg_engine
from libdmet_preview_tpu.ops.zlinalg import rho_fermi_real, zrho_fermi_w


def make_dmet_iteration(lattice, vcor, filling, beta=1000.0,
                        fit_max_iter=20, ytol=1e-7, gtol=1e-3,
                        chol_L=None):
    """Build the fused lattice-iteration program for `lattice` + `vcor`.

    Returns (step_fn, params0) where

      step_fn(vparam, rho_target) ->
          (vparam_new, fit_err, embH1, rho_R, basis)

    runs one jit-compiled program (chain_iterations composes its traced
    body under lax.scan).  vparam is the vcor parameter vector;
    rho_target is the correlated embedding 1-RDM to fit, (spin, neo, neo).

    chol_L: optional (naux, nsites, nsites) Cholesky/GDF factors of the
    supercell ERI, each symmetric in (pq).  When given (restricted path), the EMBEDDING-ERI
    TRANSFORM eri_emb = sum_x (B^T L_x B) (x) (B^T L_x B) runs inside
    the fused program once per iteration -- the reference's hot ab
    initio kernel (SURVEY 3.4, eri_transform.py:436-522) timed together
    with bath + fit; step_fn then returns
    (vparam_new, fit_err, embH1, rho_R, basis, eri_emb).  The factors
    are placed on the device once and passed to the compiled program as
    an argument, never baked into it as a constant."""
    # same operator convention as ops.mfd.HF / ops.fit.FitVcorEmb
    if lattice.use_hcore_as_emb_ham:
        fock_k = lattice.getH1(kspace=True)
    else:
        fock_k = lattice.getFock(kspace=True)
    f_re = np.asarray(fock_k[0])
    f_im = np.asarray(fock_k[1])
    if f_re.ndim == 3:
        f_re, f_im = f_re[None], f_im[None]
    spin = 1 if vcor.restricted else 2
    if f_re.shape[0] == 1 and spin == 2:
        f_re = np.broadcast_to(f_re, (2,) + f_re.shape[1:])
        f_im = np.broadcast_to(f_im, (2,) + f_im.shape[1:])
    nk = f_re.shape[1]
    nlo = f_re.shape[-1]
    ncells = lattice.ncells
    assert nk == ncells

    ovlp = np.asarray(lattice.get_ovlp(kspace=False))
    assert np.allclose(ovlp[0], np.eye(nlo), atol=1e-12) and \
        np.max(np.abs(ovlp[1:])) < 1e-12, \
        "fastpath assumes orthonormal LOs"
    assert vcor.islocal(), "fastpath assumes a local vcor"

    # time-reversal irreducible half mesh + weights (reference
    # get_weights_t_reversal, eri_transform.py:142)
    neg = lattice._neg_map
    ibz = np.asarray([k for k in range(nk) if k <= neg[k]])
    wk = np.asarray([1.0 if neg[k] == k else 2.0 for k in ibz])
    tr_ok = (np.allclose(f_re[:, neg], f_re, atol=1e-10)
             and np.allclose(f_im[:, neg], -f_im, atol=1e-10))
    if not tr_ok:
        ibz = np.arange(nk)
        wk = np.ones(nk)

    cos_t, sin_t = zlinalg.dft_tables(tuple(int(x) for x in lattice.kmesh))
    cos_i = jnp.asarray(cos_t[ibz] * wk[:, None])
    sin_i = jnp.asarray(sin_t[ibz] * wk[:, None])
    cosT_i = jnp.asarray(cos_t.T[ibz])       # rows of the k <- R transform
    sinT_i = jnp.asarray(sin_t.T[ibz])
    f_re_i = jnp.asarray(f_re[:, ibz])
    f_im_i = jnp.asarray(f_im[:, ibz])
    wk_j = jnp.asarray(wk)

    imp_idx = np.asarray(lattice.imp_idx, dtype=int)
    val_idx = np.asarray(lattice.val_idx, dtype=int) \
        if getattr(lattice, "val_idx", None) is not None else imp_idx
    nimp = len(imp_idx)
    nval = len(val_idx)
    neo = nimp + nval
    env_idx = np.asarray([i for i in range(nk * nlo)
                          if i not in set(val_idx)], dtype=int)
    env_j = jnp.asarray(env_idx)

    # occupations on the DOUBLED spectrum (ops/zlinalg.zeigh convention),
    # per spin channel; the mu search runs over all channels jointly
    nelec2_lat = float(2 * nk * nlo * filling)
    ne_emb = lattice.ncore + lattice.nval
    nelec2_emb = 2 * int(ne_emb)
    beta = float(beta)

    dv = jnp.asarray(np.asarray(vcor.gradient())[:, :spin])  # (P,s,n,n)
    params0 = np.asarray(vcor.param, dtype=float)
    # the DF factors ride as a CALL argument: a closed-over constant of
    # this size (764 MB at naux=512 over 432 sites) would be embedded in
    # the executable and in its compile-cache key
    operands = () if chol_L is None else (jax.device_put(np.asarray(chol_L)),)

    def mean_field(vparam):
        vmat = jnp.einsum("P, Psij -> sij", vparam, dv)
        h_re = f_re_i + vmat[:, None]
        r_re, r_im, mu = zrho_fermi_w(h_re, f_im_i, spin * nelec2_lat,
                                      beta, wk_j)
        return h_re, r_re, r_im, mu

    def step(vparam, rho_target, L=None):
        h_re, r_re, r_im, mu = mean_field(vparam)
        # rho_R stripe fold over the weighted IBZ (exact under TR symm)
        rho_R = (jnp.einsum("kR, skpq -> sRpq", cos_i, r_re)
                 - jnp.einsum("kR, skpq -> sRpq", sin_i, r_im)) / nk

        # Gram-eigh Schmidt bath at FIXED basis for the fit.  Each
        # eigenvector's sign is fixed (largest component positive): the
        # fit target rho_target is given in this basis, so the basis must
        # be a function of the density alone, whichever eigensolver runs.
        # This fixes the gauge only for a nondegenerate Gram spectrum
        # whose eigenvectors have one largest component; a degenerate
        # block stays an arbitrary rotation (and an exact tie in |V| an
        # arbitrary sign), so there the target must be given in the basis
        # this step returns
        flat = lax.stop_gradient(rho_R).reshape(spin, nk * nlo, nlo)
        env = flat[:, env_j][:, :, val_idx]
        G = jnp.einsum("spi, spj -> sij", env, env)
        w, V = jnp.linalg.eigh(G)
        big = jnp.argmax(jnp.abs(V), axis=-2)[..., None, :]
        V = V * jnp.sign(jnp.take_along_axis(V, big, axis=-2))
        w = jnp.maximum(w, 1e-14 * jnp.max(w, axis=-1, keepdims=True))
        u = jnp.einsum("spi, sij -> spj", env, V) / jnp.sqrt(w)[:, None, :]
        eye_b = jnp.eye(u.shape[-1], dtype=u.dtype)
        for _ in range(2):      # Newton-Schulz orthonormality cleanup
            g2 = jnp.einsum("spi, spj -> sij", u, u)
            u = u @ (1.5 * eye_b - 0.5 * g2)
        basis = jnp.zeros((spin, nk * nlo, neo), f_re_i.dtype)
        basis = basis.at[:, imp_idx, :nimp].set(jnp.eye(nimp))
        basis = basis.at[:, env_j, nimp:].set(u)

        # embedding transforms on the IBZ
        bR = basis.reshape(spin, nk, nlo, neo)
        # b(k) = sum_R e^{-ikR} b_R -- the library R2k_basis convention
        b_re = jnp.einsum("kR, sRpj -> skpj", cosT_i, bR)
        b_im = -jnp.einsum("kR, sRpj -> skpj", sinT_i, bR)
        # BARE fock transform (FitVcorEmb semantics, reference
        # slater.py:1036: the vcor enters only through p * dV during
        # the fit, starting from the current parameters)
        hb_re = jnp.einsum("skpq, skqj -> skpj", f_re_i, b_re) \
            - jnp.einsum("skpq, skqj -> skpj", f_im_i, b_im)
        hb_im = jnp.einsum("skpq, skqj -> skpj", f_re_i, b_im) \
            + jnp.einsum("skpq, skqj -> skpj", f_im_i, b_re)
        embH1 = (jnp.einsum("k, skpi, skpj -> sij", wk_j, b_re, hb_re)
                 + jnp.einsum("k, skpi, skpj -> sij", wk_j, b_im, hb_im)) / nk
        # dV/dparam in the embedding basis (local vcor: one R sum);
        # two-step contraction: the single 5-tensor einsum costs
        # P*nk*nlo^2*neo^2 while (dv . bR) then (. bR) costs
        # 2*P*nk*nlo*neo^2 -- nlo/2 x fewer f64 flops
        dvb = jnp.einsum("Pspq, sRqj -> PsRpj", dv, bR)
        dV_emb = jnp.einsum("sRpi, PsRpj -> Psij", bR, dvb)

        # vcor fit in the fixed embedding basis: same objective as
        # ops.fit.FitVcorEmb finite-T (the cg engine bit-matches the
        # facade's, tests/test_fastpath.py)
        def err_plain(p):
            Heff = embH1 + jnp.einsum("P, Psij -> sij", p, dV_emb)
            errs = 0.0
            for s in range(spin):
                r1, _ = rho_fermi_real(Heff[s], nelec2_emb, beta)
                errs = errs + jnp.sum((r1 - rho_target[s]) ** 2)
            return jnp.sqrt(errs / spin)

        fg_p = jax.value_and_grad(err_plain)
        p_new, err_end, _ = _cg_engine(fg_p, vparam, fit_max_iter,
                                       ytol, gtol)
        if L is None:
            return p_new, err_end, embH1, rho_R, basis
        # embedding-ERI transform (once per DMET iteration): two f64
        # rotations and one f64 GEMM, all left to XLA (cuBLAS on GPU)
        Bf = basis[0]                                 # (nsites, neo)
        LB = jnp.einsum("xpq, qj -> xpj", L, Bf)
        L_emb = jnp.einsum("pi, xpj -> xij", Bf, LB)
        eri_emb = eri_from_factors(L_emb)
        return p_new, err_end, embH1, rho_R, basis, eri_emb

    step_jit = jax.jit(step)

    def step_fn(vparam, rho_target):
        return step_jit(vparam, rho_target, *operands)

    step_fn.traced = step
    step_fn.operands = operands
    return step_fn, params0


def chain_iterations(step_fn, n_chain):
    """Chain n_chain fused iterations with a data dependency (the fitted
    vcor feeds the next iteration) inside ONE program -- the sustained
    per-iteration cost without paying the host fetch per iteration.

    step_fn: the step returned by make_dmet_iteration (its traced body
    composes under scan; the DF factors stay call arguments).  Returns a
    (vparam0, rho_target) -> (vparam_final, last_err) callable running
    one jit-compiled program."""
    traced, operands = step_fn.traced, step_fn.operands

    def chained_impl(vparam, rho_target, *ops):
        def body(carry, _):
            p, chk = carry
            out = traced(p, rho_target, *ops)
            p_new, err = out[0], out[1]
            if len(out) > 5:
                # keep the per-iteration ERI transform LIVE under scan
                # (a checksum in the carry defeats dead-code
                # elimination of the unused eri_emb)
                chk = chk + jnp.sum(out[5][0, 0])
            return (p_new, chk), err
        (p_fin, chk), errs = lax.scan(body, (vparam, 0.0), None,
                                      length=n_chain)
        return p_fin, errs[-1] + 1e-300 * chk

    chained_jit = jax.jit(chained_impl)

    def chained(vparam, rho_target):
        return chained_jit(vparam, rho_target, *operands)

    return chained
