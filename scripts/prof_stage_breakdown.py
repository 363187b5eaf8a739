"""Stage-cost breakdown of the bench DMET iteration on the GPU: mean
field / bath+transforms / one fit-step value_and_grad, each timed as a
20-deep chained program to remove dispatch latency (host clock, ended by
block_until_ready).  Exits non-zero without a GPU.
Run: python scripts/prof_stage_breakdown.py"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import libdmet_preview_tpu  # noqa: F401
import jax, jax.numpy as jnp
from jax import lax
from libdmet_preview_tpu.ops import zlinalg
from libdmet_preview_tpu.ops.zlinalg import zrho_fermi_w, rho_fermi_real
from bench import card_line, require_gpu

require_gpu()
print(card_line(), flush=True)

NK, NLO, NVAL = 27, 16, 16
NEO = NLO + NVAL
BETA = 1000.0
rng = np.random.RandomState(0)

cos_t, sin_t = zlinalg.dft_tables((NK,))
ibz = np.asarray([k for k in range(NK) if k <= (-k) % NK])
wk = np.asarray([1.0 if (-k) % NK == k else 2.0 for k in ibz])
nkk = len(ibz)
h = rng.randn(NK, NLO, NLO) * 0.2
h_R = np.empty_like(h)
h_R[0] = (h[0] + h[0].T) / 2
for R in range(1, NK // 2 + 1):
    h_R[R] = h[R]
    h_R[(-R) % NK] = h[R].T
f_re = np.einsum("kR, Rij -> kij", cos_t, h_R)[None][:, ibz]
f_im = -np.einsum("kR, Rij -> kij", sin_t, h_R)[None][:, ibz]
f_re_i, f_im_i = jnp.asarray(f_re), jnp.asarray(f_im)
wk_j = jnp.asarray(wk)
cos_i = jnp.asarray(cos_t[ibz] * wk[:, None])
sin_i = jnp.asarray(sin_t[ibz] * wk[:, None])
cosT_i = jnp.asarray(cos_t.T[ibz])
sinT_i = jnp.asarray(sin_t.T[ibz])
env_j = jnp.asarray(np.arange(NLO, NK * NLO))
val_idx = np.arange(NVAL)
nelec2 = float(2 * NK * NLO * 0.5)

tri = np.tril_indices(NLO)
P = len(tri[0])
dvn = np.zeros((P, 1, NLO, NLO))
for Pi, (i, j) in enumerate(zip(*tri)):
    dvn[Pi, 0, i, j] = 1.0
    dvn[Pi, 0, j, i] = 1.0
dv = jnp.asarray(dvn)
p0 = jnp.asarray(rng.randn(P) * 0.05)


def mf(vparam):
    vmat = jnp.einsum("P, Psij -> sij", vparam, dv)
    h_re = f_re_i + vmat[:, None]
    r_re, r_im, mu = zrho_fermi_w(h_re, f_im_i, nelec2, BETA, wk_j)
    return h_re, r_re, r_im, mu


def mf_to_emb(vparam):
    h_re, r_re, r_im, mu = mf(vparam)
    rho_R = (jnp.einsum("kR, skpq -> sRpq", cos_i, r_re)
             - jnp.einsum("kR, skpq -> sRpq", sin_i, r_im)) / NK
    flat = lax.stop_gradient(rho_R).reshape(1, NK * NLO, NLO)
    env = flat[:, env_j][:, :, val_idx]
    G = jnp.einsum("spi, spj -> sij", env, env)
    w, V = zlinalg._eigh_mf_real(G)
    w = jnp.maximum(w, 1e-14 * jnp.max(w, axis=-1, keepdims=True))
    u = jnp.einsum("spi, sij -> spj", env, V) / jnp.sqrt(w)[:, None, :]
    eye_b = jnp.eye(u.shape[-1], dtype=u.dtype)
    for _ in range(2):
        g2 = jnp.einsum("spi, spj -> sij", u, u)
        u = jnp.einsum("spj, sji -> spi", u, 1.5 * eye_b - 0.5 * g2)
    basis = jnp.zeros((1, NK * NLO, NEO))
    basis = basis.at[:, :NLO, :NLO].set(jnp.eye(NLO))
    basis = basis.at[:, env_j, NLO:].set(u)
    bR = basis.reshape(1, NK, NLO, NEO)
    b_re = jnp.einsum("kR, sRpj -> skpj", cosT_i, bR)
    b_im = jnp.einsum("kR, sRpj -> skpj", sinT_i, bR)
    hb_re = jnp.einsum("skpq, skqj -> skpj", h_re, b_re) \
        - jnp.einsum("skpq, skqj -> skpj", f_im_i, b_im)
    hb_im = jnp.einsum("skpq, skqj -> skpj", h_re, b_im) \
        + jnp.einsum("skpq, skqj -> skpj", f_im_i, b_re)
    embH1 = (jnp.einsum("k, skpi, skpj -> sij", wk_j, b_re, hb_re)
             + jnp.einsum("k, skpi, skpj -> sij", wk_j, b_im, hb_im)) / NK
    dvb = jnp.einsum("Pspq, sRqj -> PsRpj", dv, bR)
    dV_emb = jnp.einsum("sRpi, PsRpj -> Psij", bR, dvb)
    return embH1, dV_emb


embH1_c, dV_c = jax.jit(mf_to_emb)(p0)
embH1_c = jax.device_put(np.asarray(embH1_c))
dV_c = jax.device_put(np.asarray(dV_c))
tgt = jax.device_put(np.asarray(
    jax.jit(mf_to_emb)(p0 + 0.01)[0][0]))


def fit_eval(p):
    Heff = embH1_c + jnp.einsum("P, Psij -> sij", p, dV_c)
    r1, _ = rho_fermi_real(Heff[0], nelec2, BETA)
    return jnp.sqrt(jnp.sum((r1 - tgt) ** 2))


fit_vg = jax.value_and_grad(fit_eval)


def chain(f, out_of):
    def g(x):
        def body(c, _):
            out = f(c)
            leaf = out_of(out)
            return c + 1e-20 * leaf, None
        return lax.scan(body, x, None, length=20)[0]
    return jax.jit(g)


progs = [
    ("mean_field", chain(mf, lambda o: jnp.sum(o[1]))),
    ("mf+bath+emb", chain(mf_to_emb, lambda o: jnp.sum(o[0]))),
    ("fit_vg_step", chain(fit_vg, lambda o: o[0] + jnp.sum(o[1]))),
]
for name, f in progs:
    jax.block_until_ready(f(p0))
    t0 = time.perf_counter()
    for _ in range(5):
        jax.block_until_ready(f(p0))
    t = (time.perf_counter() - t0) / 5 / 20 * 1e3
    print("%-12s %8.3f ms/eval" % (name, t), flush=True)
