"""
The one f64 code path that runs on every backend: the plain ERI
transform against a brute-force 4-index reference, the DF factors as a
call argument of the fused step, the f64 LM solve, the compile-cache
choice, the sharded iteration on caller-chosen devices, and the device
checks of chip_smoke.py / bench.py.  The `gpu` test compares the fused
step on the GPU with the host CPU; it skips where there is no GPU.
"""

import os
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _chain_setup(naux=8, seed=3):
    import libdmet_preview_tpu.dmet.hubbard as dmet
    Lat = dmet.ChainLattice(18, 2)
    Lat.set_Ham(dmet.Ham(Lat, 4.0), use_hcore_as_emb_ham=True)
    vcor = dmet.PMInitGuess((2,), 4.0, 0.5)
    rng = np.random.RandomState(seed)
    vcor.update(vcor.param + rng.randn(len(vcor.param)) * 0.05)
    L = rng.randn(naux, 18, 18) * 0.1
    L = 0.5 * (L + L.transpose(0, 2, 1))
    return Lat, vcor, L


def _fit_target(step, p0, seed=7):
    """A non-zero fit target: the Fermi projector of embH1 at perturbed
    parameters (as chip_smoke.py builds it), so the fit error depends on
    the embedding basis the target is given in."""
    dp = np.random.RandomState(seed).randn(len(p0)) * 0.1
    embH1 = np.asarray(step(jnp.asarray(p0 + dp), jnp.zeros((1, 4, 4)))[2])
    w, V = np.linalg.eigh(embH1)
    occ = 1.0 / (np.exp(np.clip(1000.0 * (w - np.median(w)), -100, 100))
                 + 1.0)
    return np.einsum("spi, si, sqi -> spq", V, occ, V)


def _orthonormal_basis(rng, spin, ncells, nlo, neo):
    C = np.stack([np.linalg.qr(rng.randn(ncells * nlo, neo))[0]
                  for _ in range(spin)])
    return C.reshape(spin, ncells, nlo, neo)


@pytest.mark.parametrize("spin, neo", [(1, 48), (2, 48), (1, 64)])
def test_emb_eri_chol_matches_bruteforce(spin, neo):
    """get_emb_eri_chol (rotate + one f64 GEMM) == the direct 4-index
    transform of the dense ERI, restricted (aa) and unrestricted
    (aa, bb, ab), at neo >= 48 and naux >= 256."""
    from libdmet_preview_tpu.ops.eri_transform import (get_emb_eri_chol,
                                                       get_emb_eri_mol)
    rng = np.random.RandomState(neo + spin)
    ncells, nlo, naux = 8, 8, 256
    n = ncells * nlo
    L = rng.randn(naux, n, n) * 0.05
    L = 0.5 * (L + L.transpose(0, 2, 1))
    basis = _orthonormal_basis(rng, spin, ncells, nlo, neo)
    eri_full = np.einsum("xpq, xrs -> pqrs", L, L, optimize=True)
    got = get_emb_eri_chol(L, basis)
    ref = get_emb_eri_mol(eri_full, basis)
    assert got.shape == ((1 if spin == 1 else 3),) + (neo,) * 4
    assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max() * neo


def test_fused_eri_matches_get_emb_eri_chol():
    """make_dmet_iteration(chol_L=...) returns the same eri_emb as
    get_emb_eri_chol on the step's own basis."""
    from libdmet_preview_tpu.ops.fastpath import make_dmet_iteration
    from libdmet_preview_tpu.ops.eri_transform import get_emb_eri_chol
    Lat, vcor, L = _chain_setup()
    step, p0 = make_dmet_iteration(Lat, vcor, 0.5, beta=1000.0,
                                   fit_max_iter=3, chol_L=L)
    out = step(jnp.asarray(p0), jnp.zeros((1, 4, 4)))
    basis, eri = np.asarray(out[4]), np.asarray(out[5])
    ref = get_emb_eri_chol(L, basis.reshape(1, Lat.ncells, 2, 4))[0]
    assert np.abs(eri - ref).max() < 1e-13


def test_fused_step_takes_factors_as_argument():
    """The DF factors are a parameter of the compiled step, never a
    constant baked into it."""
    from libdmet_preview_tpu.ops.fastpath import make_dmet_iteration
    Lat, vcor, L = _chain_setup()
    step, p0 = make_dmet_iteration(Lat, vcor, 0.5, beta=1000.0,
                                   fit_max_iter=3, chol_L=L)
    assert len(step.operands) == 1 and step.operands[0].shape == L.shape
    closed = jax.make_jaxpr(step)(jnp.asarray(p0), jnp.zeros((1, 4, 4)))
    calls = [e for e in closed.jaxpr.eqns
             if e.primitive.name in ("jit", "pjit")]
    assert len(calls) == 1
    inner = calls[0].params["jaxpr"]
    assert L.shape in [v.aval.shape for v in inner.jaxpr.invars]
    assert all(np.shape(c) != L.shape for c in inner.consts)


@pytest.mark.parametrize("gso", [False, True])
def test_emb_eri_chol_refuses_asymmetric_factors(gso):
    """The s4-packed product reads only i >= j of each factor, so factors
    that are not symmetric in (pq) are refused, not silently folded."""
    from libdmet_preview_tpu.ops.eri_transform import (get_emb_eri_chol,
                                                       get_emb_eri_gso_chol)
    rng = np.random.RandomState(4)
    L = rng.randn(16, 8, 8)
    if gso:
        basis = _orthonormal_basis(rng, 1, 1, 16, 6)
        eri = get_emb_eri_gso_chol(L + L.transpose(0, 2, 1), basis)
        with pytest.raises(ValueError):
            get_emb_eri_gso_chol(L, basis)
    else:
        basis = _orthonormal_basis(rng, 2, 2, 4, 6)
        eri = get_emb_eri_chol(L + L.transpose(0, 2, 1), basis)
        with pytest.raises(ValueError):
            get_emb_eri_chol(L, basis)
    assert np.all(np.isfinite(eri))


def test_fused_step_bath_gauge_fixed(monkeypatch):
    """The fused step's basis and fit error do not depend on the signs
    the eigensolver gives the bath eigenvectors: with a non-zero target,
    negating columns of the Gram eigenvectors changes nothing."""
    from libdmet_preview_tpu.ops.fastpath import make_dmet_iteration
    Lat, vcor, _ = _chain_setup()

    def run():
        step, p0 = make_dmet_iteration(Lat, vcor, 0.5, beta=1000.0,
                                       fit_max_iter=5)
        return step, p0

    step, p0 = run()
    target = _fit_target(step, p0)
    p_ref, e_ref, _, _, b_ref = step(jnp.asarray(p0), target)

    eigh = jnp.linalg.eigh

    def eigh_flipped(a, *args, **kwargs):
        w, V = eigh(a, *args, **kwargs)
        return w, V * (-1.0) ** jnp.arange(V.shape[-1])

    monkeypatch.setattr(jnp.linalg, "eigh", eigh_flipped)
    step_f, _ = run()
    p_f, e_f, _, _, b_f = step_f(jnp.asarray(p0), target)
    assert float(e_ref) > 1e-3
    assert np.abs(np.asarray(b_f) - np.asarray(b_ref)).max() < 1e-12
    assert abs(float(e_f) - float(e_ref)) < 1e-12
    assert np.abs(np.asarray(p_f) - np.asarray(p_ref)).max() < 1e-10


def test_lm_solve_matches_numpy():
    """The LM normal equations are solved by one f64 Cholesky solve."""
    from libdmet_preview_tpu.ops.fit import _solve_spd
    rng = np.random.RandomState(0)
    P = 40
    Q = np.linalg.qr(rng.randn(P, P))[0]
    A = (Q * np.logspace(-6, 0, P)) @ Q.T
    b = rng.randn(P)
    x = np.asarray(_solve_spd(jnp.asarray(A), jnp.asarray(b)))
    ref = np.linalg.solve(A, b)
    assert np.abs(x - ref).max() < 1e-8 * np.abs(ref).max()


@pytest.mark.parametrize("environ, expect", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "/elsewhere/cache"),
    ({}, None),
])
def test_compile_cache_dir(environ, expect):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed
    in-checkout directory, which the package also configured."""
    import libdmet_preview_tpu as pkg
    if expect is None:
        expect = os.path.join(REPO, ".jax_cache")
        assert pkg.DEFAULT_CACHE_DIR == expect
    assert pkg.compile_cache_dir(environ) == expect
    assert jax.config.jax_compilation_cache_dir == pkg.compile_cache_dir()


def test_dmet_iteration_sharded_on_four_devices():
    """The sharded DMET iteration on four caller-chosen devices: a 2x2
    (k x aux) mesh, every sharded result == the serial path."""
    from libdmet_preview_tpu.parallel.dryrun import run_dmet_iteration_sharded
    res = run_dmet_iteration_sharded(jax.devices()[:4])
    assert res["n_devices"] == 4 and res["mesh"] == (2, 2)
    assert max(res["err_mf"], res["err_h1"], res["err_eri"]) < 1e-8
    assert abs(res["nelec_imp"] - 1.0) < 1e-5


@pytest.mark.parametrize("argv, phases, n_cards", [
    ([], ("fused", "hub2d", "hchain_fci", "hchain_ccsd"), 1),
    (["--four-cards"], ("four_cards",), 4),
])
def test_chip_smoke_phase_selection(argv, phases, n_cards):
    import chip_smoke
    assert chip_smoke.select_phases(argv) == (phases, n_cards)
    assert set(phases) <= set(chip_smoke.PHASE_FNS)


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py and bench.py share the device check: no CPU
    fallback."""
    import chip_smoke
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu(jax.devices("cpu"))
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu(jax.devices("cpu"), n_cards=4)


def test_chip_smoke_device_count():
    """The four-card option needs four GPUs, not one."""
    import chip_smoke
    gpu = types.SimpleNamespace(platform="gpu")
    assert chip_smoke.require_gpu([gpu]) is gpu
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([gpu], n_cards=4)
    assert chip_smoke.require_gpu([gpu] * 4, n_cards=4) is gpu


def test_chip_smoke_main_exits_without_gpu(capsys):
    """Without a GPU, main() exits non-zero before any phase and prints
    no result line."""
    import chip_smoke
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.gpu
def test_fused_step_gpu_matches_cpu(gpu_device):
    """The fused step with the ERI transform on the GPU == the same
    program on the host CPU, by rotation-invariant quantities, with a
    non-zero fit target given in the bath basis."""
    from libdmet_preview_tpu.ops.fastpath import make_dmet_iteration
    Lat, vcor, L = _chain_setup()
    outs = []
    for dev in (gpu_device, jax.devices("cpu")[0]):
        with jax.default_device(dev):
            step, p0 = make_dmet_iteration(Lat, vcor, 0.5, beta=1000.0,
                                           fit_max_iter=5, chol_L=L)
            if not outs:
                target = _fit_target(step, p0)
            outs.append(jax.tree.map(np.asarray,
                                     step(jnp.asarray(p0), target)))
    (_, e_g, h_g, r_g, b_g, eri_g), (_, e_c, h_c, r_c, b_c, eri_c) = outs
    assert np.abs(r_g - r_c).max() < 1e-10
    P_g = np.einsum("spi, sqi -> spq", b_g, b_g)
    P_c = np.einsum("spi, sqi -> spq", b_c, b_c)
    assert np.abs(P_g - P_c).max() < 1e-10
    assert np.abs(np.linalg.eigvalsh(h_g) - np.linalg.eigvalsh(h_c)).max() \
        < 1e-10
    assert abs(float(e_g) - float(e_c)) < 1e-8 * abs(float(e_c))
