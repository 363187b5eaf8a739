"""Smoke test of the DMET main path on an NVIDIA GPU.

    python chip_smoke.py               # one card: fused, hub2d, hchain
    python chip_smoke.py --four-cards  # four cards: the sharded path only

One process drives the card(s).  Phases (one card):

  fused        the fused lattice iteration (ops.fastpath) at the bench's
               widths: Nk=27, nlo=16, neo=32, naux=512 over the 432-site
               supercell, 20 fit steps, ERI transform in the loop; three
               chained iterations on the GPU against the same f64 program
               on the host CPU backend, compared by rotation-invariant
               quantities.
  hub2d        2D Hubbard 40x40, 2x2 impurity, U/t=6, half filling, UHF
               AFM, non-interacting bath, FCI, MuSolver + DIIS, through
               the dmet facades; E/site against the reference anchor.
  hchain_fci   periodic H chain, 3 k-points, 3-21G, native integrals,
  hchain_ccsd  interacting bath, charge self-consistency, FCI / CCSD
               solver; E/cell against the reference anchors.

With --four-cards: one sharded DMET iteration on a 2x2 (k x aux) mesh of
four GPUs (parallel.dryrun) and the aux-sharded ERI transform at the
bench's widths, each against the serial one-card path at 1e-8.

Each check prints one line (value, reference, difference, tolerance,
seconds, device).  Any check outside its tolerance or any exception makes
the script exit non-zero; otherwise the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU the script exits non-zero before any phase runs.
"""
import argparse
import json
import os
import sys
import time
import traceback

import jax

from bench import card_line, require_gpu

REPO = os.path.dirname(os.path.abspath(__file__))
ONE_CARD_PHASES = ("fused", "hub2d", "hchain_fci", "hchain_ccsd")
FOUR_CARD_PHASES = ("four_cards",)

E_HUB2D = -0.652114179764      # reference test_hub2d_nib.py:121
E_HCHAIN_FCI = -1.243085261466  # reference test_self_consistency.py:249
E_HCHAIN_CCSD = -1.242988933742  # reference test_cc_solver.py:267
TOL_ANCHOR = 1e-4               # the reference's own anchor tolerance


def select_phases(argv):
    """(phases, number of cards) for the command line."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)
    if args.four_cards:
        return FOUR_CARD_PHASES, 4
    return ONE_CARD_PHASES, 1


class Checks:
    """Collects and prints one line per compared quantity."""

    def __init__(self, device):
        self.device = device
        self.failed = []

    def add(self, name, value, ref, diff, tol, seconds):
        ok = bool(diff <= tol)
        print("%-24s value=%.12g ref=%.12g diff=%.3e tol=%.0e %.1fs "
              "device=%s %s" % (name, value, ref, diff, tol, seconds,
                                self.device, "ok" if ok else "FAIL"),
              flush=True)
        if not ok:
            self.failed.append(name)

    def compare(self, name, x, ref, tol, seconds):
        """Relative max deviation of array x from ref."""
        import numpy as np
        x, ref = np.asarray(x), np.asarray(ref)
        scale = float(np.max(np.abs(ref)))
        diff = float(np.max(np.abs(x - ref))) / scale
        self.add(name, float(np.max(np.abs(x))), scale, diff, tol, seconds)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def _fused_run(step, p0, target, n_iter):
    """n_iter chained fused iterations as a host loop; every output."""
    import jax.numpy as jnp
    p = jnp.asarray(p0)
    outs = []
    for _ in range(n_iter):
        out = step(p, target)
        outs.append(out)
        p = out[0]
    return outs


def phase_fused(checks):
    """Fused iteration at the bench's widths, GPU against host CPU."""
    import numpy as np
    import jax.numpy as jnp
    import bench
    from libdmet_preview_tpu.ops.fastpath import (make_dmet_iteration,
                                                  chain_iterations)
    n_iter = 3
    Lat, vmat, rho_t, L = bench.make_lattice(seed=0)
    rng = np.random.RandomState(7)

    def build():
        vcor = bench._VcorFixed(vmat)
        return make_dmet_iteration(Lat, vcor, bench.FILLING,
                                   beta=bench.BETA,
                                   fit_max_iter=bench.N_FIT_STEPS, chol_L=L)

    t0 = time.perf_counter()
    step_g, p0 = build()
    dp = rng.randn(len(p0)) * 0.1
    embH1_p = np.asarray(step_g(jnp.asarray(p0 + dp), jnp.asarray(rho_t))[2])
    w, V = np.linalg.eigh(embH1_p)
    occ = 1.0 / (np.exp(np.clip(bench.BETA * (w - np.median(w)),
                                -100, 100)) + 1)
    target = np.einsum("spi, si, sqi -> spq", V, occ, V)
    gpu = [jax.tree.map(np.asarray, o)
           for o in _fused_run(step_g, p0, jnp.asarray(target), n_iter)]
    t_gpu = time.perf_counter() - t0

    t0 = time.perf_counter()
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        step_c, _ = build()
        cpu = [jax.tree.map(np.asarray, o)
               for o in _fused_run(step_c, p0,
                                   jax.device_put(target, cpu_dev), n_iter)]
    t_cpu = time.perf_counter() - t0
    secs = t_gpu + t_cpu

    # the first iteration starts from the same parameters on both sides,
    # so its outputs differ only by summation order and eigensolver: f64
    # round-off amplified by at most beta * f(1-f) at the Fermi level
    _, _, embH1_g, rhoR_g, basis_g, eri_g = gpu[0]
    _, _, embH1_c, rhoR_c, basis_c, eri_c = cpu[0]
    checks.compare("fused.rho_R", rhoR_g, rhoR_c, 1e-10, secs)
    # the bath basis is defined up to a rotation: compare its projector
    checks.compare("fused.projector", np.einsum("spi, sqi -> spq",
                                                basis_g, basis_g),
                   np.einsum("spi, sqi -> spq", basis_c, basis_c),
                   1e-10, secs)
    checks.compare("fused.embH1_spectrum", np.linalg.eigvalsh(embH1_g),
                   np.linalg.eigvalsh(embH1_c), 1e-10, secs)
    # ERI from the GPU's own basis, recomputed on the host with NumPy
    B = basis_g[0]
    L_emb = np.einsum("pi, xpq, qj -> xij", B, L, B, optimize=True)
    Lf = L_emb.reshape(L_emb.shape[0], -1)
    eri_np = (Lf.T @ Lf).reshape(eri_g.shape)
    checks.compare("fused.eri_emb", eri_g, eri_np, 1e-10, secs)
    # the fit error is the end of an iterative CG with line searches whose
    # sums run in another order on each side: 1e-8 relative
    for i in range(n_iter):
        e_g, e_c = float(gpu[i][1]), float(cpu[i][1])
        checks.add("fused.fit_err[%d]" % i, e_g, e_c,
                   abs(e_g - e_c) / abs(e_c), 1e-8, secs)

    # information, not a claim: steady time per chained iteration
    chained = chain_iterations(step_g, n_iter)
    p0_j, t_j = jnp.asarray(p0), jnp.asarray(target)
    p_fin, err_fin = jax.block_until_ready(chained(p0_j, t_j))
    checks.add("fused.chained_fit_err", float(err_fin), float(gpu[-1][1]),
               abs(float(err_fin) - float(gpu[-1][1]))
               / abs(float(gpu[-1][1])), 1e-8, secs)
    n_rep = 5
    t0 = time.perf_counter()
    for _ in range(n_rep):
        jax.block_until_ready(chained(p0_j, t_j))
    t_it = (time.perf_counter() - t0) / n_rep / n_iter
    print("fused: %.3f ms per chained iteration on %s (%s); host CPU "
          "reference took %.1f s" % (t_it * 1e3, checks.device, card_line(),
                                     t_cpu), flush=True)


def phase_hub2d(checks):
    """2D Hubbard NIB DMET (reference test_hub2d_nib.py), facade loop."""
    import numpy as np
    import libdmet_preview_tpu.dmet.hubbard as dmet
    from libdmet_preview_tpu.solvers import FCI
    from libdmet_preview_tpu.ops.diis import DIIS

    t0 = time.perf_counter()
    U, Filling, ImpSize = 6.0, 0.5, (2, 2)
    Lat = dmet.SquareLattice(40, 40, *ImpSize)
    Lat.set_Ham(dmet.Ham(Lat, U), use_hcore_as_emb_ham=True)
    vcor = dmet.AFInitGuess(ImpSize, U, Filling)
    solver = FCI(restricted=False, tol=1e-10)
    mu_solver = dmet.MuSolver(adaptive=True)
    adiis = DIIS(space=4)
    Mu, last_dmu, E_old, E = U * Filling, 0.0, 0.0, None
    for it in range(20):
        rho, Mu, _ = dmet.HartreeFock(Lat, vcor, Filling, Mu, ires=True)
        ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor,
                                                  matching=False,
                                                  int_bath=False)
        ImpHam = dmet.apply_dmu(Lat, ImpHam, basis, last_dmu)
        solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
        rhoEmb, EnergyEmb, ImpHam, dmu = mu_solver(
            Lat, Filling, ImpHam, basis, solver, solver_args)
        last_dmu += dmu
        _, E, _ = dmet.transformResults(
            rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat,
            last_dmu=last_dmu, int_bath=False, solver=solver,
            solver_args=solver_args)
        vcor_new, _ = dmet.FitVcor(rhoEmb, Lat, basis, vcor, np.inf,
                                   Filling, MaxIter2=0)
        if it >= 3:
            ddiagV = np.average(np.diagonal(
                (vcor_new.get() - vcor.get())[:2], 0, 1, 2))
            vcor_new = dmet.addDiag(vcor_new, -ddiagV)
        pvcor = np.hstack(vcor_new.param)
        if it >= 4:
            pvcor = adiis.update(pvcor)
        dV = np.linalg.norm(pvcor - vcor.param) / len(vcor.param)
        vcor.update(pvcor)
        dE, E_old = E - E_old, E
        if dV < 1e-5 and abs(dE) < 1e-5 and it > 3:
            break
    checks.add("hub2d.E_per_site", E, E_HUB2D, abs(E - E_HUB2D),
               TOL_ANCHOR, time.perf_counter() - t0)


def _hchain_dmet(solver, beta):
    """Self-consistent interacting-bath DMET on the 3-k-point H chain
    (reference test_cc_solver.py / test_self_consistency.py protocol).
    Returns the converged E/cell."""
    import numpy as np
    import libdmet_preview_tpu.dmet.hubbard as dmet
    from libdmet_preview_tpu.models.abinitio import (make_hchain_pbc_lattice,
                                                     update_ham_dense)
    from libdmet_preview_tpu.ops.vcor import VcorLocal
    from libdmet_preview_tpu.ops.diis import DIIS
    from libdmet_preview_tpu.ops.fit import make_vcor_trace_unchanged

    Lat, meta = make_hchain_pbc_lattice(nk=3)
    nsc = Lat.nscsites
    Filling = 6 / (nsc * 2.0 * 3)
    vcor = VcorLocal(True, False, nsc)
    vcor.assign(np.zeros((2, nsc, nsc)))
    mu_solver = dmet.MuSolver(adaptive=True)
    adiis = DIIS(space=4)
    Mu, last_dmu, E_old, E_cell = 0.0, 0.0, 0.0, None
    for it in range(14):
        rho, Mu, _ = dmet.RHartreeFock(Lat, vcor, Filling, Mu, beta=beta,
                                       ires=True)
        update_ham_dense(Lat, meta, np.asarray(rho)[0] * 2.0)
        ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho, vcor,
                                                  matching=False,
                                                  int_bath=True)
        ImpHam = dmet.apply_dmu(Lat, ImpHam, basis, last_dmu)
        solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
        rhoEmb, EnergyEmb, ImpHam, dmu = mu_solver(
            Lat, Filling, ImpHam, basis, solver, solver_args,
            thrnelec=1e-6, delta=0.01, step=0.1)
        last_dmu += dmu
        _, EnergyImp, _ = dmet.transformResults(
            rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat,
            last_dmu=last_dmu, int_bath=True, solver=solver,
            solver_args=solver_args)
        E_cell = EnergyImp * nsc
        vcor_new, _ = dmet.FitVcor(rhoEmb, Lat, basis, vcor, beta, Filling,
                                   MaxIter1=300, MaxIter2=0, ytol=1e-8,
                                   gtol=1e-4)
        if it >= 3:
            vcor_new = make_vcor_trace_unchanged(vcor_new, vcor)
        pvcor = np.hstack(vcor_new.param)
        if it >= 4:
            pvcor = adiis.update(pvcor)
        dV = np.max(np.abs(pvcor - np.hstack(vcor.param)))
        vcor.update(np.asarray(pvcor))
        dE, E_old = E_cell - E_old, E_cell
        if dV < 5e-5 and abs(dE) < 5e-6 and it > 4:
            break
    return E_cell


def phase_hchain_fci(checks):
    import numpy as np
    from libdmet_preview_tpu.solvers import FCI
    t0 = time.perf_counter()
    E = _hchain_dmet(FCI(restricted=True, tol=1e-12), np.inf)
    checks.add("hchain_fci.E_per_cell", E, E_HCHAIN_FCI,
               abs(E - E_HCHAIN_FCI), TOL_ANCHOR, time.perf_counter() - t0)


def phase_hchain_ccsd(checks):
    """CCSD amplitudes, lambda and the response RDM solve on the card."""
    from libdmet_preview_tpu.solvers import CCSD
    t0 = time.perf_counter()
    E = _hchain_dmet(CCSD(restricted=True, tol=1e-9), 1000.0)
    checks.add("hchain_ccsd.E_per_cell", E, E_HCHAIN_CCSD,
               abs(E - E_HCHAIN_CCSD), TOL_ANCHOR, time.perf_counter() - t0)


def phase_four_cards(checks):
    """Sharded DMET iteration on a 2x2 (k x aux) mesh of four GPUs, and
    the aux-sharded ERI at the bench's widths, against the serial
    one-card path."""
    import numpy as np
    import bench
    from libdmet_preview_tpu.parallel.dryrun import (make_mesh,
                                                     run_dmet_iteration_sharded)
    from libdmet_preview_tpu.parallel.kmesh import get_emb_eri_chol_sharded
    from libdmet_preview_tpu.ops.eri_transform import get_emb_eri_chol

    devices = jax.devices()[:4]
    t0 = time.perf_counter()
    res = run_dmet_iteration_sharded(devices)
    secs = time.perf_counter() - t0
    for key in ("err_mf", "err_h1", "err_eri"):
        checks.add("four_cards." + key, res[key], 0.0, res[key], 1e-8, secs)

    t0 = time.perf_counter()
    _, _, _, L = bench.make_lattice(seed=0)
    nsites, neo = L.shape[-1], bench.NEO
    rng = np.random.RandomState(1)
    C = np.linalg.qr(rng.randn(nsites, neo))[0]
    basis = C.reshape(1, bench.NK, bench.NLO, neo)
    eri_sh = get_emb_eri_chol_sharded(make_mesh(devices), L, basis)
    eri_serial = get_emb_eri_chol(L, basis)
    checks.compare("four_cards.eri_bench", eri_sh, eri_serial, 1e-8,
                   time.perf_counter() - t0)


PHASE_FNS = {"fused": phase_fused, "hub2d": phase_hub2d,
             "hchain_fci": phase_hchain_fci,
             "hchain_ccsd": phase_hchain_ccsd,
             "four_cards": phase_four_cards}


def main(argv=None):
    phases, n_cards = select_phases(sys.argv[1:] if argv is None else argv)
    dev = require_gpu(jax.devices(), n_cards)
    print(card_line(), flush=True)
    # the native integrals are built on the host into the checkout's
    # own cache (models/abinitio.py), reused by later runs
    os.environ.setdefault("LIBDMET_TPU_INT_CACHE",
                          os.path.join(REPO, ".integral_cache"))
    import libdmet_preview_tpu
    print("device_kind=%s count=%d jax=%s compile_cache=%s"
          % (dev.device_kind, len(jax.devices()), jax.__version__,
             libdmet_preview_tpu.compile_cache_dir()), flush=True)

    checks = Checks(dev.device_kind)
    for name in phases:
        try:
            PHASE_FNS[name](checks)
        except Exception:
            traceback.print_exc()
            print("%-24s FAIL (exception)" % name, flush=True)
            checks.failed.append(name)
    if checks.failed:
        print("failed: %s" % ", ".join(checks.failed), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
