"""
Sharded DMET iteration: one full DMET iteration on a 2-axis (k x aux)
device mesh, driving the LIBRARY's sharded kernels (parallel.kmesh) end to
end, each result checked against the serial library path.

The caller chooses the devices: virtual CPU devices for the test suite
(tests/conftest.py; `python -m libdmet_preview_tpu.parallel.dryrun N`
sets up N of them), or the GPUs of one host (chip_smoke.py --four-cards).

The step mirrors dmet.loop.run_dmet (the reference example loop,
examples/dmet/01-dmet-1D-Hubbard/01-dmet-1D-Hubbard.py:50-115) with the
heavy kernels sharded over the mesh -- the reference's MPI pool
(routine/mfd_mpi.py, basis_transform/eri_transform_mpi.py) replaced by
shard_map + psum:

  1. lattice mean field        -> kmesh.hf_rho_sharded        (k axis)
  2. Schmidt bath              -> embham.embBasis (replicated; small)
  3. embedding H1 transform    -> kmesh.transform_h1_sharded  (k axis)
  4. embedding ERI             -> kmesh.get_emb_eri_chol_sharded (aux axis)
  5. FCI impurity solve + mu fit + energy  (facade; embedded problem is
     small by construction, runs replicated)
  6. vcor fit gradient through the sharded differentiable Fermi-density op
     (kmesh.make_zrho_fermi_sharded) -> one update

Every sharded result is asserted against the serial library path at 1e-8.
"""

import os
import sys


def _force_cpu_platform(n_devices):
    """Ask for n_devices virtual CPU devices; must run before JAX
    initializes its backends."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    key = "--xla_force_host_platform_device_count="
    parts = [p for p in flags.split() if not p.startswith(key)]
    parts.append(key + str(int(n_devices)))
    os.environ["XLA_FLAGS"] = " ".join(parts)


def make_mesh(devices):
    """2-axis (k, aux) mesh over `devices`: (n/2, 2) for an even n >= 4,
    else (n, 1)."""
    import numpy as np
    from jax.sharding import Mesh
    n = len(devices)
    if n >= 4 and n % 2 == 0:
        k_size, aux_size = n // 2, 2
    else:
        k_size, aux_size = n, 1
    return Mesh(np.asarray(devices).reshape(k_size, aux_size), ("k", "aux"))


def run_dmet_iteration_sharded(devices):
    """One library-driven DMET iteration with sharded kernels on a mesh
    over `devices` (a list of jax devices).  The serial references run on
    the default device.  Returns a result dict (energies, deviations)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    jax.config.update("jax_enable_x64", True)
    n_devices = len(devices)
    mesh = make_mesh(devices)
    k_size, aux_size = mesh.devices.shape

    import libdmet_preview_tpu.dmet.hubbard as dmet
    from libdmet_preview_tpu.ops import embham, mfd
    from libdmet_preview_tpu.parallel import kmesh
    from libdmet_preview_tpu.solvers import FCI

    # ---- lattice: 1D Hubbard, 2-site impurity, nk = 2 * k_size cells ----
    U, Filling, beta = 4.0, 0.5, 1000.0
    nlo = 2
    ncells = 2 * k_size
    nsites = ncells * nlo
    Lat = dmet.ChainLattice(nsites, nlo)
    Ham = dmet.Ham(Lat, U)
    Lat.set_Ham(Ham, use_hcore_as_emb_ham=True)
    vcor = dmet.PMInitGuess((nlo,), U, Filling)

    # ---- 1. sharded lattice mean field (vs serial mfd.HF) ----
    f_re, f_im = [np.asarray(x) for x in Lat.getFock(kspace=True)]
    if f_re.ndim == 3:
        f_re, f_im = f_re[None], f_im[None]
    vmat = np.asarray(vcor.get())[:1]
    h_re = f_re + vmat[:, None]
    # occupation count on the DOUBLED spectrum of the real-pair embedding
    # (spin=1 restricted: ew2.size * filling, see ops/mfd.HF)
    nelec2 = int(round(2 * nsites * Filling))
    rho_R, mu, nchk = kmesh.hf_rho_sharded(mesh, h_re, f_im, (ncells,),
                                           nelec2, beta)
    rho_R = np.asarray(rho_R)
    assert abs(float(nchk) - nelec2) < 1e-6
    rho_serial, mu_serial, E_serial = mfd.HF(Lat, vcor, Filling, True,
                                             beta=beta)
    err_mf = float(np.max(np.abs(rho_R - np.asarray(rho_serial))))
    assert err_mf < 1e-8, "sharded mean field deviates: %.3e" % err_mf

    # ---- 2. Schmidt bath (small; replicated) ----
    basis = embham.embBasis(Lat, rho_R)
    spin, _, _, neo = basis.shape
    basis_k = Lat.R2k_basis(basis)

    # ---- 3. sharded embedding-H1 transform (vs serial) ----
    H1_k = (jnp.asarray(np.broadcast_to(h_re, (spin,) + h_re.shape[1:])),
            jnp.asarray(np.broadcast_to(f_im, (spin,) + f_im.shape[1:])))
    embH1_sh = np.asarray(kmesh.transform_h1_sharded(mesh, H1_k, basis_k))
    embH1_serial = np.asarray(embham.transform_h1(
        (H1_k[0], H1_k[1]), basis_k))
    err_h1 = float(np.max(np.abs(embH1_sh - embH1_serial)))
    assert err_h1 < 1e-8, "sharded embH1 deviates: %.3e" % err_h1

    # ---- 4. sharded embedding ERI on a REAL ab initio factor set ----
    # the aux axis carries the dense Cholesky factors of an actual
    # 1/r-interaction H-ring lattice (full-rank, non-diagonal), with its
    # own Schmidt bath -- the GDF-workload shape of the reference's MPI
    # ERI transform (eri_transform_mpi.py), not a symbolic diagonal U
    from libdmet_preview_tpu.models.abinitio import make_h_ring_lattice
    from libdmet_preview_tpu.ops.eri_transform import get_emb_eri_chol
    Lat_ai, meta_ai = make_h_ring_lattice(ncells=4, atoms_per_cell=2,
                                          r_bond=1.8, basis="sto-6g")
    rho_ai, _mu_ai = dmet.RHartreeFock(Lat_ai, dmet.PMInitGuess(
        (Lat_ai.nscsites,), 0.0, 0.5), 0.5, None)
    basis_ai = embham.embBasis(Lat_ai, np.asarray(rho_ai))
    L_ai = np.asarray(Lat_ai.Ham.getH2())
    eri_sh = kmesh.get_emb_eri_chol_sharded(mesh, L_ai, basis_ai[:1])
    eri_serial = get_emb_eri_chol(L_ai, basis_ai[:1])
    err_eri = float(np.max(np.abs(np.asarray(eri_sh)
                                  - np.asarray(eri_serial))))
    assert err_eri < 1e-8, "sharded ERI deviates: %.3e" % err_eri

    # ---- 5. impurity solve + mu fit + energy (facade, replicated) ----
    ImpHam, H1e, basis = dmet.ConstructImpHam(Lat, rho_R, vcor,
                                              matching=False,
                                              int_bath=False)
    solver = FCI(restricted=True, tol=1e-10)
    mu_solver = dmet.MuSolver(adaptive=True)
    solver_args = {"nelec": (Lat.ncore + Lat.nval) * 2}
    rhoEmb, EnergyEmb, ImpHam, dmu = mu_solver(Lat, Filling, ImpHam, basis,
                                               solver, solver_args)
    rhoImp, EnergyImp, nelecImp = dmet.transformResults(
        rhoEmb, EnergyEmb, basis, ImpHam, H1e, lattice=Lat, last_dmu=dmu,
        int_bath=False)

    # ---- 6. vcor fit gradient through the sharded Fermi-density op ----
    from libdmet_preview_tpu.ops.zlinalg import dft_tables
    zrho = kmesh.make_zrho_fermi_sharded(nelec2, beta, axis="k")
    cos_t, sin_t = [jnp.asarray(t) for t in dft_tables((ncells,))]
    b_re = jnp.einsum("kR, sRpj -> skpj", cos_t.T, jnp.asarray(basis))
    b_im = jnp.einsum("kR, sRpj -> skpj", sin_t.T, jnp.asarray(basis))
    target = jnp.asarray(rhoEmb[:1])
    spec_k = P(None, "k", None, None)

    def fit_shard(h_re_s, h_im_s, br, bi, tgt):
        r_re, r_im, _ = zrho(h_re_s, h_im_s)
        nk = lax.psum(h_re_s.shape[1], "k")
        rho_emb = lax.psum(
            (jnp.einsum("skpi, skpq, skqj -> sij", br, r_re, br)
             + jnp.einsum("skpi, skpq, skqj -> sij", bi, r_re, bi)
             + jnp.einsum("skpi, skpq, skqj -> sij", bi, r_im, br)
             - jnp.einsum("skpi, skpq, skqj -> sij", br, r_im, bi)) / nk,
            "k")
        return jnp.sum((rho_emb - tgt) ** 2)

    def loss(v):
        h = jnp.asarray(f_re) + v[:, None]
        return shard_map(fit_shard, mesh=mesh,
                         in_specs=(spec_k, spec_k, spec_k, spec_k, P()),
                         out_specs=P())(h, jnp.asarray(f_im), b_re, b_im,
                                        target)

    fit_err, g = jax.jit(jax.value_and_grad(loss))(jnp.asarray(vmat))
    jax.block_until_ready((fit_err, g))
    vmat_new = np.asarray(vmat - 0.05 * np.asarray(g))
    assert np.all(np.isfinite(vmat_new))

    return {"n_devices": n_devices, "mesh": (k_size, aux_size),
            "E_mf": float(E_serial), "E_imp": float(EnergyImp),
            "nelec_imp": float(nelecImp), "fit_err": float(fit_err),
            "err_mf": err_mf, "err_h1": err_h1, "err_eri": err_eri}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    n_devices = int(argv[0]) if argv else 8
    _force_cpu_platform(n_devices)
    import jax
    res = run_dmet_iteration_sharded(jax.devices("cpu")[:n_devices])
    print("dmet_iteration_sharded(%d): mesh=%dx%d E_mf=%.8f E_imp=%.8f "
          "fit_err=%.3e  (mf|h1|eri dev: %.1e %.1e %.1e) OK"
          % (res["n_devices"], res["mesh"][0], res["mesh"][1], res["E_mf"],
             res["E_imp"], res["fit_err"], res["err_mf"], res["err_h1"],
             res["err_eri"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
