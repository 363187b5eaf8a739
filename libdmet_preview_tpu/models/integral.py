"""
Embedding-Hamiltonian container + FCIDUMP/HDF5 I/O
(JAX rewrite of reference system/integral.py:60-930).

Integral is a plain pytree-style container:
  H0: scalar
  H1: {"cd": (spin, n, n)}            spin = 1 (restricted) or 2
  H2: {"ccdd": (spin_pair, ...)}      spin_pair = 1 or 3, order [aa, bb, ab]
  ovlp: (n, n) or (spin, n, n) or None
"""

import numpy as np

from libdmet_preview_tpu.utils import logger as log


class Integral(object):
    def __init__(self, norb, restricted, bogoliubov, H0, H1, H2, ovlp=None):
        self.norb = norb
        self.restricted = restricted
        self.bogoliubov = bogoliubov
        self.H0 = H0
        log.eassert(H1 is not None and H2 is not None,
                    "H1 and H2 cannot be None")
        self.H1 = {k: np.asarray(v) for k, v in H1.items()}
        self.H2 = {k: (v if not isinstance(v, np.ndarray) else np.asarray(v))
                   for k, v in H2.items()}
        self.ovlp = ovlp

    def copy(self):
        import copy as _copy
        return _copy.deepcopy(self)

    def __str__(self):
        return ("Integral(norb=%d, restricted=%s, bogoliubov=%s)"
                % (self.norb, self.restricted, self.bogoliubov))


def get_eri_format(eri, norb):
    """Detect ERI symmetry format: s1 / s4 / s8 and spin dimension
    (reference integral.py:883-930)."""
    eri = np.asarray(eri)
    npair = norb * (norb + 1) // 2
    if eri.ndim == 4:
        return "s1", 0
    if eri.ndim == 2:
        if eri.shape == (npair, npair):
            return "s4", 0
        elif eri.ndim == 2 and eri.size == npair * (npair + 1) // 2:
            return "s8", 0
    if eri.ndim == 5:
        return "s1", eri.shape[0]
    if eri.ndim == 3:
        if eri.shape[-2:] == (npair, npair):
            return "s4", eri.shape[0]
        else:
            return "s8", eri.shape[0]
    if eri.ndim == 1:
        return "s8", 0
    raise ValueError("cannot detect eri format for shape %s" % str(eri.shape))


def restore_eri(eri, norb, symmetry=1):
    """Convert ERI between s1/s4/s8 storage (minimal ao2mo.restore clone)."""
    eri = np.asarray(eri)
    fmt, spin = get_eri_format(eri, norb)
    if spin:
        return np.asarray([restore_eri(e, norb, symmetry) for e in eri])
    npair = norb * (norb + 1) // 2
    tril = np.tril_indices(norb)
    if fmt == "s8" and symmetry == 8:
        return eri
    if fmt == "s8":
        # unpack to s4 first
        s4 = np.zeros((npair, npair))
        tp = np.tril_indices(npair)
        s4[tp] = eri
        s4 = s4 + s4.T - np.diag(np.diag(s4))
        eri, fmt = s4, "s4"
    if fmt == "s4" and symmetry == 1:
        full = np.zeros((norb,) * 4)
        tmp = np.zeros((norb, norb, npair))
        tmp[tril[0], tril[1]] = eri
        tmp[tril[1], tril[0]] = eri
        full_flat = tmp  # (i, j, kl-pair)
        full[:, :, tril[0], tril[1]] = full_flat
        full[:, :, tril[1], tril[0]] = full_flat
        return full
    if fmt == "s1" and symmetry == 4:
        return eri[:, :, tril[0], tril[1]][tril[0], tril[1]]
    if fmt == "s1" and symmetry == 1:
        return eri
    if fmt == "s4" and symmetry == 4:
        return eri
    if fmt == "s1" and symmetry == 8:
        s4 = restore_eri(eri, norb, 4)
        tp = np.tril_indices(npair)
        return s4[tp]
    if fmt == "s4" and symmetry == 8:
        tp = np.tril_indices(npair)
        return eri[tp]
    raise NotImplementedError("restore %s -> s%d" % (fmt, symmetry))


# ----------------------------------------------------------------------
# FCIDUMP (reference integral.py:128-790); needed for the external-solver
# bridges (DMRG/SHCI) and oracle tests
# ----------------------------------------------------------------------

def dump_FCIDUMP(filename, integral_obj, thr=1e-12, nelec=None, spin_sz=0):
    ints = integral_obj
    norb = ints.norb
    if nelec is None:
        nelec = norb
    with open(filename, "w") as f:
        f.write(" &FCI NORB= %d,NELEC= %d,MS2= %d,\n" % (norb, nelec, spin_sz))
        f.write("  ORBSYM=" + "1," * norb + "\n")
        f.write("  ISYM=1,\n")
        if not ints.restricted:
            f.write("  IUHF=1,\n")
        f.write(" &END\n")

        def wr(val, i, j, k, l):
            if abs(val) > thr:
                f.write(" %19.12E %4d %4d %4d %4d\n" % (val, i, j, k, l))

        H2 = ints.H2["ccdd"]
        if H2[0].ndim == 2:
            H2 = np.asarray([restore_eri(h, norb, 1) for h in H2])
        if ints.restricted:
            eri = H2[0]
            for i in range(norb):
                for j in range(i + 1):
                    for k in range(i + 1):
                        lmax = j + 1 if k == i else k + 1
                        for l in range(lmax):
                            wr(eri[i, j, k, l], i + 1, j + 1, k + 1, l + 1)
            h1 = ints.H1["cd"][0]
            for i in range(norb):
                for j in range(i + 1):
                    wr(h1[i, j], i + 1, j + 1, 0, 0)
            f.write(" %19.12E %4d %4d %4d %4d\n" % (ints.H0, 0, 0, 0, 0))
        else:
            # UHF FCIDUMP: aa, bb, ab blocks separated by 0 0 0 0 lines
            for s, eri in enumerate(H2):
                for i in range(norb):
                    for j in range(norb):
                        for k in range(norb):
                            for l in range(norb):
                                wr(eri[i, j, k, l], i + 1, j + 1, k + 1, l + 1)
                f.write(" %19.12E %4d %4d %4d %4d\n" % (0.0, 0, 0, 0, 0))
            for s in range(2):
                h1 = ints.H1["cd"][s]
                for i in range(norb):
                    for j in range(norb):
                        wr(h1[i, j], i + 1, j + 1, 0, 0)
                f.write(" %19.12E %4d %4d %4d %4d\n" % (0.0, 0, 0, 0, 0))
            f.write(" %19.12E %4d %4d %4d %4d\n" % (ints.H0, 0, 0, 0, 0))


def dump_FCIDUMP_ghf(filename, integral_obj, thr=1e-12, nelec=None,
                     spin_sz=0):
    """GHF (generalized spin-orbital) FCIDUMP writer (reference
    integral.py GHF variant, system/integral.py:128-668): one combined
    spin-orbital block, IUHF absent, IGENERAL=1 header flag.  The H1/H2
    of `integral_obj` are already spin-orbital (restricted=True storage
    with norb = number of spin orbitals) -- the convention the GSO /
    spinless embedding produces."""
    ints = integral_obj
    norb = ints.norb
    if nelec is None:
        nelec = norb // 2
    with open(filename, "w") as f:
        f.write(" &FCI NORB= %d,NELEC= %d,MS2= %d,\n"
                % (norb, nelec, spin_sz))
        f.write("  ORBSYM=" + "1," * norb + "\n")
        f.write("  ISYM=1,\n")
        f.write("  IGENERAL=1,\n")
        f.write(" &END\n")

        def wr(val, i, j, k, l):
            if abs(val) > thr:
                f.write(" %19.12E %4d %4d %4d %4d\n" % (val, i, j, k, l))

        H2 = ints.H2["ccdd"]
        eri = H2[0]
        if eri.ndim == 2:
            eri = restore_eri(eri, norb, 1)
        for i in range(norb):
            for j in range(i + 1):
                for k in range(i + 1):
                    lmax = j + 1 if k == i else k + 1
                    for l in range(lmax):
                        wr(eri[i, j, k, l], i + 1, j + 1, k + 1, l + 1)
        h1 = ints.H1["cd"][0]
        for i in range(norb):
            for j in range(i + 1):
                wr(h1[i, j], i + 1, j + 1, 0, 0)
        f.write(" %19.12E %4d %4d %4d %4d\n" % (ints.H0, 0, 0, 0, 0))


def read_FCIDUMP(filename, norb=None):
    """Read a restricted FCIDUMP into an Integral object."""
    with open(filename) as f:
        lines = f.readlines()
    header_end = 0
    norb_f = nelec_f = None
    for i, line in enumerate(lines):
        up = line.upper()
        if "NORB" in up:
            import re
            m = re.search(r"NORB\s*=\s*(\d+)", up)
            if m:
                norb_f = int(m.group(1))
            m = re.search(r"NELEC\s*=\s*(\d+)", up)
            if m:
                nelec_f = int(m.group(1))
        if "&END" in up or "/" == up.strip():
            header_end = i + 1
            break
    norb = norb_f if norb is None else norb
    H0 = 0.0
    h1 = np.zeros((norb, norb))
    eri = np.zeros((norb,) * 4)
    for line in lines[header_end:]:
        parts = line.split()
        if len(parts) != 5:
            continue
        val = float(parts[0])
        i, j, k, l = [int(x) for x in parts[1:]]
        if i == 0:
            H0 = val
        elif k == 0:
            h1[i - 1, j - 1] = h1[j - 1, i - 1] = val
        else:
            ii, jj, kk, ll = i - 1, j - 1, k - 1, l - 1
            for (a, b, c, d) in [(ii, jj, kk, ll), (jj, ii, kk, ll),
                                 (ii, jj, ll, kk), (jj, ii, ll, kk),
                                 (kk, ll, ii, jj), (ll, kk, ii, jj),
                                 (kk, ll, jj, ii), (ll, kk, jj, ii)]:
                eri[a, b, c, d] = val
    ints = Integral(norb, True, False, H0, {"cd": h1[None]},
                    {"ccdd": eri[None]})
    ints.nelec = nelec_f
    return ints


def save_h5(filename, integral_obj):
    import h5py
    with h5py.File(filename, "w") as f:
        f["norb"] = integral_obj.norb
        f["restricted"] = integral_obj.restricted
        f["bogoliubov"] = integral_obj.bogoliubov
        f["H0"] = integral_obj.H0
        for k, v in integral_obj.H1.items():
            f["H1/" + k] = v
        for k, v in integral_obj.H2.items():
            f["H2/" + k] = v
        if integral_obj.ovlp is not None:
            f["ovlp"] = integral_obj.ovlp


def load_h5(filename):
    import h5py
    with h5py.File(filename, "r") as f:
        H1 = {k: np.asarray(f["H1"][k]) for k in f["H1"]}
        H2 = {k: np.asarray(f["H2"][k]) for k in f["H2"]}
        ovlp = np.asarray(f["ovlp"]) if "ovlp" in f else None
        return Integral(int(f["norb"][()]), bool(f["restricted"][()]),
                        bool(f["bogoliubov"][()]), float(f["H0"][()]),
                        H1, H2, ovlp=ovlp)


def save_mmap(prefix, integral_obj):
    """Memory-mapped dump of the Integral's big tensors (reference
    integral.py:792-860 mmap dump + slater.py:391-396 shared-memory ERI
    role): each H1/H2 block goes to `prefix.<name>.npy` written with
    np.lib.format (mmap-loadable); metadata to `prefix.meta.npz`."""
    meta = {"norb": integral_obj.norb,
            "restricted": integral_obj.restricted,
            "bogoliubov": integral_obj.bogoliubov,
            "H0": integral_obj.H0,
            "h1_keys": sorted(integral_obj.H1),
            "h2_keys": sorted(integral_obj.H2),
            "has_ovlp": integral_obj.ovlp is not None}
    np.savez(prefix + ".meta.npz", **meta)
    for k in integral_obj.H1:
        np.save("%s.H1.%s.npy" % (prefix, k),
                np.asarray(integral_obj.H1[k]))
    for k in integral_obj.H2:
        np.save("%s.H2.%s.npy" % (prefix, k),
                np.asarray(integral_obj.H2[k]))
    if integral_obj.ovlp is not None:
        np.save(prefix + ".ovlp.npy", np.asarray(integral_obj.ovlp))


def load_mmap(prefix, mode="r"):
    """Load a save_mmap dump with the tensors memory-mapped (mode 'r'):
    H2 never materializes in RAM until sliced -- the >memory-ERI path."""
    meta = np.load(prefix + ".meta.npz", allow_pickle=True)
    H1 = {str(k): np.load("%s.H1.%s.npy" % (prefix, k), mmap_mode=mode)
          for k in meta["h1_keys"]}
    H2 = {str(k): np.load("%s.H2.%s.npy" % (prefix, k), mmap_mode=mode)
          for k in meta["h2_keys"]}
    ovlp = np.load(prefix + ".ovlp.npy", mmap_mode=mode) \
        if bool(meta["has_ovlp"]) else None
    return Integral(int(meta["norb"]), bool(meta["restricted"]),
                    bool(meta["bogoliubov"]), float(meta["H0"]),
                    H1, H2, ovlp=ovlp)
