#!/usr/bin/env python
"""
Quickstart: self-consistent DMET in one call.

1D Hubbard chain (18 sites, U/t = 4, half filling, 2-site impurity),
FCI impurity solver, non-interacting bath.  Reproduces the reference
energy per site -0.5527339 (gkclab/libdmet_preview's own integration
test value) in ~15 iterations.

Run: python examples/00_quickstart.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import numpy as np
import libdmet_preview_tpu.dmet.hubbard as dmet
from libdmet_preview_tpu.dmet.loop import run_dmet
from libdmet_preview_tpu.utils.config import DmetConfig

Lat = dmet.ChainLattice(18, 2)
Lat.set_Ham(dmet.Ham(Lat, 4.0), use_hcore_as_emb_ham=True)
vcor = dmet.PMInitGuess([2], 4.0, 0.5)

res = run_dmet(Lat, vcor,
               DmetConfig(filling=0.5, restricted=False, int_bath=False,
                          solver="FCI", max_iter=25))

print("converged        :", res.converged)
print("energy per site  : %.9f  (reference -0.552733945)" % res.e_per_site)
print("impurity filling : %.6f" % res.nelec_imp)
print("iterations       : %d" % len(res.history))
