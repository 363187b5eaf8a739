"""
Profiling / tracing hooks (SURVEY 5: the reference has only log-line
timestamps; first-class jax.profiler + per-phase timers are part of this
build's auxiliary subsystems).
"""

import contextlib
import time

import jax

from libdmet_preview_tpu.utils import logger as log

_timings = {}


@contextlib.contextmanager
def phase(name):
    """Accumulating wall-clock timer for a DMET phase; also emits a
    jax.profiler TraceAnnotation so device traces are labeled."""
    t0 = time.perf_counter()
    with jax.profiler.TraceAnnotation(name):
        yield
    dt = time.perf_counter() - t0
    total, count = _timings.get(name, (0.0, 0))
    _timings[name] = (total + dt, count + 1)


def report(reset=False):
    """Log and return the accumulated phase timings."""
    out = {}
    for name, (total, count) in sorted(_timings.items()):
        log.result("phase %-24s  total %10.3f s  calls %5d  avg %8.3f ms",
                   name, total, count, total / count * 1e3)
        out[name] = {"total_s": total, "calls": count}
    if reset:
        _timings.clear()
    return out


@contextlib.contextmanager
def device_trace(logdir):
    """Capture a full jax.profiler trace (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
