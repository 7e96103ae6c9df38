"""Profiling / tracing hooks.

The reference integrates the Tracy frame profiler via ~80 zone macros
compiled in under BUILD_WITH_TRACY (/root/reference/include/piqp/utils/
tracy.hpp:11-26) plus built-in phase timers filling Info
(timer.hpp:17-35, results.hpp:83-88).  The JAX analogs:

- :func:`trace`: capture an XLA device trace viewable in TensorBoard /
  Perfetto — the device-side replacement for frame profiling (per-kernel
  timing, HBM traffic, fusion boundaries).
- :func:`annotate`: name a region so it shows up in the trace timeline
  (the Zone macro analog).
- Wall-clock phase timings are host-side in DenseSolver (Settings(
  compute_timings=True)); on-device per-phase timing is meaningless under
  XLA fusion — the trace IS the authoritative breakdown.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace of everything run inside the context.

    View with: tensorboard --logdir <log_dir>  (or load the contained
    .trace.json.gz into Perfetto).
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region context manager for trace timelines
    (jax.profiler.TraceAnnotation; the PIQP_TRACY_ZoneScopedN analog)."""
    return jax.profiler.TraceAnnotation(name)
