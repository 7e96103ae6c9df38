"""Device time from a JAX profiler trace.

``device_time(fn, reps)`` runs ``fn`` (which must block on its result)
``reps`` times under ``jax.profiler.trace`` and reduces the trace to what
the GPU did: busy time (union of the intervals of every operation on the
device's stream lines) per call, and the kernels that took the most time.
Times are device times; the host clock plays no part.
"""

from __future__ import annotations

import collections
import glob
import os
import shutil
import tempfile

import jax


def _device_lines(path):
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # derived lines ("XLA Modules", "XLA Ops", "Steps") repeat the
            # stream lines' activity at coarser grain
            if line.name.startswith("Stream"):
                yield plane.name, line


def reduce_trace(path: str, reps: int, top: int = 8) -> dict:
    """Busy ns per call and the top kernels (ns per call) of a trace."""
    intervals = collections.defaultdict(list)
    kernels = collections.Counter()
    lines = set()
    for plane, line in _device_lines(path):
        lines.add(f"{plane}/{line.name}")
        for ev in line.events:
            s, d = float(ev.start_ns), float(ev.duration_ns)
            intervals[plane].append((s, s + d))
            kernels[ev.name] += d
    busy = 0.0
    for iv in intervals.values():
        iv.sort()
        end = -1.0
        for s, e in iv:
            if s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
    return dict(
        busy_ns_per_call=busy / reps,
        lines=sorted(lines),
        top_kernels=[(k, v / reps) for k, v in kernels.most_common(top)],
    )


def device_time(fn, reps: int = 10, top: int = 8) -> dict:
    """Trace ``reps`` calls of ``fn`` (warmed up by the caller)."""
    d = tempfile.mkdtemp(prefix="devtrace_")
    try:
        with jax.profiler.trace(d):
            for _ in range(reps):
                fn()
        paths = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                          recursive=True)
        return reduce_trace(paths[0], reps, top)
    finally:
        shutil.rmtree(d, ignore_errors=True)
