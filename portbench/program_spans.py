"""The program's fleet calls in a traced window, from the program's own
profiler ranges.

The port names each fleet call with a range, ``jgt.nr_fleet`` or
``jgt.se_fleet``, that holds its stages (``jgt.fill``, ``jgt.test``, ...:
``juliagrid_tpu_torch/parallel/batch.py``). ``TraceData`` keeps each such
range's start and name among the host operations, not its end: a call
ends where the benchmark's ``portbench.solve`` span around it ends, as an
entry's ``solve`` returns the fleet call's result and launches nothing
after it. A trace of a program without these ranges has no calls, and
the readers built on this module return None.
"""

from __future__ import annotations

import numpy as np

from .harness import SPANS

CALLS = ("jgt.nr_fleet", "jgt.se_fleet")
SOLVE_SPAN = SPANS[1]
#: host calls that put a kernel, a memset or a copy on a stream (runtime
#: and driver API), by the name's stem before any ``_`` suffix
LAUNCH_STEMS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cudaMemcpy",
                "cudaMemset", "cuMemcpy", "cuMemset")
#: host calls that wait on the device: synchronizes and synchronous copies
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cuStreamSynchronize",
                   "cuCtxSynchronize", "cuEventSynchronize", "cudaMemcpy",
                   "cudaMemcpy2D", "cuMemcpy", "cuMemcpyDtoH",
                   "cuMemcpyHtoD", "cuMemcpyDtoD"})


def stem(name: str) -> str:
    """``name`` without a ``_v2``, ``_ptsz`` or like suffix."""
    return name.split("_", 1)[0]


def is_launch(name: str) -> bool:
    return stem(name).startswith(LAUNCH_STEMS)


def is_sync(name: str) -> bool:
    return stem(name) in SYNCS


def calls(trace) -> np.ndarray:
    """``[k, 2]`` start and end (ns) of the window's fleet calls, by
    start: a call range's start and the end of the ``portbench.solve``
    span that holds it."""
    none = np.zeros((0, 2), dtype=np.int64)
    if trace is None:
        return none
    lo, hi = trace.window
    starts, names = trace.host_ops
    at = np.asarray([t for t, name in zip(starts, names)
                     if name in CALLS and lo <= t <= hi], dtype=np.int64)
    solve = np.asarray([(s, e) for s, e, name in trace.spans
                        if name == SOLVE_SPAN], dtype=np.int64)
    if not len(at) or not len(solve):
        return none
    k = np.searchsorted(solve[:, 0], at, side="right") - 1
    held = (k >= 0) & (solve[np.maximum(k, 0), 1] >= at)
    return np.stack([at[held], solve[k[held], 1]], axis=1)


def ops_per_call(trace, match) -> float | None:
    """Host operations whose name ``match`` accepts, begun inside the
    fleet calls, over the number of calls; None without a call."""
    spans = calls(trace)
    if not len(spans):
        return None
    starts, names = trace.host_ops
    hit = np.asarray([t for t, name in zip(starts, names) if match(name)],
                     dtype=np.int64)
    inside = np.searchsorted(hit, spans[:, 1], side="right") - \
        np.searchsorted(hit, spans[:, 0], side="left")
    return float(inside.sum()) / len(spans)


def merged(intervals) -> np.ndarray:
    """``[k, 2]`` disjoint, sorted union of (start, end) intervals."""
    iv = sorted(intervals)
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.int64).reshape(-1, 2)


def busy_in(spans: np.ndarray, union: np.ndarray) -> np.ndarray:
    """Nanoseconds of each of ``spans`` covered by the disjoint, sorted
    intervals ``union``."""
    out = np.zeros(len(spans), dtype=np.int64)
    for i, (a, b) in enumerate(spans):
        j0 = np.searchsorted(union[:, 1], a, side="right")
        j1 = np.searchsorted(union[:, 0], b, side="left")
        part = union[j0:j1]
        if len(part):
            out[i] = (np.minimum(part[:, 1], b)
                      - np.maximum(part[:, 0], a)).sum()
    return out
