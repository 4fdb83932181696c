"""A kernel's share of its roofline from the traced window: the least time
its launches could take (bytes once over the HBM rate or f64 operations
over the f64 peak, whichever is larger, from the frozen counts in
``metrics/``) over the device time the trace gives them."""

from __future__ import annotations

from .peaks import F64_FLOP_PER_S, HBM_BYTES_PER_S


def least_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F64_FLOP_PER_S)


def kernel_time(run, match):
    """(launches, device seconds) of the traced kernels whose name
    ``match`` accepts."""
    lo, hi = run.trace.window
    count, ns = 0, 0
    for name, s, e in run.trace.device:
        if e > lo and s < hi and match(name):
            count += 1
            ns += e - s
    return count, ns / 1e9


def share(run, match, per_launch) -> float | None:
    """100 x (launches x the least time of one launch) / device time; None
    without a trace or without such a launch."""
    if run.trace is None:
        return None
    count, seconds = kernel_time(run, match)
    if count == 0 or seconds <= 0:
        return None
    return 100.0 * count * least_s(*per_launch) / seconds
