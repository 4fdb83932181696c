"""The share of the traced window in which no kernel, copy or memset ran
on the card (profiler CUDA activity)."""

from portbench.harness import busy_ns


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window
    return 100.0 * (1.0 - busy_ns(run.trace) / (hi - lo))
