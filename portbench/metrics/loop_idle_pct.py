"""The share of the program's fleet calls (``jgt.nr_fleet``,
``jgt.se_fleet``) in which no kernel, copy or memset ran on the card: idle
that the program causes, apart from the benchmark's input making and
readback (``device_idle_pct`` counts the whole window)."""

from portbench.program_spans import busy_in, calls, merged


def read(run):
    spans = calls(run.trace)
    if not len(spans):
        return None
    total = int((spans[:, 1] - spans[:, 0]).sum())
    if total <= 0:
        return None
    union = merged((s, e) for _, s, e in run.trace.device)
    return 100.0 * (1.0 - busy_in(spans, union).sum() / total)
