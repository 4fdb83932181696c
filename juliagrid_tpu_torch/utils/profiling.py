"""Host wall-clock spans (reference ``@time`` culture in verbose output).

Named wall-clock sections (build / iterate / postprocess) accumulated per
analysis and printable as a table. Driver code wraps its phases in
``span`` so every solve carries its own timing breakdown
(``analysis.method.timings``) without external tooling.

Spans measure *host-observed* wall time: a CUDA launch returns before the
device finishes, so drivers that want honest numbers end the span at a
host readback (ours do — every iteration reads its mismatch back).

Device stages measure the card's time instead: a solver calls
``mark(name)`` where a stage begins, and inside a ``device_stages()`` block
each mark records a CUDA event on the current stream, so the time from one
mark to the next is the named stage's. Outside such a block ``mark`` does
nothing.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass
class Timings:
    """Named wall-clock accumulators: ``{name: [count, total_seconds]}``."""

    spans: dict = field(default_factory=dict)

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            cnt, tot = self.spans.get(name, (0, 0.0))
            self.spans[name] = (cnt + 1, tot + dt)

    def add(self, name: str, seconds: float):
        cnt, tot = self.spans.get(name, (0, 0.0))
        self.spans[name] = (cnt + 1, tot + seconds)

    def total(self, name: str) -> float:
        return self.spans.get(name, (0, 0.0))[1]

    def report(self, file=None) -> str:
        """Fixed-width table of accumulated spans (longest first)."""
        rows = sorted(self.spans.items(), key=lambda kv: -kv[1][1])
        wname = max([len("Phase")] + [len(k) for k, _ in rows])
        lines = [f"{'Phase':<{wname}}  {'Calls':>6}  {'Total [s]':>10}  "
                 f"{'Mean [ms]':>10}"]
        for name, (cnt, tot) in rows:
            mean_ms = 1e3 * tot / max(cnt, 1)
            lines.append(f"{name:<{wname}}  {cnt:>6}  {tot:>10.4f}  "
                         f"{mean_ms:>10.3f}")
        out = "\n".join(lines)
        if file is not None:
            print(out, file=file)
        return out


#: process-wide default registry (drivers record here too, so a process's
#: cumulative picture is one ``default_timings.report()`` away)
default_timings = Timings()

#: (name, CUDA event) of each mark while a ``device_stages()`` block records
_marks: list | None = None


def mark(name: str | None):
    """Begin the device stage ``name`` (None: no stage) on the current
    CUDA stream; it ends at the next mark. A no-op unless a
    ``device_stages()`` block is recording."""
    if _marks is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        _marks.append((name, event))


@contextmanager
def device_stages():
    """Record the marks of the code inside; yields a dict that holds
    ``{name: (count, total_ms)}`` of CUDA-event time once the block ends
    (the last stage ends with the block)."""
    global _marks
    if _marks is not None:
        raise RuntimeError("device_stages blocks do not nest")
    out: dict = {}
    _marks = []
    try:
        yield out
    finally:
        marks, _marks = _marks, None
        mark_end = torch.cuda.Event(enable_timing=True)
        mark_end.record()
        torch.cuda.synchronize()
        for (name, start), (_, stop) in zip(marks,
                                            marks[1:] + [(None, mark_end)]):
            if name is not None:
                cnt, tot = out.get(name, (0, 0.0))
                out[name] = (cnt + 1, tot + start.elapsed_time(stop))
