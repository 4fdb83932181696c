"""Host wall-clock spans (reference ``@time`` culture in verbose output).

Named wall-clock sections (build / iterate / postprocess) accumulated per
analysis and printable as a table. Driver code wraps its phases in
``span`` so every solve carries its own timing breakdown
(``analysis.method.timings``) without external tooling.

Spans measure *host-observed* wall time: a CUDA launch returns before the
device finishes, so drivers that want honest numbers end the span at a
host readback (ours do — every iteration reads its mismatch back).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


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
