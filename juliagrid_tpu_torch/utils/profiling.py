"""Host wall-clock spans (reference ``@time`` culture in verbose output).

Named wall-clock sections (build / iterate / postprocess) accumulated per
analysis and printable as a table. Driver code wraps its phases in
``span`` so every solve carries its own timing breakdown
(``analysis.method.timings``) without external tooling. Set-up work
records into the process-wide ``default_timings``: ``kernels.load`` (a
kernel library's whole load, once per library), ``kernels.build`` (its
nvcc run alone, so the count says how many this process built) and
``tables.build`` (a host-built kernel table at its first use: K3's
descriptor table and entry positions, K8's gain table and its band lists).

Spans measure *host-observed* wall time: a CUDA launch returns before the
device finishes, so drivers that want honest numbers end the span at a
host readback (ours do — every iteration reads its mismatch back).

Stages: a solver calls ``mark(name)`` where a stage begins; the stage ends
at the next mark, and ``mark(None)`` ends it with no new one. The fleets
and the SE increment end their last stage with ``mark(None)`` in a
``finally``, so none outlives the function that opened it. Inside a
``device_stages()`` block each mark records a CUDA event on the current
stream, so the time from one mark to the next is the named stage's card
time. While ``torch.profiler`` records, each stage is also a profiler
range named ``jgt.<name>``, on the trace's clock beside the card's
activity. The fleets (``parallel/batch.py``) mark ``fill``, ``gain``,
``solve``, ``test`` and ``update``; a single Newton-Raphson
``power_flow`` (``powerflow/driver.py``) marks ``refresh``, then ``fill``,
``test`` and ``solve``; the BBD paths, the interior point and the mesh's
all-reduce mark their own. With neither a profiler nor a
``device_stages`` block active a mark costs a few flag tests: no event,
no range.

Device traces: ``trace(logdir)`` wraps ``torch.profiler`` so a real solve
can be captured with the card's kernels and inspected as a Chrome trace
(chrome://tracing, Perfetto); ``annotate(name)`` names a region in it (the
fleets' call spans ``jgt.nr_fleet`` and ``jgt.se_fleet`` and the single
Newton-Raphson call's ``jgt.power_flow``, which hold their stages) and
costs nothing while no profiler records.
"""

from __future__ import annotations

import contextlib
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from ..config import resolve_device


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


@contextmanager
def span(name: str, timings: Timings | None = None):
    """Time a section into ``timings`` (or the process-wide registry)."""
    target = timings if timings is not None else default_timings
    with target.span(name):
        yield


@contextmanager
def trace(logdir: str, device=None):
    """Profile the block and write a Chrome trace into ``logdir``; yields
    the trace file's path, written when the block ends.

    On ``device`` (default ``config.device``) ``"cuda"`` the trace records
    the host and the card's kernels, and raises when the profiler cannot
    record CUDA activity or the trace holds no device event: a trace
    without the card's events would hide what it exists to show. With
    ``device="cpu"`` it records the host only."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    on_card = resolve_device(device).type == "cuda"
    if on_card:
        if torch.profiler.ProfilerActivity.CUDA not in \
                torch.profiler.supported_activities():
            raise RuntimeError("torch.profiler cannot record CUDA activity "
                               "here")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    # the raw events: prof.events() would first build an EventList of
    # every event in Python, tens of seconds for a 10k-bus solve's trace
    events = prof.profiler.kineto_results.events()
    if on_card and not any(e.device_type() == torch.autograd.DeviceType.CUDA
                           for e in events):
        raise RuntimeError("the trace holds no device event")
    prof.export_chrome_trace(path)


#: what ``annotate`` gives while no profiler records
_OFF = contextlib.nullcontext()
#: the prefix of a stage's profiler range
PREFIX = "jgt."
#: a stage's range: a RecordFunction entered and left from C++ without a
#: dispatcher call, about 1.5 µs a range on the card's host where
#: ``record_function`` takes about 14 (NVIDIA H100 host, CPU and CUDA
#: activity profiled)
_stage_range = torch._C._profiler._RecordFunctionFast


def _recording() -> bool:
    """True while a ``torch.profiler`` (any RecordFunction profiler) is
    recording."""
    return torch._C._autograd._profiler_enabled()


def annotate(name: str):
    """A named range in a ``trace`` (``torch.profiler.record_function``);
    a context manager. While no profiler records it is a null context and
    makes no range."""
    return torch.profiler.record_function(name) if _recording() else _OFF


#: (name, CUDA event) of each mark while a ``device_stages()`` block records
_marks: list | None = None
#: the profiler range of the open stage, while a profiler records
_range = None


def mark(name: str | None):
    """Begin the stage ``name`` (None: no stage); it ends at the next
    mark. Inside a ``device_stages()`` block it records a CUDA event on
    the current stream; while a profiler records it ends the open range
    and opens the RecordFunction ``jgt.<name>``. Otherwise it does
    nothing."""
    global _range
    if _marks is not None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        _marks.append((name, event))
    if _range is not None:
        _range.__exit__(None, None, None)
        _range = None
    if name is not None and _recording():
        _range = _stage_range(PREFIX + name)
        _range.__enter__()


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
