"""The readers of the program's fleet-call ranges on hand-made traces: each
gives its exact value, a trace without the program's ranges gives None,
and the readers that were there give the same value on one trace with and
without the ranges and their device-side annotations."""

import json

import numpy as np
import pytest

from portbench import program_spans
from portbench.harness import (SPANS, WINDOW_SPAN, Call, Run, TraceData,
                               _read_trace, run_cell)
from portbench.spec import Spec

from .conftest import ROOT

NEW = ("loop_idle_pct", "launches_per_call", "syncs_per_call")
SEED = 2 ** 31 + 91

#: two fleet calls in the window (0, 1000), their solve spans (100, 400)
#: and (500, 800); host operations by start, the stages nested in calls
HOST = [(50, "cudaLaunchKernel"), (110, "jgt.se_fleet"), (115, "jgt.fill"),
        (120, "cuLaunchKernel"), (130, "jgt.gain"), (140, "cudaLaunchKernel"),
        (150, "jgt.solve"), (160, "cudaMemsetAsync"), (170, "jgt.test"),
        (175, "cudaMemcpyAsync"), (180, "cudaStreamSynchronize"),
        (190, "aten::any"), (410, "cudaMemcpyAsync"),
        (415, "cudaStreamSynchronize"), (510, "jgt.se_fleet"),
        (520, "jgt.fill"), (530, "cudaLaunchKernel_ptsz"),
        (600, "cudaStreamSynchronize"), (700, "cudaMemcpy"),
        (710, "cudaEventRecord")]
SOLVES = [(100, 400, SPANS[1]), (500, 800, SPANS[1])]
#: kernels, a memset and a copy: 130-250 and 390-400 of the first call
#: and 550-600 of the second are busy, 900-950 lies outside both
DEVICE = [("gain_fleet_kernel", 130, 200),
          ("fleet_solve_kernel<true>", 180, 250),
          ("Memcpy DtoH (Device -> Pageable)", 390, 420),
          ("se_entries_minor_kernel", 550, 600),
          ("Memset (Device)", 900, 950)]


def _trace(host=HOST, device=DEVICE, spans=SOLVES):
    return TraceData(window=(0, 1000), device=list(device),
                     host_ops=(np.asarray([t for t, _ in host],
                                          dtype=np.int64),
                               [name for _, name in host]),
                     spans=tuple(sorted(spans)))


def _run(trace, calls=()):
    return Run(batch=32, setup_s=1.0, host_build_s=0.1, calls=list(calls),
               window_s=1e-6, peak_window_bytes=0,
               shape=dict(n=14, nnz=54, branches=20, order=22,
                          jac_entries=200, states=27, rows=120,
                          entries=500, gain_lower=150, pairs=900,
                          extra_solves=1),
               trace=trace)


def _read(name, run):
    return Spec(ROOT).reader(name).read(run)


def test_call_spans_end_with_their_solve_span():
    np.testing.assert_array_equal(program_spans.calls(_trace()),
                                  [[110, 400], [510, 800]])


def test_each_reader_gives_its_exact_value():
    run = _run(_trace())
    # launches: 120 (in the nested jgt.fill), 140, 160, 175; 530, 700
    assert _read("launches_per_call", run) == 3.0
    # waits: 180; 600 and the synchronous copy at 700
    assert _read("syncs_per_call", run) == 1.5
    busy = (250 - 130) + (400 - 390) + (600 - 550)
    assert _read("loop_idle_pct", run) == pytest.approx(
        100.0 * (1.0 - busy / (290 + 290)), abs=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_no_program_range_reads_none(name):
    bare = [(t, n) for t, n in HOST if not n.startswith("jgt.")]
    assert _read(name, _run(_trace(host=bare))) is None
    assert _read(name, _run(None)) is None


def test_names_of_launches_and_waits():
    assert all(map(program_spans.is_launch, (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
        "cuMemsetD8Async", "cudaLaunchKernel_ptsz")))
    assert not any(map(program_spans.is_launch, (
        "cudaStreamSynchronize", "cudaEventRecord", "aten::copy_",
        "cudaGetDevice", "jgt.fill")))
    assert all(map(program_spans.is_sync, (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize", "cudaMemcpy", "cuMemcpyDtoH_v2")))
    assert not any(map(program_spans.is_sync, (
        "cudaMemcpyAsync", "cudaLaunchKernel", "cudaStreamWaitEvent")))


@pytest.mark.parametrize("name,value", [("kernel_load_s", 2.5),
                                        ("table_build_s", 0.25)])
def test_set_up_spans_are_read_from_the_programs_timings(monkeypatch, name,
                                                         value):
    from juliagrid_tpu_torch.utils.profiling import default_timings
    span = {"kernel_load_s": "kernels.load",
            "table_build_s": "tables.build"}[name]
    monkeypatch.setattr(default_timings, "spans", {span: (3, value)})
    assert _read(name, _run(None)) == value
    monkeypatch.setattr(default_timings, "spans", {})
    assert _read(name, _run(None)) is None


class _Event:
    def __init__(self, name, start, end, cuda=False, annotation=False):
        self._name, self._start, self._end = name, start, end
        self._cuda, self._annotation = cuda, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA if self._cuda \
            else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._annotation


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _events(with_program: bool) -> list:
    """A window's raw events: the benchmark's spans on the host and as
    device-side annotations, host operations, and device activity; with
    the program's ranges, its call spans and stages on the host and each
    as a device-side annotation over the work it launched."""
    ev = [_Event(WINDOW_SPAN, 0, 1000, annotation=True)]
    for s, e, name in SOLVES:
        ev.append(_Event(name, s, e, annotation=True))
        ev.append(_Event(name, s + 5, e + 5, cuda=True, annotation=True))
    ev += [_Event(name, t, t + 3) for t, name in HOST
           if not name.startswith("jgt.")]
    ev += [_Event(name, s, e, cuda=True) for name, s, e in DEVICE]
    ev.append(_Event("dgemv_kernel", 205, 215, cuda=True))
    ev.append(_Event("potrf_kernel", 560, 590, cuda=True))
    if with_program:
        starts = [(t, n) for t, n in HOST if n.startswith("jgt.")]
        for (t, name), nxt in zip(starts, starts[1:] + [(1000, None)]):
            end = 400 if t < 400 else 800
            ev.append(_Event(name, t, end if "fleet" in name
                             else min(nxt[0], end), annotation=True))
            ev.append(_Event(name, t + 20, end, cuda=True,
                             annotation=True))
    return ev


def test_readers_that_were_there_read_the_same_with_program_ranges():
    spec = Spec(ROOT)
    names = [m["name"] for m in spec.doc["per_layer"]
             if m["name"] not in NEW
             and m["name"] not in ("kernel_load_s", "table_build_s")]
    calls = [Call(100, 400, 32, 30, 90, 3), Call(500, 800, 32, 32, 64, 2)]
    without = _run(_read_trace(_Prof(_events(False))), calls)
    with_ranges = _run(_read_trace(_Prof(_events(True))), calls)
    # the ranges' device-side annotations are not device work
    assert with_ranges.trace.device == without.trace.device
    seen = 0
    for name in names:
        a = spec.reader(name).read(without)
        b = spec.reader(name).read(with_ranges)
        assert a == b, name
        seen += a is not None
    assert seen >= 5
    assert _read("launches_per_call", without) is None
    assert _read("launches_per_call", with_ranges) == 3.0


def test_a_traced_cpu_run_reads_the_program_ranges(small_root):
    """The readers on a real profiler's trace of a small SE cell on the
    CPU: two calls' ranges are found; the CPU launches nothing on a card,
    so no launch, no wait, and the calls are idle throughout."""
    doc = json.loads((small_root / "BENCHMARK.json").read_text())
    for m in doc["per_layer"]:
        if m["name"] in NEW + ("table_build_s",):
            m["workloads"].append("case118.se_small")
    (small_root / "BENCHMARK.json").write_text(json.dumps(doc))
    result, _ = run_cell(Spec(small_root), "case118.se_small", SEED, 0.5,
                         True, device="cpu")
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"]
    assert got["launches_per_call"] == 0.0
    assert got["syncs_per_call"] == 0.0
    assert got["loop_idle_pct"] == 100.0
    assert got["table_build_s"] > 0
