"""One run of one cell: set-up, a closed-loop window, the check, the result.

Set-up reads the case with the reference and works out what the mix draws
around (the estimator's base means come from the reference's power flow):
that span is the reference's, timed and left out of ``setup_s``, and its
device memory is freed before the program's peak is read. It then builds
the program (the host build, timed as ``host_build_s``) and makes one
warm-up call at the cell's own shape.
The window then sends calls back to back from one caller for ``seconds``:
each call's scenarios are made on the device from the seed and the call's
index, and a call is timed from its start to its states, counts and flags
held on the host. With a trace the window runs under ``torch.profiler``.
After the window the peak memory is read, the program is freed, the
calls kept for the check are compared with the reference, and the
metrics' readers (``metrics/<name>.py``) read the run.
"""

from __future__ import annotations

import contextlib
import gc
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import check
from .generator import Traffic
from .reference.case import load_case
from .reference.grid import Grid
from .spec import Spec

#: top-level module names the measured process must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "juliagrid_tpu")
#: host spans of the window, read by the trace's idle-gap labels
SPANS = ("portbench.inputs", "portbench.solve", "portbench.readback")
WINDOW_SPAN = "portbench.window"


def process_age() -> float:
    """Seconds since this process started (Linux), for ``setup_s``."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules(names=None) -> list:
    """The top-level names of ``names`` (default: the loaded modules) that
    are in ``FORBIDDEN``, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


@dataclass
class Call:
    start: float
    end: float
    scenarios: int
    converged: int
    iterations: int        # summed over the call's scenarios
    lockstep: int          # the loop's trips: the call's largest count


@dataclass
class TraceData:
    """The traced window's device activity and host spans (ns)."""

    window: tuple
    device: list           # (name, start, end) of kernels, copies, sets
    host_ops: tuple        # sorted starts and names of host operations
    spans: tuple           # sorted (start, end, name) of the window's spans


@dataclass
class Run:
    """What the metrics' readers read."""

    batch: int
    setup_s: float
    host_build_s: float
    calls: list
    window_s: float
    peak_window_bytes: int
    shape: dict
    trace: TraceData | None = None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _read_trace(prof, window_name=WINDOW_SPAN) -> TraceData:
    device_type = torch.autograd.DeviceType.CUDA
    dev, host_start, host_name, spans = [], [], [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == device_type:
            # the spans' own ranges on the device's timeline are not work
            if not e.is_user_annotation() and name not in SPANS \
                    and name != window_name:
                dev.append((name, e.start_ns(), e.end_ns()))
            continue
        if name == window_name:
            window = (e.start_ns(), e.end_ns())
        elif name in SPANS:
            spans.append((e.start_ns(), e.end_ns(), name))
        else:
            host_start.append(e.start_ns())
            host_name.append(name)
    order = np.argsort(np.asarray(host_start, dtype=np.int64), kind="stable")
    starts = np.asarray(host_start, dtype=np.int64)[order]
    names = [host_name[i] for i in order]
    spans.sort()
    return TraceData(window=window, device=dev, host_ops=(starts, names),
                     spans=tuple(spans))


def busy_ns(trace: TraceData) -> int:
    """Nanoseconds of the window in which any device activity ran."""
    lo, hi = trace.window
    iv = sorted((max(s, lo), min(e, hi)) for _, s, e in trace.device
                if e > lo and s < hi)
    total, cur_s, cur_e = 0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(trace: TraceData, top: int = 10) -> list:
    """Idle device time in the window, summed by what the host was doing
    at each gap's middle: the window span it was in and the last host
    operation begun before it."""
    lo, hi = trace.window
    iv = sorted((max(s, lo), min(e, hi)) for _, s, e in trace.device
                if e > lo and s < hi)
    gaps, edge = [], lo
    for s, e in iv:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if hi > edge:
        gaps.append((edge, hi))
    if not gaps:
        return []
    g = np.asarray(gaps, dtype=np.int64)
    mid = (g[:, 0] + g[:, 1]) // 2
    starts, names = trace.host_ops
    span_s = np.asarray([s for s, _, _ in trace.spans], dtype=np.int64)
    span_e = np.asarray([e for _, e, _ in trace.spans], dtype=np.int64)
    at_op = np.searchsorted(starts, mid, side="right") - 1
    at_span = np.searchsorted(span_s, mid, side="right") - 1
    sums = {}
    for k in range(len(g)):
        sp = "python"
        if at_span[k] >= 0 and span_e[at_span[k]] >= mid[k]:
            sp = trace.spans[at_span[k]][2]
        op = names[at_op[k]] if at_op[k] >= 0 else "none"
        label = f"{sp}: {op}"
        sums[label] = sums.get(label, 0) + int(g[k, 1] - g[k, 0])
    best = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in best]


def device_ops(trace: TraceData, top: int = 10) -> list:
    lo, hi = trace.window
    sums = {}
    for name, s, e in trace.device:
        if e > lo and s < hi:
            sums[name] = sums.get(name, 0) + (min(e, hi) - max(s, lo))
    best = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in best]


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the cards, or why not."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"not read: {err}"
    return res.stdout.strip() or f"not read: {res.stderr.strip()}"


class Sampler:
    """Keeps ``k`` calls' outputs drawn uniformly from the seed (reservoir
    sampling over a stream whose length the window decides), and the call
    with the most iterations."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.kept = []
        self.seen = 0
        self.longest = (-1, None, None)

    def offer(self, index, outputs, lockstep):
        if lockstep > self.longest[0]:
            self.longest = (lockstep, index, outputs)
        if len(self.kept) < self.k:
            self.kept.append((index, outputs))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = (index, outputs)
        self.seen += 1

    def calls(self) -> list:
        out = dict(self.kept)
        if self.longest[1] is not None:
            out[self.longest[1]] = self.longest[2]
        return sorted(out.items())


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             trace: bool, device="cuda", program=None):
    """Run ``workload`` once. Returns the result line's object and the
    forbidden modules (``FORBIDDEN``) the process held once the window
    had closed.

    ``program``, if given, makes the system under test in place of the
    entry's ``build`` (the control, a test's faults), with the same
    arguments."""
    device = torch.device(device)
    cell = spec.workload(workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(workload)
    entry = spec.entry(traffic["entry"])
    case_path = spec.path(config["case"])

    # the reference's reading of the case and what the mix draws around:
    # its time is not set-up, its memory not the program's peak
    t0 = time.perf_counter()
    case = load_case(str(case_path))
    prep = entry.prepare(case, config, device)
    _sync(device)
    reference_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    chunk = entry.chunk(case, prep)

    t0 = time.perf_counter()
    sut = (program or entry.build)(case_path, traffic, device, prep)
    _sync(device)
    host_build_s = time.perf_counter() - t0

    gen = Traffic(traffic, entry, case, prep, device, seed)
    sut.solve(gen.call("warmup"))
    _sync(device)
    if device.type == "cuda":
        before_window = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age() - reference_s

    sampler = Sampler(int(traffic["check_calls"]), seed)
    calls = []
    prof = contextlib.nullcontext()
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    rf = torch.profiler.record_function
    with prof, rf(WINDOW_SPAN):
        w0 = time.perf_counter()
        index = 0
        while index == 0 or time.perf_counter() - w0 < seconds:
            with rf(SPANS[0]):
                inputs = gen.call(index)
            start = time.perf_counter()
            with rf(SPANS[1]):
                outputs = sut.solve(inputs)
            with rf(SPANS[2]):
                host = tuple(x.cpu() for x in outputs)
            end = time.perf_counter()
            it, cv = host[2], host[3]
            lockstep = int(it.max())
            calls.append(Call(start, end, int(it.numel()), int(cv.sum()),
                              int(it.sum()), lockstep))
            sampler.offer(index, host, lockstep)
            index += 1
        window_s = time.perf_counter() - w0
    tdata = None
    if trace:
        tdata = _read_trace(prof)
        if tdata.window is None:
            raise RuntimeError("the trace holds no window span")
    del prof

    peak_window = 0
    memory_peak = 0
    if device.type == "cuda":
        peak_window = torch.cuda.max_memory_allocated(device)
        memory_peak = max(before_window, peak_window)
    found = forbidden_modules()
    del sut, outputs, inputs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    grid = Grid.build(case, device)
    verdict = check.judge(
        sampler.calls(), gen.call,
        lambda inp: entry.reference_solve(grid, prep, traffic, inp, chunk),
        limits)
    run = Run(batch=gen.batch,
              setup_s=setup_s, host_build_s=host_build_s, calls=calls,
              window_s=window_s, peak_window_bytes=peak_window,
              shape=entry.shape(case, prep), trace=tdata)
    metrics = {}
    for m in spec.metrics(workload, trace):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    attempted = sum(c.scenarios for c in calls)
    converged = sum(c.converged for c in calls)
    if device.type == "cuda":
        dev = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                   count=1, memory_peak_bytes=int(memory_peak),
                   power=power_limit())
    else:
        dev = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    result = dict(correct=verdict["correct"], attempted=attempted,
                  failed=attempted - converged, metrics=metrics, device=dev)
    if tdata is not None:
        dev["busy_s"] = busy_ns(tdata) / 1e9
        dev["window_s"] = (tdata.window[1] - tdata.window[0]) / 1e9
        result["breakdown"] = dict(device_ops=device_ops(tdata),
                                   idle_gaps=idle_gaps(tdata))
    result["checks"] = verdict["checks"]
    print(f"{workload} seed {seed}: {len(calls)} calls, {attempted} "
          f"scenarios, {converged} converged; checked {verdict['calls']} "
          f"calls, {verdict['scenarios']} scenarios", file=sys.stderr,
          flush=True)
    return result, found
