"""Split a benchmark cell's traced card time by the program's stages.

    python3 scripts/stage_split.py --workload case118.se_fleet \
        --seed 3000000001 --seconds 8 --windows on,off,on,off

Builds the cell as ``portbench/run.py`` does, warms it up, runs one
untraced window and then one traced window for each item of
``--windows``: ``on`` with the program's stage ranges (``jgt.*``), ``off``
with them disabled, so the two rates give the ranges' cost while a
profiler records. Each ``on`` trace is read with the kineto correlation
ids that ``portbench/harness.py`` does not keep: each device activity is
given the launch call it came from and the innermost program range open
at that launch, so every stage's device time per call, the device time no
stage holds (no linked launch, or a launch outside every stage) and the
idle gaps by the innermost range are printed beside what the benchmark's
readers give on the same trace. Needs the card; prints one JSON line per
window and writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

#: the port's hand-written kernels by a stem of their names
PORT_KERNELS = {"K1": ("nr_fill",), "K2": ("fleet_solve", "fleet_lu",
                                           "fleet_chol"),
                "K3": ("se_entries", "se_values", "se_fill"),
                "K8": ("gain_fleet", "gain_fill")}


def _kind(name: str) -> str:
    for k, stems in PORT_KERNELS.items():
        if any(s in name for s in stems):
            return k
    return "other"


def _window(sut, gen, seconds, start_index, profile, spans, device):
    """Closed-loop calls for ``seconds``: ``(solves, calls, seconds,
    next index, profiler or None)``."""
    import contextlib

    import torch
    rf = torch.profiler.record_function
    prof = contextlib.nullcontext()
    if profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    solved = calls = 0
    index = start_index
    with prof, rf(spans[3]):
        t0 = time.perf_counter()
        while calls == 0 or time.perf_counter() - t0 < seconds:
            with rf(spans[0]):
                inputs = gen.call(index)
            with rf(spans[1]):
                out = sut.solve(inputs)
            with rf(spans[2]):
                host = tuple(x.cpu() for x in out)
            solved += int(host[3].sum())
            calls += 1
            index += 1
        dt = time.perf_counter() - t0
    return solved, calls, dt, index, (prof if profile else None)


def _innermost(ranges, j, t):
    """The name of the innermost of ``ranges[:j]`` (start, end, name,
    sorted by start, nested or disjoint) open at ``t``: the latest begun
    that has not ended; None where none is open."""
    for s, e, name in reversed(ranges[max(0, j - 512):j]):
        if e >= t:
            return name
    return None


def _in_calls(times, calls):
    """How many of ``times`` lie inside one of ``calls``, per call."""
    if not calls:
        return None
    t = np.sort(np.asarray(times, dtype=np.int64))
    c = np.asarray(calls, dtype=np.int64)
    inside = np.searchsorted(t, c[:, 1], side="right") - \
        np.searchsorted(t, c[:, 0], side="left")
    return float(inside.sum()) / len(c)


def analyse(prof, spec):
    """Per-stage device time and the checks, from the raw events."""
    import torch

    from portbench.harness import SPANS, WINDOW_SPAN, Run, _read_trace
    from portbench.program_spans import (CALLS, busy_in, is_launch, is_sync,
                                         merged)

    # the fleets' calls and the single Newton-Raphson power flow's
    call_ranges = (*CALLS, "jgt.power_flow")

    cuda = torch.autograd.DeviceType.CUDA
    host_ranges, launches, device, annotations = [], {}, [], 0
    calls_api, ops = [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if e.is_user_annotation() or name in SPANS or \
                    name == WINDOW_SPAN:
                annotations += 1
                continue
            device.append((name, e.start_ns(), e.end_ns(),
                           e.correlation_id()))
            continue
        if name == WINDOW_SPAN:
            window = (e.start_ns(), e.end_ns())
        if name.startswith("jgt.") or name in SPANS:
            host_ranges.append((e.start_ns(), e.end_ns(), name))
        elif not name.startswith(("cuda", "cu")):
            ops.append((e.start_ns(), e.end_ns(), name))
        else:
            if e.correlation_id():
                launches[e.correlation_id()] = (e.start_ns(), name)
            if is_launch(name) or is_sync(name):
                calls_api.append((e.start_ns(), name))
    host_ranges.sort()
    lo, hi = window
    calls = [(s, e) for s, e, n in host_ranges if n in call_ranges]
    ncalls = len(calls)
    by_stage, unlinked, by_api, linked_kind = {}, 0, {}, {}
    total = 0
    rng = [r for r in host_ranges if r[0] <= hi and r[1] >= lo]
    starts = np.asarray([r[0] for r in rng], dtype=np.int64)
    for name, s, e, cid in device:
        if e <= lo or s >= hi:
            continue
        dur = min(e, hi) - max(s, lo)
        total += dur
        k = _kind(name)
        hit = launches.get(cid)
        linked_kind.setdefault(k, [0, 0])
        linked_kind[k][hit is not None] += 1
        if hit is None:
            unlinked += dur
            key = "unlinked"
        else:
            by_api[hit[1]] = by_api.get(hit[1], 0) + 1
            j = int(np.searchsorted(starts, hit[0], side="right"))
            key = _innermost(rng, j, hit[0]) or "none"
        by_stage[key] = by_stage.get(key, 0) + dur
    # launch calls and waits by the innermost range they began in; waits
    # also by the innermost host operation that made them
    ops.sort()
    op_starts = np.asarray([o[0] for o in ops], dtype=np.int64)
    api, waits = {}, {}
    for t, name in calls_api:
        if not lo <= t <= hi:
            continue
        j = int(np.searchsorted(starts, t, side="right"))
        stage = _innermost(rng, j, t) or "python"
        key = (stage, "wait" if is_sync(name) else "launch")
        api[key] = api.get(key, 0) + 1
        if is_sync(name):
            k = int(np.searchsorted(op_starts, t, side="right"))
            op = f"{stage} {_innermost(ops, k, t)} {name}"
            waits[op] = waits.get(op, 0) + 1
    # idle gaps by the innermost range at each gap's middle
    iv = sorted((max(s, lo), min(e, hi)) for _, s, e, _ in device
                if e > lo and s < hi)
    gaps, edge = [], lo
    for s, e in iv:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if hi > edge:
        gaps.append((edge, hi))
    idle = {}
    for a, b in gaps:
        mid = (a + b) // 2
        j = int(np.searchsorted(starts, mid, side="right"))
        key = _innermost(rng, j, mid) or "python"
        idle[key] = idle.get(key, 0) + (b - a)
    spans = np.asarray(calls, dtype=np.int64).reshape(-1, 2)
    loop = (int((spans[:, 1] - spans[:, 0]).sum()),
            int(busy_in(spans, merged(iv)).sum()))
    tdata = _read_trace(prof)
    run = Run(batch=0, setup_s=0.0, host_build_s=0.0, calls=[],
              window_s=0.0, peak_window_bytes=0, shape={}, trace=tdata)
    readers = {m: spec.reader(m).read(run) for m in (
        "loop_idle_pct", "launches_per_call", "syncs_per_call",
        "device_idle_pct")}
    return dict(
        calls=ncalls,
        stage_ms_per_call={k: v / 1e6 / max(ncalls, 1)
                           for k, v in sorted(by_stage.items(),
                                              key=lambda kv: -kv[1])},
        device_s=total / 1e9,
        unlinked_share_pct=100.0 * unlinked / max(total, 1),
        outside_stages_share_pct=100.0 * sum(
            v for k, v in by_stage.items()
            if not k.startswith("jgt.") or k in call_ranges)
        / max(total, 1),
        linked_by_kernel={k: dict(linked=v[1], unlinked=v[0])
                          for k, v in linked_kind.items()},
        launch_api=by_api,
        api_per_call={f"{k[0]} {k[1]}": v / max(ncalls, 1)
                      for k, v in sorted(api.items())},
        waits_per_call={k: v / max(ncalls, 1)
                        for k, v in sorted(waits.items())},
        loop_idle_pct_true_ends=100.0 * (1 - loop[1] / max(loop[0], 1)),
        device_activities_per_call=_in_calls(
            [launches[cid][0] for _, _, _, cid in device
             if cid in launches], calls),
        idle_gaps_s=sorted(([k, v / 1e9] for k, v in idle.items()),
                           key=lambda kv: -kv[1])[:10],
        annotations_dropped=annotations, readers=readers)


def split(spec, workload, seed, seconds, windows, device) -> list:
    """One untraced window, then a traced one for each of ``windows``
    (``on``/``off``); the result line of each, printed as it ends."""
    import torch

    from juliagrid_tpu_torch.utils import profiling
    from portbench.generator import Traffic
    from portbench.harness import SPANS, WINDOW_SPAN
    from portbench.reference.case import load_case

    cell = spec.workload(workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    entry = spec.entry(traffic["entry"])
    case_path = spec.path(config["case"])
    case = load_case(str(case_path))
    prep = entry.prepare(case, config, device)
    sut = entry.build(case_path, traffic, device, prep)
    gen = Traffic(traffic, entry, case, prep, device, seed)
    sut.solve(gen.call("warmup"))
    if device.type == "cuda":
        torch.cuda.synchronize()
    spans = (*SPANS, WINDOW_SPAN)
    recording = profiling._recording
    solved, calls, dt, index, _ = _window(sut, gen, seconds, 0, False,
                                          spans, device)
    lines = [dict(workload=workload, window="untraced",
                  solves_per_s=solved / dt, calls=calls)]
    print(json.dumps(lines[-1]), flush=True)
    for kind in windows:
        profiling._recording = recording if kind == "on" else \
            (lambda: False)
        try:
            solved, calls, dt, index, prof = _window(
                sut, gen, seconds, index, True, spans, device)
        finally:
            profiling._recording = recording
        line = dict(workload=workload, window=f"traced, ranges {kind}",
                    solves_per_s=solved / dt, calls=calls)
        if kind == "on":
            line.update(analyse(prof, spec))
        del prof
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--windows", default="on,off,on,off")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.run import set_cache_dirs
    set_cache_dirs()

    import torch

    from portbench.harness import power_limit
    from portbench.spec import Spec

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    lines = split(Spec(ROOT), args.workload, args.seed, args.seconds,
                  args.windows.split(","), torch.device("cuda"))
    print(json.dumps(dict(card=power_limit(), torch=torch.__version__,
                          cuda=torch.version.cuda)), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
