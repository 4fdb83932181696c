"""The fleets' stages and the set-up spans (``utils.profiling``): under a
profiler each fleet call is a ``jgt.nr_fleet`` or ``jgt.se_fleet`` range
holding its stages in the loop's order; with neither a profiler nor a
``device_stages`` block a call makes no range and records no event; the
kernel loads, nvcc builds and host table builds are spans of
``default_timings``."""

import types

import numpy as np
import pytest
import torch

import juliagrid_tpu_torch as jgt
from juliagrid_tpu_torch.entry import CASE
from juliagrid_tpu_torch.estimation.acse import compile_se_arrays, gain_table
from juliagrid_tpu_torch.kernels import _build, gain_fill
from juliagrid_tpu_torch.kernels.nr_fill import nr_fill
from juliagrid_tpu_torch.kernels.se_fill import se_fill_entries
from juliagrid_tpu_torch.parallel import (batched_nr_solve, batched_se_solve,
                                          launch, sharded_nr_solve,
                                          sharded_se_solve)
from juliagrid_tpu_torch.powerflow.ac import compile_ac_arrays
from juliagrid_tpu_torch.utils import profiling
from juliagrid_tpu_torch.utils.profiling import default_timings

B = 4


def _nr_fleet(data_path, sharded=None):
    system = jgt.power_system(str(data_path / "case14test.m"))
    pf = jgt.newton_raphson(system, device="cpu")
    arr = pf.arrays
    scale = 1.0 + 0.05 * torch.as_tensor(
        np.random.default_rng(3).standard_normal((B, 1)))
    vm0 = torch.as_tensor(np.tile(pf.voltage.magnitude, (B, 1)))
    va0 = torch.as_tensor(np.tile(pf.voltage.angle, (B, 1)))
    p, q = arr.p_sched[None] * scale, arr.q_sched[None] * scale

    def solve(fill=nr_fill):
        if sharded is not None:
            return sharded_nr_solve(sharded, arr, vm0, va0, p, q)
        return batched_nr_solve(arr, vm0, va0, p, q, tol=1e-8, max_iter=20,
                                fill=fill)

    return solve


def _se_fleet(data_path, sharded=None):
    system = jgt.power_system(str(data_path / "case14test.m"))
    pf = jgt.newton_raphson(system, device="cpu")
    jgt.power_flow(pf, power=True)
    mon = jgt.measurement(system)
    jgt.add_voltmeter(mon, analysis=pf, noise=False)
    jgt.add_wattmeter(mon, analysis=pf, noise=False)
    jgt.add_varmeter(mon, analysis=pf, noise=False)
    arr, _, _, arr_h = compile_se_arrays(system, mon, return_host=True,
                                         device="cpu")
    net = compile_ac_arrays(system, "cpu")
    n = system.bus.number
    base = np.asarray(arr_h.mean)
    sigma = 1.0 / np.sqrt(np.asarray(arr_h.w))
    means = torch.as_tensor(base[None, :] + 0.1 * sigma * np.random.
                            default_rng(7).standard_normal((B, len(base))))
    vm0 = torch.as_tensor(np.tile(system.bus.voltage.magnitude.array[:n],
                                  (B, 1)))
    va0 = torch.as_tensor(np.tile(system.bus.voltage.angle.array[:n],
                                  (B, 1)))

    def solve(fill=se_fill_entries):
        if sharded is not None:
            return sharded_se_solve(sharded, arr, net, vm0, va0, means)
        return batched_se_solve(arr, net, vm0, va0, means, tol=1e-8,
                                max_iter=40, fill=fill)

    return solve


FLEETS = {"nr": (_nr_fleet, "jgt.nr_fleet", nr_fill),
          "se": (_se_fleet, "jgt.se_fleet", se_fill_entries)}


def _stage_order(kind: str, trips: int) -> list:
    """The stages of a call whose loop made ``trips`` trips."""
    if kind == "nr":
        return ["fill"] + ["test", "solve", "fill"] * trips + ["test"]
    return ["fill", "gain", "solve", "test"] + \
        ["update", "fill", "gain", "solve", "test"] * trips


def _ranges(prof) -> list:
    """(start, end, name) of the host's ``jgt.*`` ranges, by start."""
    cpu = torch.autograd.DeviceType.CPU
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cpu
                  and e.name().startswith(profiling.PREFIX))


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _ranges(prof)


@pytest.mark.parametrize("kind", sorted(FLEETS))
def test_a_fleet_call_holds_its_stages_in_order(data_path, kind):
    make, call_name, _ = FLEETS[kind]
    solve = make(data_path)
    (vm, va, iters, conv), ranges = _profiled(solve)
    assert bool(conv.all())
    trips = int(iters.max())
    calls = [r for r in ranges if r[2] == call_name]
    assert len(calls) == 1
    lo, hi = calls[0][:2]
    stages = [r for r in ranges if r[2] != call_name]
    assert [name[len(profiling.PREFIX):] for _, _, name in stages] == \
        _stage_order(kind, trips)
    assert sum(name == "jgt.test" for _, _, name in stages) == trips + 1
    for (s0, e0, _), (s1, _, _) in zip(stages, stages[1:]):
        assert s0 <= e0 <= s1
    assert all(lo <= s <= e <= hi for s, e, _ in stages)
    assert profiling._range is None


@pytest.mark.parametrize("kind", sorted(FLEETS))
def test_no_range_is_left_open_by_a_stage_that_raises(data_path, kind):
    make, call_name, real_fill = FLEETS[kind]
    solve = make(data_path)
    calls = {"n": 0}

    def failing(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("fill failed")
        return real_fill(*args, **kwargs)

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError, match="fill failed"):
            solve(fill=failing)
        assert profiling._range is None
    ranges = _ranges(prof)
    (lo, hi, _), = [r for r in ranges if r[2] == call_name]
    stages = [r for r in ranges if r[2] != call_name]
    assert stages[-1][2] == "jgt.fill"
    assert all(lo <= s <= e <= hi for s, e, _ in stages)


@pytest.mark.parametrize("kind", sorted(FLEETS))
def test_marks_make_no_range_and_no_event_when_off(data_path, monkeypatch,
                                                   kind):
    """Neither a profiler nor a ``device_stages`` block: a fleet call
    creates no RecordFunction and no CUDA event."""
    solve = FLEETS[kind][0](data_path)
    made = {"ranges": 0, "events": 0}
    init = torch.autograd.profiler.record_function.__init__

    def counted(self, *args, **kwargs):
        made["ranges"] += 1
        init(self, *args, **kwargs)

    def event(*args, **kwargs):
        made["events"] += 1
        raise AssertionError("a CUDA event was made")

    def stage_range(name):
        made["ranges"] += 1
        raise AssertionError("a stage range was made")

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__",
                        counted)
    monkeypatch.setattr(profiling, "_stage_range", stage_range)
    monkeypatch.setattr(torch.cuda, "Event", event)
    _, _, iters, conv = solve()
    assert bool(conv.all()) and int(iters.max()) > 0
    assert made == {"ranges": 0, "events": 0}
    assert profiling.annotate("jgt.x") is profiling._OFF


class _FakeEvent:
    """A CUDA event stand-in that counts on the host: ``elapsed_time`` is
    the number of events recorded between two."""

    clock = 0

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        _FakeEvent.clock += 1
        self.at = _FakeEvent.clock

    def elapsed_time(self, other):
        return float(other.at - self.at)


@pytest.mark.parametrize("kind", sorted(FLEETS))
@pytest.mark.parametrize("profiled", [False, True])
def test_device_stages_keep_the_bare_names(data_path, monkeypatch, kind,
                                           profiled):
    """Inside ``device_stages`` the marks record events under the stages'
    own names, with a profiler recording or not; a profiler's ranges are
    the same stages with the prefix."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    make, call_name, _ = FLEETS[kind]
    solve = make(data_path)
    with profiling.device_stages() as split:
        if profiled:
            (_, _, iters, _), ranges = _profiled(solve)
        else:
            _, _, iters, _ = solve()
    trips = int(iters.max())
    order = _stage_order(kind, trips)
    assert set(split) == set(order)
    assert split["test"][0] == trips + 1
    assert all(cnt == order.count(name) for name, (cnt, _) in split.items())
    if profiled:
        assert [name for _, _, name in ranges if name != call_name] == \
            [profiling.PREFIX + name for name in order]


def _rank_ranges(mesh, data_path):
    """One rank of a CPU mesh: each sharded fleet under a profiler, its
    ranges' names, its largest count and whether a range is left open."""
    out = {}
    for kind, (make, _, _) in FLEETS.items():
        solve = make(data_path, sharded=mesh)
        (_, _, iters, _), ranges = _profiled(solve)
        out[kind] = ([name for _, _, name in ranges], int(iters.max()),
                     profiling._range is None)
    return out


def test_sharded_fleets_mark_the_all_reduce_within_test():
    """On a two-rank gloo mesh each rank's call holds the same stages, the
    all-reduce of each test marked within it, and the gather's all-reduce
    after the call is closed when the sharded solve returns."""
    ranks = launch(_rank_ranges, 2, "gloo", "cpu", args=(CASE.parent,),
                   timeout=240.0)
    for out in ranks:
        for kind, (names, trips, closed) in out.items():
            want = []
            for name in _stage_order(kind, trips):
                want += [name, "all-reduce"] if name == "test" else [name]
            call = FLEETS[kind][1]
            assert names == [call] + [profiling.PREFIX + name
                                      for name in want + ["all-reduce"]]
            assert closed
    assert ranks[0] == ranks[1]


def _spans(name):
    return default_timings.spans.get(name, (0, 0.0))[0]


def test_load_library_times_the_load_and_counts_builds(monkeypatch,
                                                       tmp_path):
    """``kernels.load`` spans every load; ``kernels.build`` only a load
    that ran nvcc (the subprocess and the library loader faked)."""
    ran = []

    def nvcc(cmd, **kwargs):
        ran.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as fh:
            fh.write(b"built")
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    before = _spans("kernels.load"), _spans("kernels.build")
    assert _build.load_library("nr_fill") == str(
        _build.library_path("nr_fill"))
    assert (_spans("kernels.load"), _spans("kernels.build")) == \
        (before[0] + 1, before[1] + 1)
    _build.load_library("nr_fill")
    assert (_spans("kernels.load"), _spans("kernels.build")) == \
        (before[0] + 2, before[1] + 1)
    assert len(ran) == 1


def test_host_tables_are_built_once_each_as_a_span(data_path):
    """K3's tables at the arrays' compile, K8's gain table and its band
    lists at their first use: one ``tables.build`` each, none on reuse."""
    system = jgt.power_system(str(data_path / "case14test.m"))
    pf = jgt.newton_raphson(system, device="cpu")
    jgt.power_flow(pf, power=True)
    mon = jgt.measurement(system)
    jgt.add_voltmeter(mon, analysis=pf, noise=False)
    jgt.add_wattmeter(mon, analysis=pf, noise=False)
    count = _spans("tables.build")
    arr = compile_se_arrays(system, mon, device="cpu")[0]
    assert _spans("tables.build") == count + 1
    net = compile_ac_arrays(system, "cpu")
    table = gain_table(arr, net)
    assert _spans("tables.build") == count + 2
    assert gain_table(arr, net) is table
    bands = gain_fill.fleet_bands(table)
    assert gain_fill.fleet_bands(table) is bands
    assert _spans("tables.build") == count + 3
