"""The single Newton-Raphson ``power_flow``'s ranges and rebuild count
(``powerflow/driver.py``, ``powerflow/ac.py``): under a profiler a call is
one ``jgt.power_flow`` range holding ``refresh``, then ``_nr_solve``'s
``fill``, ``test`` and ``solve`` in loop order; the array rebuilds are the
span ``pf.rebuild`` of ``default_timings``, one after each edit; with no
profiler recording a call makes no range and records no event."""

import pytest
import torch

import juliagrid_tpu_torch as jgt
from juliagrid_tpu_torch.powerflow import ac
from juliagrid_tpu_torch.utils import profiling
from juliagrid_tpu_torch.utils.profiling import default_timings

CALL = "jgt.power_flow"


def _analysis(data_path, method=jgt.newton_raphson):
    system = jgt.power_system(str(data_path / "case14test.m"))
    return system, method(system, device="cpu")


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
        fn()
    return _ranges(prof)


def _stage_order(iterations: int) -> list:
    return ["refresh", "fill"] + ["test", "solve", "fill"] * iterations + \
        ["test"]


def _rebuilds() -> int:
    return default_timings.spans.get("pf.rebuild", (0, 0.0))[0]


def test_a_power_flow_call_holds_its_stages_in_order(data_path):
    _, pf = _analysis(data_path)
    ranges = _profiled(lambda: jgt.power_flow(pf))
    assert pf.method.converged and pf.method.iteration > 0
    calls = [r for r in ranges if r[2] == CALL]
    assert len(calls) == 1
    lo, hi = calls[0][:2]
    stages = [r for r in ranges if r[2] != CALL]
    names = [name[len(profiling.PREFIX):] for _, _, name in stages]
    assert names == _stage_order(pf.method.iteration)
    assert names.count("fill") == pf.method.iteration + 1
    for (s0, e0, _), (s1, _, _) in zip(stages, stages[1:]):
        assert s0 <= e0 <= s1
    assert all(lo <= s <= e <= hi for s, e, _ in stages)
    assert profiling._range is None


def test_no_range_is_left_open_by_a_fill_that_raises(data_path,
                                                     monkeypatch):
    _, pf = _analysis(data_path)
    real = ac.nr_fill
    calls = {"n": 0}

    def failing(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("fill failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(ac._nr_solve, "__defaults__", (failing,))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError, match="fill failed"):
            jgt.power_flow(pf)
        assert profiling._range is None
    ranges = _ranges(prof)
    (lo, hi, _), = [r for r in ranges if r[2] == CALL]
    stages = [r for r in ranges if r[2] != CALL]
    assert stages[-1][2] == "jgt.fill"
    assert all(lo <= s <= e <= hi for s, e, _ in stages)


def test_the_arrays_are_rebuilt_once_per_edit_and_solve(data_path):
    system, pf = _analysis(data_path)
    before = _rebuilds()
    jgt.power_flow(pf)
    assert _rebuilds() == before
    label = system.bus.label.label(3)
    for k in range(2):
        jgt.update_bus(system, label, active=0.3 + 0.1 * k, reactive=0.1)
        jgt.update_bus(system, system.bus.label.label(4), active=0.05)
        jgt.set_initial_point(pf)
        jgt.power_flow(pf)
        assert pf.method.converged
        assert _rebuilds() == before + k + 1
    jgt.power_flow(pf)
    assert _rebuilds() == before + 2


@pytest.mark.parametrize("method", ["fast_newton_raphson_bx",
                                    "gauss_seidel"])
def test_the_other_methods_make_no_call_range(data_path, method):
    _, pf = _analysis(data_path, getattr(jgt, method))
    ranges = _profiled(lambda: jgt.power_flow(pf, iteration=1000))
    assert pf.method.converged
    assert ranges == []


def test_no_range_and_no_event_when_off(data_path, monkeypatch):
    """Neither a profiler nor a ``device_stages`` block: a call creates no
    RecordFunction and no CUDA event."""
    system, pf = _analysis(data_path)
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
    jgt.update_bus(system, system.bus.label.label(3), active=0.3)
    jgt.power_flow(pf)
    assert pf.method.converged and pf.method.iteration > 0
    assert made == {"ranges": 0, "events": 0}
