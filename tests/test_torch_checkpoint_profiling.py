"""The port's checkpoint/resume and profiling surface: the JAX package's
tests/test_checkpoint_profiling.py checks run on the port, the SE fleet
resumed through the port's batched_se_solve, checkpoint files read across
the two packages, and a device trace's annotation."""

import json

import numpy as np
import pytest
import torch

import juliagrid_tpu_torch as jgt
from juliagrid_tpu.utils import checkpoint as jax_checkpoint
from juliagrid_tpu_torch.utils import checkpoint as torch_checkpoint
from juliagrid_tpu_torch.utils.checkpoint import (checkpointed_map,
                                                  load_checkpoint,
                                                  save_checkpoint)
from juliagrid_tpu_torch.utils.profiling import (Timings, annotate,
                                                 default_timings, span,
                                                 trace)


def test_checkpoint_roundtrip(tmp_path):
    """Nested dict/list/tuple leaves round-trip; a tensor leaf comes back
    as its host array."""
    path = str(tmp_path / "ck.h5")
    tree = {"a": np.arange(5.0), "nest": [np.eye(2), (np.zeros(3), 7)],
            "t": torch.arange(4, dtype=torch.float64)}
    save_checkpoint(path, tree, step=3, meta={"n_items": 10})
    step, loaded, meta = load_checkpoint(path)
    assert step == 3 and int(meta["n_items"]) == 10
    np.testing.assert_array_equal(loaded["a"], tree["a"])
    np.testing.assert_array_equal(loaded["nest"][0], np.eye(2))
    assert isinstance(loaded["nest"][1], tuple)
    assert int(loaded["nest"][1][1]) == 7
    np.testing.assert_array_equal(loaded["t"], np.arange(4.0))
    assert load_checkpoint(str(tmp_path / "missing.h5")) is None


def test_checkpointed_map_resumes_without_recompute(tmp_path):
    path = str(tmp_path / "fleet.h5")
    calls = []

    def fn(start, stop):
        calls.append(start)
        if len(calls) == 3 and not getattr(fn, "resumed", False):
            raise RuntimeError("simulated preemption")
        return {"sum": np.arange(start, stop).sum()}

    with pytest.raises(RuntimeError):
        checkpointed_map(fn, 10, 2, path, every=1)
    assert calls == [0, 2, 4]  # chunks 0 and 2 are checkpointed

    fn.resumed = True
    results = checkpointed_map(fn, 10, 2, path, every=1)
    assert calls == [0, 2, 4, 4, 6, 8]
    assert [int(r["sum"]) for r in results] == [1, 5, 9, 13, 17]


def test_checkpointed_map_rejects_different_slicing(tmp_path):
    path = str(tmp_path / "fleet.h5")
    checkpointed_map(lambda a, b: {"x": np.zeros(1)}, 4, 2, path)
    with pytest.raises(ValueError):
        checkpointed_map(lambda a, b: {"x": np.zeros(1)}, 4, 1, path)


@pytest.mark.parametrize("writer,reader", [
    (jax_checkpoint, torch_checkpoint), (torch_checkpoint, jax_checkpoint)],
    ids=["jax-to-torch", "torch-to-jax"])
def test_checkpoint_files_cross_packages(tmp_path, writer, reader):
    """A file one package writes, the other reads back: the same step,
    metadata and tree, leaf for leaf and bit for bit."""
    rng = np.random.default_rng(5)
    tree = {"vm": rng.standard_normal((3, 4)), "it": np.arange(3),
            "nest": [rng.standard_normal(2), (np.ones(1), 2)]}
    path = str(tmp_path / "x.h5")
    writer.save_checkpoint(path, tree, step=4, meta={"n_items": 6,
                                                     "chunk": 2})
    step, got, meta = reader.load_checkpoint(path)
    assert step == 4 and int(meta["n_items"]) == 6 and int(meta["chunk"]) == 2
    assert np.array_equal(got["vm"], tree["vm"])
    assert np.array_equal(got["it"], tree["it"])
    assert np.array_equal(got["nest"][0], tree["nest"][0])
    assert isinstance(got["nest"][1], tuple) and int(got["nest"][1][1]) == 2


def test_checkpointed_se_fleet_matches_uninterrupted(tmp_path, data_path):
    """The advertised use on the port: a chunked Monte-Carlo SE fleet
    through ``parallel.batched_se_solve`` interrupted and resumed gives the
    uninterrupted run's estimates within 1e-12."""
    from juliagrid_tpu_torch.estimation.acse import compile_se_arrays
    from juliagrid_tpu_torch.parallel import batched_se_solve
    from juliagrid_tpu_torch.powerflow.ac import compile_ac_arrays

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

    rng = np.random.default_rng(7)
    base = np.asarray(arr_h.mean)
    sigma = 1.0 / np.sqrt(np.asarray(arr_h.w))
    means = base[None, :] + 0.1 * sigma * rng.standard_normal(
        (8, len(base)))
    chunk = 2
    vm0 = torch.as_tensor(np.tile(system.bus.voltage.magnitude.array[:n],
                                  (chunk, 1)))
    va0 = torch.as_tensor(np.tile(system.bus.voltage.angle.array[:n],
                                  (chunk, 1)))

    def solve_chunk(start, stop):
        vm, va, iters, conv = batched_se_solve(
            arr, net, vm0, va0, torch.as_tensor(means[start:stop]),
            tol=1e-8, max_iter=40)
        return {"vm": vm, "conv": conv}

    direct = [solve_chunk(s, s + chunk) for s in range(0, 8, chunk)]

    path = str(tmp_path / "se.h5")
    boom = {"left": 2}

    def flaky(start, stop):
        if start >= 4 and boom["left"] > 0:
            boom["left"] -= 1
            raise RuntimeError("preempted")
        return solve_chunk(start, stop)

    for _ in range(2):
        with pytest.raises(RuntimeError):
            checkpointed_map(flaky, 8, chunk, path)
    resumed = checkpointed_map(flaky, 8, chunk, path)
    for d, r in zip(direct, resumed):
        np.testing.assert_allclose(np.asarray(r["vm"]), d["vm"].numpy(),
                                   rtol=0, atol=1e-12)
        assert np.asarray(r["conv"]).all()


def test_timings_spans_and_report():
    t = Timings()
    with t.span("phase_a"):
        pass
    with t.span("phase_a"):
        pass
    with t.span("phase_b"):
        pass
    assert t.spans["phase_a"][0] == 2
    rep = t.report()
    assert "phase_a" in rep and "Calls" in rep

    with span("global_phase"):
        pass
    assert default_timings.spans["global_phase"][0] >= 1
    mine = Timings()
    with span("mine", mine):
        pass
    assert mine.spans["mine"][0] == 1


def test_drivers_record_timings(data_path):
    system = jgt.power_system(str(data_path / "case14test.m"))
    pf = jgt.newton_raphson(system, device="cpu")
    jgt.power_flow(pf, power=True)
    assert pf.method.timings.spans["solve"][0] == 1
    assert pf.method.timings.total("solve") > 0

    mon = jgt.measurement(system)
    jgt.add_voltmeter(mon, analysis=pf, noise=False)
    jgt.add_wattmeter(mon, analysis=pf, noise=False)
    jgt.add_varmeter(mon, analysis=pf, noise=False)
    se = jgt.gauss_newton(mon, device="cpu")
    jgt.state_estimation(se)
    assert se.method.timings.total("solve") > 0


def test_trace_holds_the_annotation(tmp_path, data_path):
    """``trace`` on the CPU writes a Chrome trace that names the
    ``annotate`` region around a power flow."""
    pf = jgt.newton_raphson(jgt.power_system(str(data_path / "case14test.m")),
                            device="cpu")
    with trace(str(tmp_path / "logs"), device="cpu") as path:
        with annotate("nr_solve_region"):
            jgt.power_flow(pf)
    events = json.loads(open(path).read())["traceEvents"]
    assert any(e.get("name") == "nr_solve_region" for e in events)
    assert pf.method.converged


def test_trace_asks_for_the_card_by_default(tmp_path, monkeypatch):
    """With ``config.device`` "cuda" and no card, ``trace`` raises before
    profiling: it never records a host-only trace in place of the card's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace(str(tmp_path / "logs")):
            pass
    assert not (tmp_path / "logs").exists()
