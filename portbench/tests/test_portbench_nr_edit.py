"""The live-edit cell's parts: its readers on hand-made traces and runs
(each its exact value, None where the run holds nothing for it), a traced
CPU run of the ``nr_edit`` entry at case14 that reports them, and the
float32 control failing the comparison there."""

import json

import numpy as np
import pytest

from portbench.control import control_factory
from portbench.harness import SPANS, Call, Run, TraceData, run_cell
from portbench.spec import Spec

from .conftest import ROOT

SEED = 2 ** 31 + 313
NEW = ("edit_ms_per_call", "refresh_ms_per_call", "rebuilds_per_call",
       "nr_lu_ms_per_iter")
CELL = "case14.nr_single"

#: two calls: their solve spans (100, 400) and (500, 900), each holding a
#: ``jgt.power_flow`` range; one range outside any solve span
HOST = [(50, "jgt.power_flow"), (120, "aten::copy_"), (130, "jgt.power_flow"),
        (140, "jgt.refresh"), (150, "jgt.fill"), (560, "jgt.power_flow"),
        (570, "jgt.fill"), (580, "jgt.power_flow")]
SOLVES = [(100, 400, SPANS[1]), (500, 900, SPANS[1]), (0, 50, SPANS[0])]
DEVICE = [("void getrf_kernel<double>(int)", 160, 360),
          ("void dgetrs_kernel(int)", 360, 380),
          ("(anonymous namespace)::nr_fill_kernel(int const*)", 150, 160),
          ("void at::native::elementwise_kernel<128, 2>(int)", 380, 390),
          ("sm90_xmma_gemm_f64f64_f64f64_f64_nn_n(int)", 600, 800),
          ("Memset (Device)", 560, 570)]


def _trace(host=HOST, device=DEVICE, spans=SOLVES):
    return TraceData(window=(0, 1000), device=list(device),
                     host_ops=(np.asarray([t for t, _ in host],
                                          dtype=np.int64),
                               [name for _, name in host]),
                     spans=tuple(sorted(spans)))


def _run(trace):
    calls = [Call(0.0, 1.0, 1, 1, 4, 4), Call(1.0, 2.0, 1, 1, 3, 3)]
    return Run(batch=1, setup_s=1.0, host_build_s=0.1, calls=calls,
               window_s=2.0, peak_window_bytes=0,
               shape=dict(n=14, nnz=54, branches=20, order=22,
                          jac_entries=200, extra_solves=0),
               trace=trace)


def _read(name, run):
    return Spec(ROOT).reader(name).read(run)


def test_each_reader_gives_its_exact_value(monkeypatch):
    from juliagrid_tpu_torch.utils.profiling import default_timings
    run = _run(_trace())
    # the first range in each solve span: 130 - 100 and 560 - 500 ns
    assert _read("edit_ms_per_call", run) == pytest.approx(45e-6, abs=1e-15)
    # getrf, getrs and the GEMM, not K1, PyTorch's kernel or the memset,
    # over the calls' 4 + 3 steps
    assert _read("nr_lu_ms_per_iter", run) == pytest.approx(
        1e3 * 420e-9 / 7, abs=1e-15)
    monkeypatch.setattr(default_timings, "spans",
                        {"pf.refresh": (8, 0.4), "pf.rebuild": (6, 0.3)})
    assert _read("refresh_ms_per_call", run) == pytest.approx(50.0)
    assert _read("rebuilds_per_call", run) == 0.75


@pytest.mark.parametrize("name", NEW)
def test_a_run_without_the_program_s_parts_reads_none(monkeypatch, name):
    from juliagrid_tpu_torch.utils.profiling import default_timings
    monkeypatch.setattr(default_timings, "spans", {})
    assert _read(name, _run(None)) is None
    bare = _trace(host=[(t, n) for t, n in HOST
                        if not n.startswith("jgt.")],
                  device=[d for d in DEVICE if "at::native" in d[0]])
    assert _read(name, _run(bare)) is None
    # a parent without the rebuild counter still times its refreshes
    monkeypatch.setattr(default_timings, "spans", {"pf.refresh": (2, 0.1)})
    assert (_read(name, _run(bare)) is None) == (name != "refresh_ms_per_call")


def _edit_root(small_root):
    """The small root with ``CELL``: the ``nr_edit`` mix on case14test, the
    new readers listing it."""
    bench = small_root / "portbench"
    config = dict(name="case14", case=str(ROOT / "tests" / "data" /
                                          "case14test.m"), reduced=[])
    (bench / "configs" / "case14.json").write_text(json.dumps(config))
    (bench / "limits" / f"{CELL}.json").write_text(
        (bench / "limits" / "activsg10k.nr_single.json").read_text())
    doc = json.loads((small_root / "BENCHMARK.json").read_text())
    doc["configs"].append(dict(name="case14", source="test",
                               file="portbench/configs/case14.json",
                               reduced=[], why="test"))
    doc["workloads"].append(dict(name=CELL, config="case14",
                                 traffic="nr_edit.b1", chips=1, why="test"))
    for m in doc["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append(CELL)
    (small_root / "BENCHMARK.json").write_text(json.dumps(doc))
    return Spec(small_root)


def test_a_traced_edit_run_reports_the_new_readers(small_root, monkeypatch):
    from juliagrid_tpu_torch.utils.profiling import default_timings
    monkeypatch.setattr(default_timings, "spans", {})
    spec = _edit_root(small_root)
    result, found = run_cell(spec, CELL, SEED, 0.5, True, device="cpu")
    assert result["correct"] is True and not found
    metrics = result["metrics"]
    # no device activity on the CPU: the library's kernels read nothing
    assert set(NEW) - set(metrics) == {"nr_lu_ms_per_iter"}
    assert metrics["rebuilds_per_call"]["value"] == 1.0
    assert metrics["edit_ms_per_call"]["value"] > 0
    assert metrics["refresh_ms_per_call"]["value"] > 0
    assert metrics["iters_per_solve"]["value"] > 0


def test_the_float32_control_is_not_correct(small_root):
    spec = _edit_root(small_root)
    result, _ = run_cell(spec, CELL, SEED + 1, 0.5, False, device="cpu",
                         program=control_factory(spec, CELL))
    assert result["correct"] is False
    checks = result["checks"]
    assert checks["count_gap_pct"]["value"] > checks["count_gap_pct"]["limit"]
    assert checks["state_gap"]["value"] > checks["state_gap"]["limit"]
