"""The harness is driven by data: a configuration, a traffic mix, an entry
of the program and a metric added as files with an entry in
``BENCHMARK.json`` are found by name, with no edit to a file that is there;
and a run's last line has the result's schema."""

import json
import shutil

import pytest

from portbench.harness import run_cell
from portbench.spec import Spec

from .conftest import ROOT

SEED = 2 ** 31 + 77


def test_added_parts_are_found(small_root):
    before = {p: p.read_bytes() for p in (small_root / "portbench").rglob("*")
              if p.is_file()}
    bench = small_root / "portbench"
    config = json.loads((bench / "configs" / "case118.json").read_text())
    config["name"] = "case118b"
    (bench / "configs" / "case118b.json").write_text(json.dumps(config))
    params = json.loads((bench / "traffic" / "nr_small.json").read_text())
    params.update(load_sigma=0.02, entry="nr_demand")
    (bench / "traffic" / "nr_gentle.json").write_text(json.dumps(params))
    # an entry of its own: the power flow with the injections only grown
    (bench / "entries" / "nr_demand.py").write_text(
        (bench / "entries" / "nr.py").read_text().replace(
            "factor = 1.0 + params[\"load_sigma\"] * z",
            "factor = 1.0 + params[\"load_sigma\"] * z.abs()"))
    shutil.copy(bench / "limits" / "case118.nr_small.json",
                bench / "limits" / "case118b.nr_gentle.json")
    (bench / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n    return len(run.calls) / run.window_s\n")
    doc = json.loads((small_root / "BENCHMARK.json").read_text())
    doc["configs"].append(dict(name="case118b", source="test",
                               file="portbench/configs/case118b.json",
                               reduced=[], why="test"))
    doc["workloads"].append(dict(name="case118b.nr_gentle",
                                 config="case118b", traffic="nr_gentle",
                                 chips=1, why="test"))
    doc["per_layer"].append(dict(name="calls_per_s", unit="calls/s",
                                 better="higher", source="host_clock",
                                 layer="fleet loop", moves="solves_per_s",
                                 workloads=["case118b.nr_gentle"]))
    (small_root / "BENCHMARK.json").write_text(json.dumps(doc))
    for path, data in before.items():
        assert path.read_bytes() == data

    spec = Spec(small_root)
    assert spec.config("case118b")["case"] == config["case"]
    assert spec.traffic("nr_gentle")["load_sigma"] == 0.02
    assert "z.abs()" in open(spec.entry("nr_demand").__file__).read()
    names = [m["name"] for m in spec.metrics("case118b.nr_gentle", True)]
    assert "calls_per_s" in names and "k1_roofline" not in names
    result, found = run_cell(spec, "case118b.nr_gentle", SEED, 0.5, True,
                             device="cpu")
    assert result["correct"] and not found
    assert result["metrics"]["calls_per_s"]["value"] > 0


def test_metric_selection_follows_the_entries():
    spec = Spec(ROOT)
    e2e = {m["name"] for m in spec.metrics("case1354pegase.se_fleet", False)}
    assert e2e == {"solves_per_s", "setup_s"}
    e2e = {m["name"] for m in spec.metrics("case118.nr_fleet", False)}
    assert e2e == {"solves_per_s", "call_p95_ms", "setup_s"}
    layer = {m["name"] for m in spec.metrics("case118.se_fleet", True)}
    assert {"k2_chol_roofline", "k3e_roofline", "k8_roofline",
            "host_build_s"} <= layer
    assert not layer & {"k1_roofline", "k2_lu_roofline",
                        "dense_solve_ms_per_iter"}


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema(small_root, trace):
    spec = Spec(small_root)
    result, found = run_cell(spec, "case118.se_small", SEED, 0.5,
                             bool(trace), device="cpu")
    line = json.loads(json.dumps(result))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 8 and line["attempted"] % 8 == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"}
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}
        assert check["value"] <= check["limit"]
    wanted = {m["name"] for m in spec.metrics("case118.se_small", trace)}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device trace on the CPU: the device's readers find nothing
        assert set(line["metrics"]) == wanted - {"peak_mem_gib"}
    else:
        assert set(line["metrics"]) == wanted
