"""The port's report tables, info trees and verbose solver logs against the
JAX package's: tests/test_report.py's eight checks run on both packages on
the same case, and every rendered text compared. Labels, headers and column
sets must be identical; each numeric cell is parsed back and held within
REL_TOL of its scale, max(1, |JAX value|), and every table is rendered a
second time with 15 significant digits in each column so the comparison
reaches below the default 4 decimals."""

import io
import re

import numpy as np
import pytest

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.measurement import devices as jax_devices
from juliagrid_tpu.report import info as jax_info
from juliagrid_tpu_torch.measurement import devices as torch_devices
from juliagrid_tpu_torch.report import info as torch_info

REL_TOL = 1e-9
SEED = 20240611
PACKAGES = ((jg, "jax"), (jgt, "cpu"))
_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")
#: verbose lines that report host wall time, which differs run to run
_TIMED = ("time", "Time", "seconds")


def _tokens(line):
    """Split a line into text and numbers; a table's border line counts as
    its '+' skeleton only (widths follow the cells' lengths)."""
    if line.startswith("+") and set(line) <= {"+", "-"}:
        return ["+" * line.count("+")], []
    nums = [float(m) for m in _NUMBER.findall(line)]
    text = [t.strip() for t in _NUMBER.split(line)]
    return [t for t in text if t], nums


def assert_same_text(ref, got, rel=REL_TOL):
    """The same lines and words; each number within ``rel`` of its scale."""
    ref_lines = [l for l in ref.splitlines()
                 if not any(w in l for w in _TIMED)]
    got_lines = [l for l in got.splitlines()
                 if not any(w in l for w in _TIMED)]
    assert len(ref_lines) == len(got_lines), (ref, got)
    for a, b in zip(ref_lines, got_lines):
        (ta, na), (tb, nb) = _tokens(a), _tokens(b)
        assert ta == tb, (a, b)
        assert len(na) == len(nb), (a, b)
        for x, y in zip(na, nb):
            assert abs(x - y) <= rel * max(1.0, abs(x)), (a, b)


def _headers(text):
    """The column names of a rendered table (the line after its first
    border)."""
    lines = text.splitlines()
    first = next(i for i, l in enumerate(lines) if l.startswith("+"))
    return [c.strip() for c in lines[first + 1].strip("|").split("|")]


def same_table(printer, ref_args, got_args, **kw):
    """Render ``printer`` (a name of both packages' tables modules) from
    each package, by default and with 15 significant digits, and compare."""
    ref_fn = getattr(jg, printer)
    got_fn = getattr(jgt, printer)
    ref = ref_fn(*ref_args, file=io.StringIO(), **kw)
    got = got_fn(*got_args, file=io.StringIO(), **kw)
    assert _headers(ref) == _headers(got)
    assert_same_text(ref, got)
    if "fmt" not in kw:
        fmt = {h: "{:.15e}" for h in _headers(ref)}
        assert_same_text(ref_fn(*ref_args, file=io.StringIO(), fmt=fmt, **kw),
                         got_fn(*got_args, file=io.StringIO(), fmt=fmt, **kw))
    return got


def _summary_arrays(analysis):
    """Each summary quantity's values (the rows of ``_summary_table``)."""
    p, v = analysis.power, analysis.voltage
    system = analysis.system
    n = system.bus.number
    return {
        "Voltage Magnitude": v.magnitude, "Voltage Angle": v.angle,
        "Power Generation Active": p.supply.active,
        "Power Generation Reactive": p.supply.reactive,
        "Power Demand Active": system.bus.demand.active.array[:n],
        "Power Demand Reactive": system.bus.demand.reactive.array[:n],
        "Power Injection Active": p.injection.active,
        "Power Injection Reactive": p.injection.reactive,
        "Shunt Power Active": p.shunt.active,
        "Shunt Power Reactive": p.shunt.reactive,
        "From-Bus Power Active": p.from_.active,
        "From-Bus Power Reactive": p.from_.reactive,
        "To-Bus Power Active": p.to.active,
        "To-Bus Power Reactive": p.to.reactive,
        "Series Loss Active": p.series.active,
        "Series Loss Reactive": p.series.reactive,
        "Charging Reactive": p.charging.reactive,
        "Power Output Active": p.generator.active,
        "Power Output Reactive": p.generator.reactive}


def same_summary(printer, ref_analysis, got_analysis, labels):
    """A summary table of each package: quantities, minima, maxima and
    totals as ``same_table`` holds them. A row's minimum (maximum) label
    names the same element, or one whose JAX value ties the JAX minimum
    (maximum) within REL_TOL: a tie among values that are rounding noise
    (the series loss of a branch without resistance, ~1e-18) picks its
    element by that noise."""
    hide = {"show": {"Minimum Label": False, "Maximum Label": False}}
    same_table(printer, (ref_analysis,), (got_analysis,), **hide)
    ref = getattr(jg, printer)(ref_analysis, file=io.StringIO())
    got = getattr(jgt, printer)(got_analysis, file=io.StringIO())
    names = [str(labels.label(i)) for i in range(len(labels.labels()))]
    values = _summary_arrays(ref_analysis)
    ref_rows, got_rows = ([[c.strip() for c in line.strip("|").split("|")]
                           for line in text.splitlines()
                           if line.startswith("|")][1:]
                          for text in (ref, got))
    for a, b in zip(ref_rows, got_rows):
        quantity = a[0].rsplit(" [", 1)[0]
        arr = np.asarray(values[quantity])
        for col, pick in ((1, arr.min()), (3, arr.max())):
            if a[col] != b[col]:
                scale = max(1.0, abs(pick))
                assert abs(arr[names.index(b[col])] - pick) \
                    <= REL_TOL * scale, (a, b)
    return got


def _solved_nr(pkg, device, path):
    system = pkg.power_system(path)
    kw = {} if device == "jax" else {"device": device}
    analysis = pkg.newton_raphson(system, **kw)
    pkg.power_flow(analysis, power=True)
    return system, analysis


def _kw(device):
    return {} if device == "jax" else {"device": device}


def test_tables_render(data_path):
    path = str(data_path / "case14test.m")
    (js, jpf), (ts, tpf) = (_solved_nr(p, d, path) for p, d in PACKAGES)
    out = same_table("print_bus_data", (jpf,), (tpf,))
    assert "Bus Data" in out and "Voltage Magnitude" in out
    assert out.count("\n") > 14
    assert "From-Bus" in same_table("print_branch_data", (jpf,), (tpf,))
    assert "Power Output Active" in same_table("print_generator_data",
                                               (jpf,), (tpf,))
    for printer, labels in (("print_bus_summary", ts.bus.label),
                            ("print_branch_summary", ts.branch.label),
                            ("print_generator_summary",
                             ts.generator.label)):
        assert "Minimum" in same_summary(printer, jpf, tpf, labels)

    mons = []
    for (pkg, _), system, pf in ((PACKAGES[0], js, jpf),
                                 (PACKAGES[1], ts, tpf)):
        mon = pkg.measurement(system)
        pkg.add_wattmeter(mon, analysis=pf, noise=False)
        mons.append(mon)
    out = same_table("print_wattmeter_data", (mons[0],), (mons[1],))
    assert "Wattmeter Data" in out


def test_constraint_tables(data_path):
    path = str(data_path / "case14test.m")
    opfs = []
    for pkg, device in PACKAGES:
        analysis = pkg.dc_optimal_power_flow(pkg.power_system(path),
                                             **_kw(device))
        pkg.solve_opf(analysis)
        opfs.append(analysis)
    out = same_table("print_bus_constraint", (opfs[0],), (opfs[1],))
    assert "Active Power Balance Dual" in out
    assert "Active Power Balance Solution" not in out   # AC only
    out = same_table("print_generator_constraint", (opfs[0],), (opfs[1],))
    assert "Generator Constraint" in out
    same_table("print_branch_constraint", (opfs[0],), (opfs[1],))


def _ac_opfs(data_path):
    """case14optimal's AC OPF solved by each package."""
    path = str(data_path / "case14optimal.m")
    opfs = []
    for pkg, device in PACKAGES:
        analysis = pkg.ac_optimal_power_flow(pkg.power_system(path),
                                             **_kw(device))
        pkg.power_flow(analysis, power=True)
        opfs.append(analysis)
    return opfs


def test_ac_constraint_tables_full_columns(data_path):
    """Reference print/constraint.jl column sets: Minimum/Solution/
    Maximum/Dual per quantity, the balance solution from the port's
    ``_AcSpec.eq`` and the flows from ``acopf.flow_values``."""
    opfs = _ac_opfs(data_path)
    out = same_table("print_bus_constraint", (opfs[0],), (opfs[1],))
    for col in ("Voltage Magnitude Minimum", "Voltage Magnitude Solution",
                "Voltage Magnitude Maximum", "Voltage Magnitude Dual",
                "Active Power Balance Solution",
                "Active Power Balance Dual",
                "Reactive Power Balance Solution",
                "Reactive Power Balance Dual"):
        assert col in out, col
    out = same_table("print_generator_constraint", (opfs[0],), (opfs[1],))
    for col in ("Active Power Minimum", "Active Power Solution",
                "Active Power Maximum", "Active Power Dual",
                "Reactive Power Solution"):
        assert col in out, col
    out = same_table("print_branch_constraint", (opfs[0],), (opfs[1],))
    assert len(opfs[1]._spec.fl_k)
    for col in ("Flow Minimum", "Flow Solution", "Flow Maximum",
                "Flow Dual"):
        assert col in out, col


def _column(text, name):
    """The cells of column ``name`` of a rendered table, as floats."""
    lines = text.splitlines()
    first, second = [i for i, l in enumerate(lines) if l.startswith("+")][:2]
    i = _headers(text).index(name)
    return np.array([float(l.strip("|").split("|")[i])
                     for l in lines[second + 1:] if l.startswith("|")])


def test_measurement_residual_column(data_path):
    """A noisy set, each mean drawn around the power flow's value with its
    variance from the measurement layer's generator, seeded alike in both
    packages, so the residuals are of the noise's size (~1e-2), not
    rounding. The port's Residual column is held to the JAX package's
    within REL_TOL of the column's largest magnitude."""
    path = str(data_path / "case14test.m")
    ses = []
    for (pkg, device), devices in zip(PACKAGES, (jax_devices,
                                                 torch_devices)):
        _, pf = _solved_nr(pkg, device, path)
        devices.seed(SEED)
        mon = pkg.measurement(pf.system)
        for add in (pkg.add_voltmeter, pkg.add_wattmeter, pkg.add_varmeter):
            add(mon, analysis=pf, noise=True)
        se = pkg.gauss_newton(mon, **_kw(device))
        pkg.state_estimation(se, tolerance=1e-12)
        ses.append((mon, se))
    (jmon, jse), (tmon, tse) = ses
    out = jgt.print_wattmeter_data(tmon, analysis=tse, file=io.StringIO())
    ref = jg.print_wattmeter_data(jmon, analysis=jse, file=io.StringIO())
    assert "Residual" in out and _headers(ref) == _headers(out)
    fmt = {h: "{:.17e}" for h in _headers(ref)}
    ref = jg.print_wattmeter_data(jmon, analysis=jse, file=io.StringIO(),
                                  fmt=fmt)
    out = jgt.print_wattmeter_data(tmon, analysis=tse, file=io.StringIO(),
                                   fmt=fmt)
    assert_same_text(ref, out)
    want, got = _column(ref, "Residual"), _column(out, "Residual")
    scale = np.abs(want).max()
    assert len(got) == tmon.wattmeter.number and scale > 1e-3
    assert np.abs(got - want).max() <= REL_TOL * scale


def test_verbose_iteration_log(data_path, capsys):
    path = str(data_path / "case14test.m")
    outs = []
    for pkg, device in PACKAGES:
        analysis = pkg.newton_raphson(pkg.power_system(path), **_kw(device))
        pkg.power_flow(analysis, verbose=2)
        outs.append(capsys.readouterr().out)
        assert analysis.method.converged
    assert "Maximum Active Mismatch" in outs[1]
    assert "EXIT: The solution was found" in outs[1]
    assert_same_text(outs[0], outs[1])


def test_info_trees(data_path, capsys):
    """print/info.jl equivalents: per-element trees, units, templates."""
    path = str(data_path / "case14test.m")
    outs = []
    for pkg, info in ((jg, jax_info), (jgt, torch_info)):
        system = pkg.power_system(path)
        info.print_system(system, bus=system.bus.label.label(0))
        info.print_system(system, branch=system.branch.label.label(3))
        info.print_system(system, generator=system.generator.label.label(0))
        mon = pkg.measurement(system)
        pkg.add_voltmeter(mon, bus=system.bus.label.label(0), magnitude=1.05)
        pkg.add_pmu(mon, bus=system.bus.label.label(1), magnitude=1.0,
                    angle=0.0, polar=True)
        info.print_monitoring(mon, voltmeter=1)
        info.print_monitoring(mon, pmu=1)
        for name in ("bus", "branch", "generator", "voltmeter", "ammeter",
                     "wattmeter", "varmeter", "pmu"):
            getattr(info, f"print_{name}_unit")()
            getattr(info, f"print_{name}_template")()
        outs.append(capsys.readouterr().out)
    out = outs[1]
    assert "📁" in out and "Demand Power" in out and "Layout" in out
    assert "Type: slack" in out and "Resistance" in out
    assert "Output Power" in out and "Active Power Cost" in out
    assert "Voltage Magnitude Measurement" in out
    assert "Voltage Angle Measurement" in out and "Polar: True" in out
    assert out == outs[0]


def test_verbose_solver_tables(data_path, capsys):
    """print/solver.jl equivalents: statistics blocks, iteration tables,
    increment/residual summaries, EXIT lines."""
    path = str(data_path / "case14test.m")
    outs = []
    for pkg, device in PACKAGES:
        system = pkg.power_system(path)
        pf = pkg.newton_raphson(system, **_kw(device))
        pkg.power_flow(pf, verbose=3)
        dcpf = pkg.dc_power_flow(system, **_kw(device))
        pkg.power_flow(dcpf, verbose=2)
        pkg.power_flow(pf, power=True)
        mon = pkg.measurement(system)
        pkg.add_voltmeter(mon, analysis=pf, noise=False)
        pkg.add_wattmeter(mon, analysis=pf, noise=False)
        pkg.add_varmeter(mon, analysis=pf, noise=False)
        se = pkg.gauss_newton(mon, **_kw(device))
        pkg.state_estimation(se, verbose=3)
        assert se.method.converged
        outs.append(capsys.readouterr().out)
    out = outs[1]
    for line in ("Number of buses:", "Number of entries in the Jacobian:",
                 "Maximum Active Mismatch", "Magnitude Increment:",
                 "EXIT: The solution was found using the Newton-Raphson "
                 "method", "Number of entries in the nodal matrix:",
                 "EXIT: The solution of the DC power flow was found.",
                 "Number of wattmeters:",
                 "Objective Value   Maximum Increment",
                 "Absolute Residual:",
                 "EXIT: The solution was found using the Gauss-Newton "
                 "method"):
        assert line in out, line
    # a noiseless estimate's objective and residuals are rounding: ~1e-20
    assert_same_text(outs[0], outs[1])


def test_print_format_contract(data_path):
    """Reference keyword contract (print/powerSystem.jl:1-52): per-column
    fmt/width/show dicts, repeat headers, style/delimiter, title, label."""
    path = str(data_path / "case14test.m")
    (js, jpf), (ts, tpf) = (_solved_nr(p, d, path) for p, d in PACKAGES)
    out = same_table("print_bus_data", (jpf,), (tpf,),
                     fmt={"Voltage Magnitude": "%.2f"},
                     width={"Voltage Angle": 25},
                     show={"Power Demand Reactive": False})
    assert "Power Demand Reactive" not in out
    header = next(l for l in out.splitlines() if "Voltage Angle" in l)
    cell = [c for c in header.split("|") if "Voltage Angle" in c][0]
    assert len(cell) >= 27
    assert len([c.strip() for c in out.splitlines()[-2].split("|")][2]
               .split(".")[-1]) == 2
    assert same_table("print_bus_data", (jpf,), (tpf,), repeat=5) \
        .count("Voltage Magnitude") >= 3
    out = jgt.print_bus_data(tpf, file=io.StringIO(), style=False,
                             delimiter=";")
    assert "+--" not in out and ";" in out
    assert_same_text(jg.print_bus_data(jpf, file=io.StringIO(), style=False,
                                       delimiter=";"), out)
    out = jgt.print_bus_data(tpf, file=io.StringIO(), title="Custom",
                             header=False)
    assert out.startswith("Custom") and "Voltage Magnitude" not in out
    assert_same_text(jg.print_bus_data(jpf, file=io.StringIO(),
                                       title="Custom", header=False), out)
    out = same_table("print_bus_data", (jpf,), (tpf,),
                     label=ts.bus.label.label(2))
    assert out.count("\n") < 10

    mons = []
    for (pkg, _), system, pf in ((PACKAGES[0], js, jpf),
                                 (PACKAGES[1], ts, tpf)):
        mon = pkg.measurement(system)
        pkg.add_voltmeter(mon, analysis=pf, noise=False)
        mons.append(mon)
    out = same_table("print_voltmeter_data", (mons[0],), (mons[1],),
                     label=mons[1].voltmeter.label.label(1),
                     fmt={"Measurement Mean": "%.3f"})
    assert out.count("\n") < 10
    with pytest.raises(TypeError):
        jgt.print_bus_data(tpf, file=io.StringIO(), nonsense=1)


def test_ac_constraint_tables_off_optimum(data_path):
    """The AC balance and flow columns at a point off the optimum, where
    the balance is of the perturbation's size and not ~0: the same seeded
    perturbation of ``_x0`` in both packages, and the port's columns held
    to the JAX package's within REL_TOL of each column's largest
    magnitude."""
    opfs = _ac_opfs(data_path)
    x0 = np.asarray(opfs[0]._x0)
    assert x0.shape == np.asarray(opfs[1]._x0).shape
    dx = 0.05 * np.random.default_rng(SEED).standard_normal(x0.shape)
    for analysis in opfs:
        analysis._x0 = np.asarray(analysis._x0) + dx
    for printer, names in (
            ("print_bus_constraint", ("Active Power Balance Solution",
                                      "Reactive Power Balance Solution")),
            ("print_branch_constraint", ("Flow Solution",))):
        fmt = {name: "{:.17e}" for name in names}
        ref = getattr(jg, printer)(opfs[0], file=io.StringIO(), fmt=fmt)
        out = getattr(jgt, printer)(opfs[1], file=io.StringIO(), fmt=fmt)
        assert_same_text(ref, out)
        for name in names:
            want, got = _column(ref, name), _column(out, name)
            scale = np.abs(want).max()
            assert len(got) == len(want) and scale > 1e-2, (name, scale)
            assert np.abs(got - want).max() <= REL_TOL * scale, name
