"""Tabular reporting: bus/branch/generator data, summaries, constraint and
measurement tables.

Functional equivalent of the reference print subsystem
(JuliaGrid src/print/, 7k LoC): a width-negotiating table engine with
unit-aware headers, per-label filtering, optional delimiter style, and
min/max/total summaries (print/powerSystem.jl:53-2147,
print/measurement.jl, print/constraint.jl). Values are displayed in the
live units configured via the unit system.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from ..opf.acopf import _AcSpec, flow_values
from ..units import units


def _compile_fmt(spec):
    """Accept both printf-style ("%.2f", reference contract,
    print/powerSystem.jl:14-17) and Python format specs ("{:.2f}")."""
    if spec is None:
        return None
    if "{" in spec:
        return spec
    if spec.startswith("%"):
        body = spec[1:]
        if body and body[-1] in "di":
            body = body[:-1] + "d"
        return "{:" + body + "}"
    return "{:" + spec + "}"


# keyword contract shared by every printer (the reference's
# print/powerSystem.jl:1-52 keyword surface negotiated by
# print/utility.jl): per-column fmt/width/show dicts keyed by header
# name, repeating headers, delimiter/style selection, header/footer
# suppression and a title override.
_TABLE_KWARGS = ("fmt", "width", "show", "repeat", "style", "delimiter",
                 "header", "footer", "title")


class Table:
    """Column-based text table with width negotiation.

    Reference parity: the per-column ``fmt``/``width``/``show`` dicts,
    ``repeat`` headers, ``style``/``delimiter`` selection and
    ``header``/``footer`` switches of print/utility.jl:1-948.
    """

    def __init__(self, title: str = "", style: bool = True,
                 delimiter: str = "|", fmt=None, width=None, show=None,
                 repeat: int = 0, header: bool = True, footer: bool = True):
        self.title = title
        self.style = style
        self.delimiter = delimiter
        self.fmt = {k: _compile_fmt(v) for k, v in (fmt or {}).items()}
        self.width = dict(width or {})
        self.show = dict(show or {})
        self.repeat = int(repeat)
        self.header = header
        self.footer = footer
        self.headers: list[tuple[str, str]] = []   # (name, unit)
        self.columns: list[list[str]] = []

    def add_column(self, name: str, values, unit: str = "", fmt="{:.4f}"):
        if not self.show.get(name, True):
            return
        fmt = self.fmt.get(name, fmt)
        rendered = []
        for v in values:
            if isinstance(v, str):
                rendered.append(v)
            elif v is None or (isinstance(v, float) and math.isnan(v)):
                rendered.append("-")
            elif isinstance(v, (int, np.integer)) and "d" not in fmt:
                rendered.append(str(int(v)))
            else:
                try:
                    rendered.append(fmt.format(float(v)))
                except ValueError:  # integer spec on a float column
                    rendered.append(fmt.format(int(v)))
        self.headers.append((name, unit))
        self.columns.append(rendered)

    def _header_lines(self, widths, line):
        out = []
        if self.style:
            out.append(line)
        out.append(self._row([n for n, _ in self.headers], widths,
                             align="ljust"))
        if any(u for _, u in self.headers):
            out.append(self._row([u for _, u in self.headers], widths,
                                 align="ljust"))
        if self.style:
            out.append(line)
        return out

    def _row(self, vals, widths, align="rjust"):
        cells = [getattr(v, align)(w) for v, w in zip(vals, widths)]
        if self.style:
            return "| " + " | ".join(cells) + " |"
        d = self.delimiter
        return f"{d} " + f" {d} ".join(cells) + f" {d}" if d else \
            " ".join(cells)

    def render(self, file=None) -> str:
        file = file or sys.stdout
        if not self.columns:
            return ""
        nrows = max(len(c) for c in self.columns)
        widths = []
        for (name, unit), col in zip(self.headers, self.columns):
            w = max([len(name), len(unit)] + [len(v) for v in col])
            widths.append(max(w, int(self.width.get(name, 0))))

        out = []
        if self.title:
            out.append(self.title)
        line = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        if self.header:
            out.extend(self._header_lines(widths, line))
        for r in range(nrows):
            if self.repeat and r and r % self.repeat == 0 and self.header:
                out.extend(self._header_lines(widths, line))
            out.append(self._row(
                [col[r] if r < len(col) else "" for col in self.columns],
                widths))
        if self.style and self.footer:
            out.append(line)
        text = "\n".join(out)
        print(text, file=file)
        return text


def _tablekw(kw, default_title=""):
    """Split printer kwargs into the Table keyword set; reject unknowns."""
    opts = {}
    for k in _TABLE_KWARGS:
        if k in kw:
            opts[k] = kw.pop(k)
    if kw:
        raise TypeError(f"unknown printer keyword(s): {sorted(kw)}")
    opts.setdefault("title", default_title)
    if opts["title"] is None:
        opts["title"] = default_title
    return opts


def _angle_scale():
    return 180.0 / math.pi if units.voltage_angle == "deg" else 1.0


def _power_scale(system):
    if units.pfx_active:
        return system.base.power.value * system.base.power.prefix \
            / units.pfx_active
    return 1.0


def print_bus_data(analysis, file=None, label=None, **kw):
    """Reference printBusData (print/powerSystem.jl); accepts the
    fmt/width/show/repeat/style/delimiter/header/footer/title contract."""
    system = analysis.system
    n = system.bus.number
    idxs = [system.bus.label.index(label)] if label is not None \
        else range(n)
    tbl = Table(**_tablekw(kw, "Bus Data"))
    tbl.add_column("Label", [str(system.bus.label.label(i)) for i in idxs])
    vm = np.asarray(analysis.voltage.magnitude) if hasattr(
        analysis.voltage, "magnitude") else None
    va = np.asarray(analysis.voltage.angle)
    a_scale = _angle_scale()
    if vm is not None:
        tbl.add_column("Voltage Magnitude", [vm[i] for i in idxs],
                       units.voltage_magnitude)
    tbl.add_column("Voltage Angle", [va[i] * a_scale for i in idxs],
                   units.voltage_angle)
    if analysis.power is not None:
        p = analysis.power
        p_scale = _power_scale(system)
        if len(getattr(getattr(p, "supply", object()), "active", [])):
            tbl.add_column("Power Generation Active",
                           [p.supply.active[i] * p_scale for i in idxs],
                           units.active_power)
            if len(getattr(p.supply, "reactive", [])):
                tbl.add_column("Power Generation Reactive",
                               [p.supply.reactive[i] * p_scale
                                for i in idxs], units.reactive_power)
        tbl.add_column("Power Demand Active",
                       [system.bus.demand.active[i] * p_scale
                        for i in idxs], units.active_power)
        tbl.add_column("Power Demand Reactive",
                       [system.bus.demand.reactive[i] * p_scale
                        for i in idxs], units.reactive_power)
        tbl.add_column("Power Injection Active",
                       [p.injection.active[i] * p_scale for i in idxs],
                       units.active_power)
        if hasattr(p.injection, "reactive") and len(
                getattr(p.injection, "reactive", [])):
            tbl.add_column("Power Injection Reactive",
                           [p.injection.reactive[i] * p_scale for i in idxs],
                           units.reactive_power)
        if len(getattr(getattr(p, "shunt", object()), "active", [])):
            tbl.add_column("Shunt Power Active",
                           [p.shunt.active[i] * p_scale for i in idxs],
                           units.active_power)
            tbl.add_column("Shunt Power Reactive",
                           [p.shunt.reactive[i] * p_scale for i in idxs],
                           units.reactive_power)
    if getattr(analysis, "current", None) is not None and len(
            getattr(getattr(analysis.current, "injection", object()),
                    "magnitude", [])):
        c = analysis.current
        a_scale = _angle_scale()
        tbl.add_column("Current Injection Magnitude",
                       [c.injection.magnitude[i] for i in idxs],
                       units.current_magnitude)
        tbl.add_column("Current Injection Angle",
                       [c.injection.angle[i] * a_scale for i in idxs],
                       units.current_angle)
    return tbl.render(file)


def print_branch_data(analysis, file=None, label=None, **kw):
    system = analysis.system
    m = system.branch.number
    idxs = [system.branch.label.index(label)] if label is not None \
        else range(m)
    tbl = Table(**_tablekw(kw, "Branch Data"))
    tbl.add_column("Label", [str(system.branch.label.label(i))
                             for i in idxs])
    tbl.add_column("From-Bus", [str(system.bus.label.label(
        int(system.branch.layout.from_bus[i]))) for i in idxs])
    tbl.add_column("To-Bus", [str(system.bus.label.label(
        int(system.branch.layout.to_bus[i]))) for i in idxs])
    tbl.add_column("Status", [int(system.branch.layout.status[i])
                              for i in idxs])
    if analysis.power is not None:
        p = analysis.power
        p_scale = _power_scale(system)
        tbl.add_column("From-Bus Power Active",
                       [p.from_.active[i] * p_scale for i in idxs],
                       units.active_power)
        tbl.add_column("To-Bus Power Active",
                       [p.to.active[i] * p_scale for i in idxs],
                       units.active_power)
        if len(getattr(p.from_, "reactive", [])):
            tbl.add_column("From-Bus Power Reactive",
                           [p.from_.reactive[i] * p_scale for i in idxs],
                           units.reactive_power)
            tbl.add_column("To-Bus Power Reactive",
                           [p.to.reactive[i] * p_scale for i in idxs],
                           units.reactive_power)
        if len(getattr(getattr(p, "series", object()), "active", [])):
            tbl.add_column("Series Loss Active",
                           [p.series.active[i] * p_scale for i in idxs],
                           units.active_power)
            tbl.add_column("Series Loss Reactive",
                           [p.series.reactive[i] * p_scale for i in idxs],
                           units.reactive_power)
        if len(getattr(getattr(p, "charging", object()), "reactive", [])):
            tbl.add_column("Charging Reactive",
                           [p.charging.reactive[i] * p_scale for i in idxs],
                           units.reactive_power)
    if getattr(analysis, "current", None) is not None and len(
            getattr(getattr(analysis.current, "from_", object()),
                    "magnitude", [])):
        c = analysis.current
        a_scale = _angle_scale()
        tbl.add_column("From-Bus Current Magnitude",
                       [c.from_.magnitude[i] for i in idxs],
                       units.current_magnitude)
        tbl.add_column("From-Bus Current Angle",
                       [c.from_.angle[i] * a_scale for i in idxs],
                       units.current_angle)
        tbl.add_column("To-Bus Current Magnitude",
                       [c.to.magnitude[i] for i in idxs],
                       units.current_magnitude)
        tbl.add_column("To-Bus Current Angle",
                       [c.to.angle[i] * a_scale for i in idxs],
                       units.current_angle)
        if len(getattr(c.series, "magnitude", [])):
            tbl.add_column("Series Current Magnitude",
                           [c.series.magnitude[i] for i in idxs],
                           units.current_magnitude)
            tbl.add_column("Series Current Angle",
                           [c.series.angle[i] * a_scale for i in idxs],
                           units.current_angle)
    return tbl.render(file)


def print_generator_data(analysis, file=None, label=None, **kw):
    system = analysis.system
    g = system.generator.number
    idxs = [system.generator.label.index(label)] if label is not None \
        else range(g)
    tbl = Table(**_tablekw(kw, "Generator Data"))
    tbl.add_column("Label", [str(system.generator.label.label(i))
                             for i in idxs])
    tbl.add_column("Bus", [str(system.bus.label.label(
        int(system.generator.layout.bus[i]))) for i in idxs])
    tbl.add_column("Status", [int(system.generator.layout.status[i])
                              for i in idxs])
    if analysis.power is not None and len(
            analysis.power.generator.active):
        p_scale = _power_scale(system)
        tbl.add_column("Power Output Active",
                       [analysis.power.generator.active[i] * p_scale
                        for i in idxs], units.active_power)
        if len(getattr(analysis.power.generator, "reactive", [])):
            tbl.add_column("Power Output Reactive",
                           [analysis.power.generator.reactive[i] * p_scale
                            for i in idxs], units.reactive_power)
    return tbl.render(file)


def print_bus_summary(analysis, file=None, **kw):
    """Reference printBusSummary: min/max/total statistics."""
    vm = np.asarray(getattr(analysis.voltage, "magnitude", []))
    va = np.asarray(analysis.voltage.angle)
    system = analysis.system
    labels = system.bus.label
    a_scale = _angle_scale()
    p_scale = _power_scale(system)

    rows = []
    if vm is not None and vm.size:
        rows.append(("Voltage Magnitude", units.voltage_magnitude,
                     vm, 1.0, False))
    rows.append(("Voltage Angle", units.voltage_angle, va, a_scale, False))
    if analysis.power is not None:
        p = analysis.power
        n = system.bus.number
        for name, unit, arr, tot in (
                ("Power Generation Active", units.active_power,
                 getattr(p.supply, "active", []), True),
                ("Power Generation Reactive", units.reactive_power,
                 getattr(p.supply, "reactive", []), True),
                ("Power Demand Active", units.active_power,
                 system.bus.demand.active.array[:n], True),
                ("Power Demand Reactive", units.reactive_power,
                 system.bus.demand.reactive.array[:n], True),
                ("Power Injection Active", units.active_power,
                 getattr(p.injection, "active", []), True),
                ("Power Injection Reactive", units.reactive_power,
                 getattr(p.injection, "reactive", []), True),
                ("Shunt Power Active", units.active_power,
                 getattr(getattr(p, "shunt", object()), "active", []), True),
                ("Shunt Power Reactive", units.reactive_power,
                 getattr(getattr(p, "shunt", object()), "reactive", []),
                 True)):
            arr = np.asarray(arr)
            if arr.size:
                rows.append((name, unit, arr, p_scale, tot))
    return _summary_table("Bus Summary", rows, labels, file, **kw)


def _summary_table(title, rows, labels, file, **kw):
    """Reference-style summary: per-quantity min/max with labels + totals
    (print/powerSystem.jl busSummary/branchSummary/generatorSummary)."""
    tbl = Table(**_tablekw(kw, title))
    tbl.add_column("Quantity", [f"{name} [{unit}]" if unit else name
                                for name, unit, *_ in rows])
    tbl.add_column("Minimum Label",
                   [str(labels.label(int(np.argmin(a)))) for
                    _, _, a, _, _ in rows])
    tbl.add_column("Minimum", [float(a.min()) * s
                               for _, _, a, s, _ in rows])
    tbl.add_column("Maximum Label",
                   [str(labels.label(int(np.argmax(a)))) for
                    _, _, a, _, _ in rows])
    tbl.add_column("Maximum", [float(a.max()) * s
                               for _, _, a, s, _ in rows])
    tbl.add_column("Total", [float(a.sum()) * s if tot else None
                             for _, _, a, s, tot in rows])
    return tbl.render(file)


def print_branch_summary(analysis, file=None, **kw):
    system = analysis.system
    tbl = Table(**_tablekw(dict(kw), "Branch Summary"))
    if analysis.power is None:
        return tbl.render(file)
    p = analysis.power
    p_scale = _power_scale(system)
    rows = []
    for name, unit, arr, tot in (
            ("From-Bus Power Active", units.active_power,
             getattr(p.from_, "active", []), False),
            ("From-Bus Power Reactive", units.reactive_power,
             getattr(p.from_, "reactive", []), False),
            ("To-Bus Power Active", units.active_power,
             getattr(p.to, "active", []), False),
            ("To-Bus Power Reactive", units.reactive_power,
             getattr(p.to, "reactive", []), False),
            ("Series Loss Active", units.active_power,
             getattr(getattr(p, "series", object()), "active", []), True),
            ("Series Loss Reactive", units.reactive_power,
             getattr(getattr(p, "series", object()), "reactive", []), True),
            ("Charging Reactive", units.reactive_power,
             getattr(getattr(p, "charging", object()), "reactive", []),
             True)):
        arr = np.asarray(arr)
        if arr.size:
            rows.append((name, unit, arr, p_scale, tot))
    if not rows:
        return tbl.render(file)
    return _summary_table("Branch Summary", rows, system.branch.label,
                          file, **kw)


def print_generator_summary(analysis, file=None, **kw):
    system = analysis.system
    tbl = Table(**_tablekw(dict(kw), "Generator Summary"))
    if analysis.power is None or not len(analysis.power.generator.active):
        return tbl.render(file)
    p_scale = _power_scale(system)
    rows = [("Power Output Active", units.active_power,
             np.asarray(analysis.power.generator.active), p_scale, True)]
    qg = np.asarray(getattr(analysis.power.generator, "reactive", []))
    if qg.size:
        rows.append(("Power Output Reactive", units.reactive_power, qg,
                     p_scale, True))
    return _summary_table("Generator Summary", rows,
                          system.generator.label, file, **kw)


def _se_residuals_by_device(analysis, kind):
    """Map SE residuals back to devices of one kind (first matching row)."""
    if analysis is None or getattr(analysis.method, "row_device", None) \
            is None:
        return None
    if analysis.method.residual is None:
        from ..estimation.acse import residuals
        residuals(analysis)
    out = {}
    for row, (k, dev) in enumerate(analysis.method.row_device):
        if k == kind and dev not in out:
            out[dev] = analysis.method.residual[row]
    return out


def _meter_table(title, store, meter, kind, analysis=None, file=None,
                 label=None, **kw):
    tbl = Table(**_tablekw(kw, title))
    idxs = [store.label.index(label)] if label is not None \
        else range(store.number)
    tbl.add_column("Label", [str(store.label.label(i)) for i in idxs])
    tbl.add_column("Measurement Mean", [meter.mean.array[i] for i in idxs])
    tbl.add_column("Measurement Variance",
                   [meter.variance.array[i] for i in idxs], fmt="{:.2e}")
    tbl.add_column("Status", [meter.status.array[i] for i in idxs])
    res = _se_residuals_by_device(analysis, kind)
    if res is not None:
        tbl.add_column("Residual",
                       [res.get(i) for i in idxs], fmt="{:.2e}")
    return tbl.render(file)


def print_voltmeter_data(monitoring, analysis=None, file=None, **kw):
    return _meter_table("Voltmeter Data", monitoring.voltmeter,
                        monitoring.voltmeter.magnitude, "voltmeter",
                        analysis, file=file, **kw)


def print_ammeter_data(monitoring, analysis=None, file=None, **kw):
    return _meter_table("Ammeter Data", monitoring.ammeter,
                        monitoring.ammeter.magnitude, "ammeter",
                        analysis, file=file, **kw)


def print_wattmeter_data(monitoring, analysis=None, file=None, **kw):
    return _meter_table("Wattmeter Data", monitoring.wattmeter,
                        monitoring.wattmeter.active, "wattmeter",
                        analysis, file=file, **kw)


def print_varmeter_data(monitoring, analysis=None, file=None, **kw):
    return _meter_table("Varmeter Data", monitoring.varmeter,
                        monitoring.varmeter.reactive, "varmeter",
                        analysis, file=file, **kw)


def print_pmu_data(monitoring, analysis=None, file=None, label=None,
                   **kw):
    pmu = monitoring.pmu
    tbl = Table(**_tablekw(kw, "PMU Data"))
    idxs = [pmu.label.index(label)] if label is not None \
        else range(pmu.number)
    tbl.add_column("Label", [str(pmu.label.label(i)) for i in idxs])
    tbl.add_column("Magnitude Mean",
                   [pmu.magnitude.mean.array[i] for i in idxs])
    tbl.add_column("Angle Mean", [pmu.angle.mean.array[i] for i in idxs])
    tbl.add_column("Magnitude Variance",
                   [pmu.magnitude.variance.array[i] for i in idxs],
                   fmt="{:.2e}")
    tbl.add_column("Angle Variance",
                   [pmu.angle.variance.array[i] for i in idxs],
                   fmt="{:.2e}")
    tbl.add_column("Status", [pmu.magnitude.status.array[i] for i in idxs])
    return tbl.render(file)


def _box_duals(tags, z, lo_tag, hi_tag, size):
    """Net bound dual per element from separate lo/hi inequality rows:
    positive when the lower bound binds, negative when the upper binds
    (JuMP's box-constraint dual sign convention in the reference)."""
    out = np.zeros(size)
    for (tag, el), zi in zip(tags, np.asarray(z)):
        if tag == lo_tag:
            out[el] += zi
        elif tag == hi_tag:
            out[el] -= zi
    return out


def print_bus_constraint(analysis, file=None, label=None, **kw):
    """Reference printBusConstraint (print/constraint.jl:1-180): voltage
    magnitude Minimum/Solution/Maximum/Dual and active/reactive power
    balance Solution/Dual per bus."""
    system = analysis.system
    n = system.bus.number
    idxs = [system.bus.label.index(label)] if label is not None \
        else list(range(n))
    tbl = Table(**_tablekw(kw, "Bus Constraint Data"))
    tbl.add_column("Label", [str(system.bus.label.label(i))
                             for i in idxs])
    dual = analysis.method.dual if analysis.method.dual else {}
    tags = dual.get("ineq_tags", [])
    z = dual.get("ineq", np.zeros(0))
    spec = getattr(analysis, "_spec", None)
    if hasattr(analysis.voltage, "magnitude"):
        vm = np.asarray(analysis.voltage.magnitude)
        tbl.add_column("Voltage Magnitude Minimum",
                       system.bus.voltage.min_magnitude.array[:n][idxs])
        tbl.add_column("Voltage Magnitude Solution", vm[idxs])
        tbl.add_column("Voltage Magnitude Maximum",
                       system.bus.voltage.max_magnitude.array[:n][idxs])
        if len(tags):
            vd = _box_duals(tags, z, "voltage_min", "voltage_max", n)
            tbl.add_column("Voltage Magnitude Dual", vd[idxs],
                           fmt="{:.4e}")
    # balance solution = constraint residual at the optimum (~0); the AC
    # spec's first 2n rows (the JAX package prints none for the DC OPF)
    has_eq = (isinstance(spec, _AcSpec)
              and getattr(analysis, "_x0", None) is not None)
    if has_eq:
        ce = spec.eq(torch.as_tensor(analysis._x0, device=spec.device))
        ce = ce.cpu().numpy()
        tbl.add_column("Active Power Balance Solution",
                       ce[:n][idxs], fmt="{:.2e}")
    bal = dual.get("balance", dual.get("balance_active"))
    if bal is not None:
        tbl.add_column("Active Power Balance Dual", np.asarray(bal)[idxs],
                       fmt="{:.4e}")
    if has_eq:
        tbl.add_column("Reactive Power Balance Solution",
                       ce[n:2 * n][idxs], fmt="{:.2e}")
    bal_q = dual.get("balance_reactive")
    if bal_q is not None:
        tbl.add_column("Reactive Power Balance Dual",
                       np.asarray(bal_q)[idxs], fmt="{:.4e}")
    return tbl.render(file)


def print_branch_constraint(analysis, file=None, label=None, **kw):
    """Reference printBranchConstraint (print/constraint.jl:430-780):
    angle-difference and flow Minimum/Solution/Maximum/Dual per
    constrained branch, plus the generic tag/dual rows for anything the
    column layout doesn't cover."""
    system = analysis.system
    dual = analysis.method.dual if analysis.method.dual else {}
    tags = dual.get("ineq_tags", [])
    z = np.asarray(dual.get("ineq", []))
    if isinstance(dual.get("ineq"), dict):
        z = np.asarray(list(dual["ineq"].values()))
    tbl = Table(**_tablekw(kw, "Branch Constraint Data"))
    want = system.branch.label.index(label) if label is not None else None
    spec = getattr(analysis, "_spec", None)

    if spec is not None and getattr(spec, "fl_k", None) is not None \
            and len(getattr(spec, "fl_k", ())):
        # per-branch flow columns from the spec's vectorized flow rows
        x = torch.as_tensor(analysis._x0, device=spec.device)
        theta, v = x[:spec.n], x[spec.n:2 * spec.n]
        vals = flow_values(spec.arrays, theta, v).cpu().numpy()
        fl_dual = np.zeros(len(spec.fl_k))
        for (tag, el), zi in zip(tags, z):
            if tag.startswith("flow_") and tag.endswith("_min"):
                fl_dual[np.flatnonzero(spec.fl_k == el)] += zi
            elif tag.startswith("flow_") and tag.endswith("_max"):
                fl_dual[np.flatnonzero(spec.fl_k == el)] -= zi
        sel = np.arange(len(spec.fl_k)) if want is None \
            else np.flatnonzero(spec.fl_k == want)
        tbl.add_column("Label", [str(system.branch.label.label(
            int(spec.fl_k[i]))) for i in sel])
        tbl.add_column("Flow Side", ["from" if spec.fl_from[i] else "to"
                                     for i in sel])
        tbl.add_column("Flow Minimum", spec.fl_lo[sel])
        tbl.add_column("Flow Solution", vals[sel])
        tbl.add_column("Flow Maximum", spec.fl_hi[sel])
        tbl.add_column("Flow Dual", fl_dual[sel], fmt="{:.4e}")
    rows = [(tag, el, z[i]) for i, (tag, el) in enumerate(tags)
            if "angle" in tag and (want is None or el == want)]
    if rows:
        tbl.add_column("Angle Constraint", [r[0] for r in rows])
        tbl.add_column("Angle Branch",
                       [str(system.branch.label.label(r[1]))
                        for r in rows])
        tbl.add_column("Angle Dual", [r[2] for r in rows], fmt="{:.4e}")
    if not tbl.columns:
        rows = [(tag, el, z[i]) for i, (tag, el) in enumerate(tags)
                if ("flow" in tag or "angle" in tag)
                and (want is None or el == want)]
        tbl.add_column("Constraint", [r[0] for r in rows])
        tbl.add_column("Branch", [str(system.branch.label.label(r[1]))
                                  for r in rows])
        tbl.add_column("Dual", [r[2] for r in rows], fmt="{:.4e}")
    return tbl.render(file)


def print_generator_constraint(analysis, file=None, label=None, **kw):
    """Reference printGeneratorConstraint (print/constraint.jl:880-1100):
    active/reactive output Minimum/Solution/Maximum/Dual per generator."""
    system = analysis.system
    g = system.generator.number
    dual = analysis.method.dual if analysis.method.dual else {}
    tags = dual.get("ineq_tags", [])
    z = np.asarray(dual.get("ineq", []))
    if isinstance(dual.get("ineq"), dict):
        z = np.asarray(list(dual["ineq"].values()))
    tbl = Table(**_tablekw(kw, "Generator Constraint Data"))
    want = system.generator.label.index(label) if label is not None \
        else None
    idxs = [want] if want is not None else list(range(g))
    power = getattr(analysis, "power", None)
    if power is not None and getattr(power, "generator", None) is not None:
        cap = system.generator.capability
        pg = np.asarray(power.generator.active)
        qg = np.asarray(power.generator.reactive)
        tbl.add_column("Label", [str(system.generator.label.label(i))
                                 for i in idxs])
        tbl.add_column("Active Power Minimum",
                       cap.min_active.array[:g][idxs])
        tbl.add_column("Active Power Solution", pg[idxs])
        tbl.add_column("Active Power Maximum",
                       cap.max_active.array[:g][idxs])
        has_q = len(qg) >= g  # DC OPF carries no reactive outputs
        if has_q:
            tbl.add_column("Reactive Power Minimum",
                           cap.min_reactive.array[:g][idxs])
            tbl.add_column("Reactive Power Solution", qg[idxs])
            tbl.add_column("Reactive Power Maximum",
                           cap.max_reactive.array[:g][idxs])
        if len(tags):
            pd = _box_duals(tags, z, "active_min", "active_max", g)
            tbl.add_column("Active Power Dual", pd[idxs], fmt="{:.4e}")
            if has_q:
                qd = _box_duals(tags, z, "reactive_min", "reactive_max", g)
                tbl.add_column("Reactive Power Dual", qd[idxs],
                               fmt="{:.4e}")
        return tbl.render(file)
    rows = [(tag, el, z[i]) for i, (tag, el) in enumerate(tags)
            if ("capability" in tag or "active" in tag
                or "reactive" in tag)
            and (want is None or el == want)]
    tbl.add_column("Constraint", [r[0] for r in rows])
    tbl.add_column("Generator", [str(system.generator.label.label(r[1]))
                                 for r in rows])
    tbl.add_column("Dual", [r[2] for r in rows], fmt="{:.4e}")
    return tbl.render(file)
