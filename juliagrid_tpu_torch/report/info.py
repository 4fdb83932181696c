"""Per-element info trees, keyword-unit listings, and template listings.

Behavioral equivalent of JuliaGrid src/print/info.jl (678 LoC):
``print_system(system, bus=...)`` and friends dump every stored field of
one element as the same 📁/📂 tree the reference prints; the unit and
template listings mirror busUnit()/busTemplate() etc. Values are printed
as stored (per-unit / radians), exactly like the reference's raw
``println`` of the container fields.
"""

from __future__ import annotations

import math
import sys

import numpy as np

from ..templates import template
from ..units import units


class _Tree:
    """📁 tree writer with reference-style box drawing."""

    def __init__(self, title, file=None):
        self.file = file or sys.stdout
        self.sections = []
        print(f"📁 {title}", file=self.file)

    def section(self, name, rows, last=False):
        lead = "└── 📂 " if last else "├── 📂 "
        bar = "    " if last else "│   "
        print(lead + name, file=self.file)
        for i, (key, value) in enumerate(rows):
            tick = "└── " if i == len(rows) - 1 else "├── "
            print(f"{bar}{tick}{key}: {value}", file=self.file)


def _fmt(v):
    if isinstance(v, float) and math.isinf(v):
        return "Inf" if v > 0 else "-Inf"
    return v


# ---------------------------------------------------------------------------
# Per-element info (reference info.jl:373-564)
# ---------------------------------------------------------------------------

def print_system(system, *, bus=None, branch=None, generator=None,
                 file=None):
    """Reference Base.print(system; bus=..., branch=..., generator=...)."""
    if bus is not None:
        _print_bus(system, bus, file)
    elif branch is not None:
        _print_branch(system, branch, file)
    elif generator is not None:
        _print_generator(system, generator, file)


def _print_bus(system, label, file):
    idx = system.bus.label.index(label)
    b = system.bus
    t = _Tree(label, file)
    if b.demand.active[idx] != 0.0 or b.demand.reactive[idx] != 0.0:
        t.section("Demand Power", [("Active", b.demand.active[idx]),
                                   ("Reactive", b.demand.reactive[idx])])
    if b.supply.active[idx] != 0.0 or b.supply.reactive[idx] != 0.0:
        t.section("Supply Power", [("Active", b.supply.active[idx]),
                                   ("Reactive", b.supply.reactive[idx])])
    if b.shunt.conductance[idx] != 0.0 or b.shunt.susceptance[idx] != 0.0:
        t.section("Shunt Power",
                  [("Conductance", b.shunt.conductance[idx]),
                   ("Susceptance", b.shunt.susceptance[idx])])
    t.section("Initial Voltage", [("Magnitude", b.voltage.magnitude[idx]),
                                  ("Angle", b.voltage.angle[idx])])
    t.section("Voltage Magnitude Limit",
              [("Minimum", _fmt(b.voltage.min_magnitude[idx])),
               ("Maximum", _fmt(b.voltage.max_magnitude[idx]))])
    t.section("Base Voltage",
              [("Value", system.base.voltage.value[idx]),
               ("Unit", system.base.voltage.unit)])
    kind = {1: "demand", 2: "generator", 3: "slack"}[int(b.layout.type[idx])]
    t.section("Layout", [("Type", kind),
                         ("Area", int(b.layout.area[idx])),
                         ("Loss Zone", int(b.layout.loss_zone[idx])),
                         ("Index", idx)], last=True)


def _print_branch(system, label, file):
    idx = system.branch.label.index(label)
    br = system.branch
    prm = br.parameter
    ftype = int(br.flow.type[idx]) if len(br.flow.type) else 3
    flow_name = {1: "Active Power Limit", 2: "Apparent Power Limit",
                 3: "Apparent Power Limit", 4: "Current Magnitude Limit",
                 5: "Current Magnitude Limit"}[ftype]

    t = _Tree(label, file)
    t.section("Parameter",
              [("Resistance", prm.resistance[idx]),
               ("Reactance", prm.reactance[idx]),
               ("Conductance", prm.conductance[idx]),
               ("Susceptance", prm.susceptance[idx]),
               ("Turns Ratio", prm.turns_ratio[idx]),
               ("Phase Shift Angle", prm.shift_angle[idx])])
    flows = [br.flow.min_from_bus[idx], br.flow.max_from_bus[idx],
             br.flow.min_to_bus[idx], br.flow.max_to_bus[idx]]
    if any(f != 0.0 and not math.isinf(f) for f in flows):
        t.section(flow_name,
                  [("From-Bus Minimum", _fmt(flows[0])),
                   ("From-Bus Maximum", _fmt(flows[1])),
                   ("To-Bus Minimum", _fmt(flows[2])),
                   ("To-Bus Maximum", _fmt(flows[3]))])
    two_pi = 2 * math.pi
    if br.voltage.min_diff_angle[idx] > -two_pi \
            or br.voltage.max_diff_angle[idx] < two_pi:
        t.section("Voltage Angle Difference Limit",
                  [("Minimum", _fmt(br.voltage.min_diff_angle[idx])),
                   ("Maximum", _fmt(br.voltage.max_diff_angle[idx]))])
    t.section("Layout",
              [("From-Bus",
                system.bus.label.label(int(br.layout.from_bus[idx]))),
               ("To-Bus",
                system.bus.label.label(int(br.layout.to_bus[idx]))),
               ("Status", int(br.layout.status[idx])),
               ("Index", idx)], last=True)


def _print_generator(system, label, file):
    idx = system.generator.label.index(label)
    gen = system.generator
    c = gen.capability
    p, q = gen.cost.active, gen.cost.reactive

    t = _Tree(label, file)
    t.section("Output Power", [("Active", gen.output.active[idx]),
                               ("Reactive", gen.output.reactive[idx])])
    if (c.min_active[idx] != 0.0 or not math.isinf(c.max_active[idx])
            or not math.isinf(c.min_reactive[idx])
            or not math.isinf(c.max_reactive[idx])):
        t.section("Output Power Limit",
                  [("Minimum Active", _fmt(c.min_active[idx])),
                   ("Maximum Active", _fmt(c.max_active[idx])),
                   ("Minimum Reactive", _fmt(c.min_reactive[idx])),
                   ("Maximum Reactive", _fmt(c.max_reactive[idx]))])
    curve = (c.low_active[idx], c.min_low_reactive[idx],
             c.max_low_reactive[idx], c.up_active[idx],
             c.min_up_reactive[idx], c.max_up_reactive[idx])
    if any(x != 0 for x in curve):
        t.section("Capability Curve",
                  [("Low Active", curve[0]),
                   ("Minimum Reactive", curve[1]),
                   ("Maximum Reactive", curve[2]),
                   ("Up Active", curve[3]),
                   ("Minimum Reactive", curve[4]),
                   ("Maximum Reactive", curve[5])])
    t.section("Voltage", [("Magnitude", gen.voltage.magnitude[idx])])
    for store, name in ((p, "Active Power Cost"),
                        (q, "Reactive Power Cost")):
        if idx in store.polynomial or idx in store.piecewise:
            model = int(store.model[idx])
            in_use = {1: "piecewise", 2: "polynomial"}.get(model,
                                                           "undefined")
            t.section(name,
                      [("Polynomial",
                        [float(x) for x in store.polynomial[idx]]
                        if idx in store.polynomial else "undefined"),
                       ("Piecewise",
                        np.asarray(store.piecewise[idx]).tolist()
                        if idx in store.piecewise else "undefined"),
                       ("In-Use", in_use)])
    t.section("Layout",
              [("Bus", system.bus.label.label(int(gen.layout.bus[idx]))),
               ("Status", int(gen.layout.status[idx])),
               ("Index", idx)], last=True)


# ---------------------------------------------------------------------------
# Per-device measurement info (reference info.jl:526-678)
# ---------------------------------------------------------------------------

def print_monitoring(monitoring, *, voltmeter=None, ammeter=None,
                     wattmeter=None, varmeter=None, pmu=None, file=None):
    """Reference Base.print(monitoring; voltmeter=..., ...)."""
    system = monitoring.system
    if voltmeter is not None:
        dev = monitoring.voltmeter
        idx = dev.label.index(voltmeter)
        t = _Tree(voltmeter, file)
        t.section("Voltage Magnitude Measurement",
                  [("Mean", dev.magnitude.mean[idx]),
                   ("Variance", dev.magnitude.variance[idx]),
                   ("Status", int(dev.magnitude.status[idx]))])
        t.section("Layout",
                  [("Bus",
                    system.bus.label.label(int(dev.layout.index[idx]))),
                   ("Index", idx)], last=True)
    elif ammeter is not None:
        dev = monitoring.ammeter
        idx = dev.label.index(ammeter)
        lbl = system.branch.label.label(int(dev.layout.index[idx]))
        t = _Tree(ammeter, file)
        t.section("Current Magnitude Measurement",
                  [("Mean", dev.magnitude.mean[idx]),
                   ("Variance", dev.magnitude.variance[idx]),
                   ("Status", int(dev.magnitude.status[idx]))])
        side = "From-Bus" if dev.layout.from_[idx] else "To-Bus"
        t.section("Layout", [(side, lbl), ("Index", idx)], last=True)
    elif wattmeter is not None:
        _power_meter_info(monitoring.wattmeter, "Active Power Measurement",
                          "active", wattmeter, system, file)
    elif varmeter is not None:
        _power_meter_info(monitoring.varmeter, "Reactive Power Measurement",
                          "reactive", varmeter, system, file)
    elif pmu is not None:
        dev = monitoring.pmu
        idx = dev.label.index(pmu)
        at_bus = bool(dev.layout.bus[idx])
        lbl = (system.bus.label if at_bus else system.branch.label).label(
            int(dev.layout.index[idx]))
        t = _Tree(pmu, file)
        kind = "Voltage" if at_bus else "Current"
        t.section(f"{kind} Magnitude Measurement",
                  [("Mean", dev.magnitude.mean[idx]),
                   ("Variance", dev.magnitude.variance[idx]),
                   ("Status", int(dev.magnitude.status[idx]))])
        t.section(f"{kind} Angle Measurement",
                  [("Mean", dev.angle.mean[idx]),
                   ("Variance", dev.angle.variance[idx]),
                   ("Status", int(dev.angle.status[idx]))])
        side = "Bus" if at_bus else (
            "From-Bus" if dev.layout.from_[idx] else "To-Bus")
        t.section("Layout",
                  [(side, lbl),
                   ("Polar", bool(dev.layout.polar[idx])),
                   ("Correlated", bool(dev.layout.correlated[idx])),
                   ("Index", idx)], last=True)


def _power_meter_info(dev, title, meter_field, label, system, file):
    idx = dev.label.index(label)
    at_bus = bool(dev.layout.bus[idx])
    lbl = (system.bus.label if at_bus else system.branch.label).label(
        int(dev.layout.index[idx]))
    meter = getattr(dev, meter_field)
    t = _Tree(label, file)
    t.section(title, [("Mean", meter.mean[idx]),
                      ("Variance", meter.variance[idx]),
                      ("Status", int(meter.status[idx]))])
    side = "Bus" if at_bus else (
        "From-Bus" if dev.layout.from_[idx] else "To-Bus")
    t.section("Layout", [(side, lbl), ("Index", idx)], last=True)


# ---------------------------------------------------------------------------
# Keyword-unit listings (reference info.jl:1-107)
# ---------------------------------------------------------------------------

def print_bus_unit(file=None):
    u = units
    t = _Tree("Bus Keyword Units", file)
    t.section("Demand Power", [("active", u.active_power),
                               ("reactive", u.reactive_power)])
    t.section("Shunt Power", [("conductance", u.active_power),
                              ("susceptance", u.reactive_power)])
    t.section("Initial Voltage", [("magnitude", u.voltage_magnitude),
                                  ("angle", u.voltage_angle)])
    t.section("Voltage Magnitude Limit",
              [("min_magnitude", u.voltage_magnitude),
               ("max_magnitude", u.voltage_magnitude)])
    t.section("Base Voltage", [("base", u.base_voltage_unit)], last=True)


def print_branch_unit(file=None):
    u = units
    t = _Tree("Branch Keyword Units", file)
    t.section("Parameter", [("resistance", u.impedance),
                            ("reactance", u.impedance),
                            ("conductance", u.admittance),
                            ("susceptance", u.admittance),
                            ("shift_angle", u.voltage_angle)])
    t.section("Voltage Angle Difference Limit",
              [("min_diff_angle", u.voltage_angle),
               ("max_diff_angle", u.voltage_angle)])
    t.section("Flow Limit",
              [("type 1", u.active_power),
               ("type 2, 3", u.apparent_power),
               ("type 4, 5", u.current_magnitude)], last=True)


def print_generator_unit(file=None):
    u = units
    t = _Tree("Generator Keyword Units", file)
    t.section("Output Power", [("active", u.active_power),
                               ("reactive", u.reactive_power)])
    t.section("Output Power Limit",
              [("min_active", u.active_power),
               ("max_active", u.active_power),
               ("min_reactive", u.reactive_power),
               ("max_reactive", u.reactive_power)])
    t.section("Capability Curve",
              [("low_active", u.active_power),
               ("min_low_reactive", u.reactive_power),
               ("max_low_reactive", u.reactive_power),
               ("up_active", u.active_power),
               ("min_up_reactive", u.reactive_power),
               ("max_up_reactive", u.reactive_power)])
    t.section("Voltage", [("magnitude", u.voltage_magnitude)])
    t.section("Active Power Cost",
              [("piecewise", f"{u.active_power}, $/hr"),
               ("polynomial", f"$/{u.active_power}ⁿ-hr")])
    t.section("Reactive Power Cost",
              [("piecewise", f"{u.reactive_power}, $/hr"),
               ("polynomial", f"$/{u.reactive_power}ⁿ-hr")], last=True)


def print_voltmeter_unit(file=None):
    u = units
    t = _Tree("Voltmeter Keyword Units", file)
    t.section("Voltage Magnitude Measurement",
              [("magnitude", u.voltage_magnitude),
               ("variance", u.voltage_magnitude)], last=True)


def print_ammeter_unit(file=None):
    u = units
    t = _Tree("Ammeter Keyword Units", file)
    t.section("Current Magnitude Measurement",
              [("magnitude", u.current_magnitude),
               ("variance", u.current_magnitude)], last=True)


def print_wattmeter_unit(file=None):
    u = units
    t = _Tree("Wattmeter Keyword Units", file)
    t.section("Active Power Measurement",
              [("active", u.active_power),
               ("variance", u.active_power)], last=True)


def print_varmeter_unit(file=None):
    u = units
    t = _Tree("Varmeter Keyword Units", file)
    t.section("Reactive Power Measurement",
              [("reactive", u.reactive_power),
               ("variance", u.reactive_power)], last=True)


def print_pmu_unit(file=None):
    u = units
    t = _Tree("PMU Keyword Units", file)
    t.section("Voltage Phasor Measurement",
              [("magnitude", u.voltage_magnitude),
               ("variance_magnitude", u.voltage_magnitude),
               ("angle", u.voltage_angle),
               ("variance_angle", u.voltage_angle)])
    t.section("Current Phasor Measurement",
              [("magnitude", u.current_magnitude),
               ("variance_magnitude", u.current_magnitude),
               ("angle", u.current_angle),
               ("variance_angle", u.current_angle)], last=True)


# ---------------------------------------------------------------------------
# Template listings (reference info.jl:109-283)
# ---------------------------------------------------------------------------

def _tpl(value):
    """Format a templated (value, is_pu) pair like the reference infoTpl."""
    if isinstance(value, tuple):
        v, pu = value
        return f"{v} [{'pu' if pu else 'SI'}]"
    return value


def print_bus_template(file=None):
    b = template.bus
    t = _Tree("Bus Template", file)
    t.section("Label", [("label", b.label)])
    t.section("Demand Power", [("active", _tpl(b.active)),
                               ("reactive", _tpl(b.reactive))])
    t.section("Shunt Power", [("conductance", _tpl(b.conductance)),
                              ("susceptance", _tpl(b.susceptance))])
    t.section("Initial Voltage", [("magnitude", _tpl(b.magnitude)),
                                  ("angle", _tpl(b.angle))])
    t.section("Voltage Magnitude Limit",
              [("min_magnitude", _tpl(b.min_magnitude)),
               ("max_magnitude", _tpl(b.max_magnitude))])
    t.section("Base Voltage", [("base", b.base)])
    t.section("Layout", [("type", b.type), ("area", b.area),
                         ("loss_zone", b.loss_zone)], last=True)


def print_branch_template(file=None):
    b = template.branch
    t = _Tree("Branch Template", file)
    t.section("Label", [("label", b.label)])
    t.section("Parameter", [("resistance", _tpl(b.resistance)),
                            ("reactance", _tpl(b.reactance)),
                            ("conductance", _tpl(b.conductance)),
                            ("susceptance", _tpl(b.susceptance)),
                            ("turns_ratio", b.turns_ratio),
                            ("shift_angle", _tpl(b.shift_angle))])
    t.section("Flow Limit", [("min_from_bus", _tpl(b.min_from_bus)),
                             ("max_from_bus", _tpl(b.max_from_bus)),
                             ("min_to_bus", _tpl(b.min_to_bus)),
                             ("max_to_bus", _tpl(b.max_to_bus)),
                             ("type", b.type)])
    t.section("Voltage Angle Difference Limit",
              [("min_diff_angle", _tpl(b.min_diff_angle)),
               ("max_diff_angle", _tpl(b.max_diff_angle))])
    t.section("Layout", [("status", b.status)], last=True)


def print_generator_template(file=None):
    g = template.generator
    t = _Tree("Generator Template", file)
    t.section("Label", [("label", g.label)])
    t.section("Output Power", [("active", _tpl(g.active)),
                               ("reactive", _tpl(g.reactive))])
    t.section("Output Power Limit",
              [("min_active", _tpl(g.min_active)),
               ("max_active", _tpl(g.max_active)),
               ("min_reactive", _tpl(g.min_reactive)),
               ("max_reactive", _tpl(g.max_reactive))])
    t.section("Capability Curve",
              [("low_active", _tpl(g.low_active)),
               ("min_low_reactive", _tpl(g.min_low_reactive)),
               ("max_low_reactive", _tpl(g.max_low_reactive)),
               ("up_active", _tpl(g.up_active)),
               ("min_up_reactive", _tpl(g.min_up_reactive)),
               ("max_up_reactive", _tpl(g.max_up_reactive))])
    t.section("Voltage", [("magnitude", _tpl(g.magnitude))])
    t.section("Layout", [("status", g.status)], last=True)


def print_voltmeter_template(file=None):
    v = template.voltmeter
    t = _Tree("Voltmeter Template", file)
    t.section("Label", [("label", v.label)])
    t.section("Voltage Magnitude Measurement",
              [("variance", _tpl(v.variance)),
               ("status", v.status), ("noise", v.noise)], last=True)


def print_ammeter_template(file=None):
    a = template.ammeter
    t = _Tree("Ammeter Template", file)
    t.section("Label", [("label", a.label)])
    t.section("Current Magnitude Measurement",
              [("variance_from", _tpl(a.variance_from)),
               ("variance_to", _tpl(a.variance_to)),
               ("status_from", a.status_from),
               ("status_to", a.status_to),
               ("square", a.square), ("noise", a.noise)], last=True)


def print_wattmeter_template(file=None):
    w = template.wattmeter
    t = _Tree("Wattmeter Template", file)
    t.section("Label", [("label", w.label)])
    t.section("Active Power Measurement",
              [("variance_bus", _tpl(w.variance_bus)),
               ("variance_from", _tpl(w.variance_from)),
               ("variance_to", _tpl(w.variance_to)),
               ("status_bus", w.status_bus),
               ("status_from", w.status_from),
               ("status_to", w.status_to),
               ("noise", w.noise)], last=True)


def print_varmeter_template(file=None):
    v = template.varmeter
    t = _Tree("Varmeter Template", file)
    t.section("Label", [("label", v.label)])
    t.section("Reactive Power Measurement",
              [("variance_bus", _tpl(v.variance_bus)),
               ("variance_from", _tpl(v.variance_from)),
               ("variance_to", _tpl(v.variance_to)),
               ("status_bus", v.status_bus),
               ("status_from", v.status_from),
               ("status_to", v.status_to),
               ("noise", v.noise)], last=True)


def print_pmu_template(file=None):
    p = template.pmu
    t = _Tree("PMU Template", file)
    t.section("Label", [("label", p.label)])
    t.section("Voltage Phasor Measurement",
              [("variance_magnitude_bus", _tpl(p.variance_magnitude_bus)),
               ("variance_angle_bus", _tpl(p.variance_angle_bus)),
               ("status_bus", p.status_bus)])
    t.section("Current Phasor Measurement",
              [("variance_magnitude_from", _tpl(p.variance_magnitude_from)),
               ("variance_angle_from", _tpl(p.variance_angle_from)),
               ("variance_magnitude_to", _tpl(p.variance_magnitude_to)),
               ("variance_angle_to", _tpl(p.variance_angle_to)),
               ("status_from", p.status_from),
               ("status_to", p.status_to)])
    t.section("Layout", [("polar", p.polar),
                         ("correlated", p.correlated),
                         ("square", p.square)], last=True)
