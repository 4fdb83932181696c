"""AC postprocessing: bulk ``power``/``current`` and per-element getters.

Vectorized numpy implementation of
JuliaGrid src/postprocessing/acAnalysis.jl:30-279 (power!),
:672-723 (current!), and the per-element getters (:281-838). Formula
conventions (two-port params, charging, series loss, slack/PV generator
distribution rules incl. the unbounded-reactive-capability handling,
acAnalysis.jl:95-160) match the reference exactly.
"""

from __future__ import annotations

import numpy as np

from .results import AcCurrent, AcPower, Cartesian, PolarResult


def _complex_voltage(analysis):
    vm = np.asarray(analysis.voltage.magnitude)
    va = np.asarray(analysis.voltage.angle)
    return vm * np.exp(1j * va)


def _branch_voltages(system, v):
    m = system.branch.number
    f = system.branch.layout.from_bus.array[:m]
    t = system.branch.layout.to_bus.array[:m]
    prm = system.branch.parameter
    tij = (1.0 / prm.turns_ratio.array[:m]) * np.exp(
        -1j * prm.shift_angle.array[:m])
    vi = v[f]
    vj = v[t]
    return f, t, vi, vj, tij * vi - vj


def injection_currents(system, v):
    """I = Y V (complex, per bus)."""
    return system.model.ac.nodal.dot(v)


def power(analysis):
    """Reference power! (acAnalysis.jl:30-169 for power flow; the supply
    conventions for OPF/SE variants are handled by the analysis type)."""
    system = analysis.system
    bus = system.bus
    n = bus.number
    ac = system.model.ac
    slack = bus.layout.slack

    v = _complex_voltage(analysis)
    vm = np.abs(v)

    out = AcPower()

    # buses
    ysh = bus.shunt.conductance.array[:n] + 1j * bus.shunt.susceptance.array[:n]
    s_shunt = vm**2 * np.conj(ysh)
    out.shunt = Cartesian(s_shunt.real, s_shunt.imag)

    s_inj = v * np.conj(injection_currents(system, v))
    out.injection = Cartesian(s_inj.real.copy(), s_inj.imag.copy())

    kind = getattr(analysis, "kind", "power_flow")
    supply_a = bus.supply.active.array[:n].copy()
    supply_r = bus.supply.reactive.array[:n].copy()
    types = bus.layout.type.array[:n]
    demand_r = bus.demand.reactive.array[:n]
    demand_a = bus.demand.active.array[:n]

    if kind == "state_estimation":
        supply_a = s_inj.real + demand_a
        supply_r = s_inj.imag + demand_r
    elif kind == "optimal_power_flow":
        supply_a = np.zeros(n)
        supply_r = np.zeros(n)
        g = system.generator
        gb = g.layout.bus.array[: g.number]
        np.add.at(supply_a, gb, analysis.power.generator.active)
        np.add.at(supply_r, gb, analysis.power.generator.reactive)
    else:
        nonpq = types != 1
        supply_r[nonpq] = s_inj.imag[nonpq] + demand_r[nonpq]
        supply_a[slack] = s_inj.real[slack] + demand_a[slack]
    out.supply = Cartesian(supply_a, supply_r)

    # branches
    m = system.branch.number
    f, t, vi, vj, vij = _branch_voltages(system, v)
    on = system.branch.layout.status.array[:m] == 1
    s_from = np.where(on, vi * np.conj(vi * ac.nodal_from_from
                                       + vj * ac.nodal_from_to), 0.0)
    s_to = np.where(on, vj * np.conj(vi * ac.nodal_to_from
                                     + vj * ac.nodal_to_to), 0.0)
    s_series = np.where(on, vij * np.conj(ac.admittance * vij), 0.0)
    prm = system.branch.parameter
    tau_inv = 1.0 / prm.turns_ratio.array[:m]
    ych = prm.conductance.array[:m] + 1j * prm.susceptance.array[:m]
    s_chrg = np.where(
        on,
        0.5 * np.conj(ych) * ((tau_inv * np.abs(vi))**2 + np.abs(vj)**2),
        0.0)
    out.from_ = Cartesian(s_from.real, s_from.imag)
    out.to = Cartesian(s_to.real, s_to.imag)
    out.series = Cartesian(s_series.real, s_series.imag)
    out.charging = Cartesian(s_chrg.real, s_chrg.imag)

    # generators (slack/PV distribution rules, acAnalysis.jl:95-160)
    gen = system.generator
    g = gen.number
    gen_a = np.zeros(g)
    gen_r = np.zeros(g)
    if kind == "optimal_power_flow":
        gen_a = analysis.power.generator.active
        gen_r = analysis.power.generator.reactive
    else:
        base_mva = system.base.power.value * system.base.power.prefix * 1e-6
        min_r = gen.capability.min_reactive.array[:g]
        max_r = gen.capability.max_reactive.array[:g]
        for i in range(g):
            if gen.layout.status[i] != 1:
                continue
            b = int(gen.layout.bus[i])
            pi_ = out.injection.active[b]
            qi_ = out.injection.reactive[b]
            members = bus.supply.generator.get(b, [])
            service = len(members)
            if service == 1:
                gen_a[i] = gen.output.active[i]
                gen_r[i] = qi_ + demand_r[b]
                if b == slack:
                    gen_a[i] = pi_ + demand_a[b]
            else:
                qgensum = qi_ + demand_r[b]
                qminsum = sum(min_r[j] for j in members if np.isfinite(min_r[j]))
                qmaxsum = sum(max_r[j] for j in members if np.isfinite(max_r[j]))
                qmin_new, qmax_new = min_r[i], max_r[i]
                qmin_inf = qmax_inf = 0.0
                for j in members:
                    if np.isinf(min_r[j]):
                        qmin = -abs(qgensum) - abs(qminsum) - abs(qmaxsum)
                        if min_r[j] == np.inf:
                            qmin = -qmin
                        if i == j:
                            qmin_new = qmin
                        qmin_inf += qmin
                    if np.isinf(max_r[j]):
                        qmax = abs(qgensum) + abs(qminsum) + abs(qmaxsum)
                        if max_r[j] == -np.inf:
                            qmax = -qmax
                        if i == j:
                            qmax_new = qmax
                        qmax_inf += qmax
                qminsum += qmin_inf
                qmaxsum += qmax_inf
                if base_mva * abs(qminsum - qmaxsum) > 10 * np.finfo(float).eps:
                    gen_r[i] = qmin_new + ((qgensum - qminsum)
                                           / (qmaxsum - qminsum)) \
                        * (qmax_new - qmin_new)
                else:
                    gen_r[i] = qmin_new + (qgensum - qminsum) / service
                if b == slack and members[0] == i:
                    gen_a[i] = pi_ + demand_a[b]
                    for j in members[1:]:
                        gen_a[i] -= gen.output.active[j]
                else:
                    gen_a[i] = gen.output.active[i]
    out.generator = Cartesian(gen_a, gen_r)

    analysis.power = out
    return out


def current(analysis):
    """Reference current! (acAnalysis.jl:672-723): polar injection, from,
    to, and series currents."""
    system = analysis.system
    m = system.branch.number
    ac = system.model.ac
    v = _complex_voltage(analysis)
    on = system.branch.layout.status.array[:m] == 1

    out = AcCurrent()
    iinj = injection_currents(system, v)
    out.injection = PolarResult(np.abs(iinj), np.angle(iinj))

    f, t, vi, vj, vij = _branch_voltages(system, v)
    i_from = np.where(on, vi * ac.nodal_from_from + vj * ac.nodal_from_to, 0.0)
    i_to = np.where(on, vi * ac.nodal_to_from + vj * ac.nodal_to_to, 0.0)
    i_series = np.where(on, ac.admittance * vij, 0.0)
    out.from_ = PolarResult(np.abs(i_from), np.angle(i_from))
    out.to = PolarResult(np.abs(i_to), np.angle(i_to))
    out.series = PolarResult(np.abs(i_series), np.angle(i_series))

    analysis.current = out
    return out


# ---- per-element getters (reference acAnalysis.jl:281-838) ----------------

def _bus_idx(analysis, label):
    return analysis.system.bus.label.index(label)


def _branch_idx(analysis, label):
    return analysis.system.branch.label.index(label)


def injection_power(analysis, label):
    if analysis.power is None:
        power(analysis)
    i = _bus_idx(analysis, label)
    return (analysis.power.injection.active[i],
            analysis.power.injection.reactive[i])


def supply_power(analysis, label):
    if analysis.power is None:
        power(analysis)
    i = _bus_idx(analysis, label)
    return (analysis.power.supply.active[i],
            analysis.power.supply.reactive[i])


def shunt_power(analysis, label):
    if analysis.power is None:
        power(analysis)
    i = _bus_idx(analysis, label)
    return (analysis.power.shunt.active[i], analysis.power.shunt.reactive[i])


def from_power(analysis, label):
    if analysis.power is None:
        power(analysis)
    i = _branch_idx(analysis, label)
    return (analysis.power.from_.active[i], analysis.power.from_.reactive[i])


def to_power(analysis, label):
    if analysis.power is None:
        power(analysis)
    i = _branch_idx(analysis, label)
    return (analysis.power.to.active[i], analysis.power.to.reactive[i])


def charging_power(analysis, label):
    if analysis.power is None:
        power(analysis)
    i = _branch_idx(analysis, label)
    return (analysis.power.charging.active[i],
            analysis.power.charging.reactive[i])


def series_power(analysis, label):
    if analysis.power is None:
        power(analysis)
    i = _branch_idx(analysis, label)
    return (analysis.power.series.active[i],
            analysis.power.series.reactive[i])


def generator_power(analysis, label):
    if analysis.power is None:
        power(analysis)
    i = analysis.system.generator.label.index(label)
    return (analysis.power.generator.active[i],
            analysis.power.generator.reactive[i])


def injection_current(analysis, label):
    if analysis.current is None:
        current(analysis)
    i = _bus_idx(analysis, label)
    return (analysis.current.injection.magnitude[i],
            analysis.current.injection.angle[i])


def from_current(analysis, label):
    if analysis.current is None:
        current(analysis)
    i = _branch_idx(analysis, label)
    return (analysis.current.from_.magnitude[i],
            analysis.current.from_.angle[i])


def to_current(analysis, label):
    if analysis.current is None:
        current(analysis)
    i = _branch_idx(analysis, label)
    return (analysis.current.to.magnitude[i], analysis.current.to.angle[i])


def series_current(analysis, label):
    if analysis.current is None:
        current(analysis)
    i = _branch_idx(analysis, label)
    return (analysis.current.series.magnitude[i],
            analysis.current.series.angle[i])
