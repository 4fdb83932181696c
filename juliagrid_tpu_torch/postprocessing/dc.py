"""DC postprocessing (reference JuliaGrid src/postprocessing/
dcAnalysis.jl:27-147 power! and :149-352 getters)."""

from __future__ import annotations

import numpy as np

from .results import Cartesian, DcPower


def _pi(system, theta, i):
    """B row-i dot theta + shunt conductance + shift power
    (reference Pi, dcAnalysis.jl:377-392)."""
    dc = system.model.dc
    row = dc.nodal.getrow(i)
    return (row.dot(theta)[0] + system.bus.shunt.conductance[i]
            + dc.shift_power[i])


def power(analysis):
    system = analysis.system
    bus = system.bus
    gen = system.generator
    dc = system.model.dc
    n = bus.number
    theta = np.asarray(analysis.voltage.angle)
    slack = bus.layout.slack
    kind = getattr(analysis, "kind", "power_flow")

    out = DcPower()

    p_all = dc.nodal.dot(theta) + dc.shift_power \
        + bus.shunt.conductance.array[:n]
    demand = bus.demand.active.array[:n]

    if kind == "state_estimation":
        injection = p_all
        supply = injection + demand
        gen_a = np.zeros(gen.number)
    elif kind == "optimal_power_flow":
        injection = p_all
        supply = np.zeros(n)
        gb = gen.layout.bus.array[: gen.number]
        gen_a = analysis.power.generator.active
        np.add.at(supply, gb, gen_a)
    else:
        injection = bus.supply.active.array[:n] - demand
        injection[slack] = p_all[slack]
        supply = bus.supply.active.array[:n].copy()
        supply[slack] = demand[slack] + injection[slack]
        # generators: slack's first unit balances the bus
        gen_a = np.zeros(gen.number)
        for i in range(gen.number):
            if gen.layout.status[i] != 1:
                continue
            b = int(gen.layout.bus[i])
            members = bus.supply.generator.get(b, [])
            if b == slack and members and members[0] == i:
                gen_a[i] = p_all[slack] + demand[slack]
                for j in members[1:]:
                    gen_a[i] -= gen.output.active[j]
            else:
                gen_a[i] = gen.output.active[i]

    out.injection = Cartesian(active=injection)
    out.supply = Cartesian(active=supply)
    out.generator = Cartesian(active=gen_a)

    # branch flows (allPowerBranch, dcAnalysis.jl:353-374)
    m = system.branch.number
    f = system.branch.layout.from_bus.array[:m]
    t = system.branch.layout.to_bus.array[:m]
    shift = system.branch.parameter.shift_angle.array[:m]
    from_active = dc.admittance * (theta[f] - theta[t] - shift)
    out.from_ = Cartesian(active=from_active)
    out.to = Cartesian(active=-from_active)

    analysis.power = out
    return out


def injection_power(analysis, label):
    if analysis.power is None:
        power(analysis)
    return analysis.power.injection.active[
        analysis.system.bus.label.index(label)]


def supply_power(analysis, label):
    if analysis.power is None:
        power(analysis)
    return analysis.power.supply.active[
        analysis.system.bus.label.index(label)]


def from_power(analysis, label):
    if analysis.power is None:
        power(analysis)
    return analysis.power.from_.active[
        analysis.system.branch.label.index(label)]


def to_power(analysis, label):
    if analysis.power is None:
        power(analysis)
    return analysis.power.to.active[
        analysis.system.branch.label.index(label)]


def generator_power(analysis, label):
    if analysis.power is None:
        power(analysis)
    return analysis.power.generator.active[
        analysis.system.generator.label.index(label)]
