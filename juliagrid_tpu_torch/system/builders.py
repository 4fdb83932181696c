"""Element CRUD builders: add/update bus, branch, generator, and costs.

Behavioral equivalent of the reference mutators
(JuliaGrid src/powerSystem/bus.jl:65-258, branch.jl:79-471,
generator.jl:73-381, :709-809): template defaulting, live input-unit
conversion, supply accumulation, slack uniqueness, status bookkeeping, and
revision bumps. Nodal-model maintenance: single-element updates patch the
live CSR in place with the reference's -stamp/mutate/+stamp dance
(acNodalUpdate!/acParameterUpdate!, model.jl:81-132; shunt delta,
bus.jl:222-240) in O(log nnz) per edit; adding elements invalidates and
lazily rebuilds the vectorized assembly. Analyses detect the revision bump
and refresh their device snapshots, preserving the reference's
reuse-semantics contract (its ``reusing`` test suites).
"""

from __future__ import annotations

import math

import numpy as np

from ..templates import template
from ..units import topu, units
from .model import ac_model, dc_model
from .types import PowerSystem, check_status
from ..utils.errors import CostError


def _nan_default(value, default_pair, shadow):
    """Reference add! with shadow (utility.jl:356-372): a NaN template means
    'derive from 5x the shadow value' when the caller gave nothing."""
    val, is_pu = default_pair
    if value is None and isinstance(val, float) and math.isnan(val):
        return 5 * shadow, True
    return value, False


def add_bus(system: PowerSystem, label=None, *, type=None, active=None,
            reactive=None, conductance=None, susceptance=None,
            magnitude=None, angle=None, min_magnitude=None,
            max_magnitude=None, base=None, area=None, loss_zone=None):
    """Reference addBus! (bus.jl:65-128)."""
    bus = system.bus
    tpl = template.bus
    u = units

    idx = bus.label.add(label)
    bus.number += 1

    base_voltage = (base * u.pfx_base_voltage if base is not None
                    else tpl.base * u.pfx_base_voltage)
    system.base.voltage.value.append(base_voltage)

    base_power_inv = 1.0 / (system.base.power.value * system.base.power.prefix)
    base_voltage_inv = 1.0 / base_voltage

    bus.demand.active.append(topu(active, tpl.active, u.pfx_active,
                                  base_power_inv))
    bus.demand.reactive.append(topu(reactive, tpl.reactive, u.pfx_reactive,
                                    base_power_inv))
    bus.shunt.conductance.append(topu(conductance, tpl.conductance,
                                      u.pfx_active, base_power_inv))
    bus.shunt.susceptance.append(topu(susceptance, tpl.susceptance,
                                      u.pfx_reactive, base_power_inv))
    bus.supply.active.append(0.0)
    bus.supply.reactive.append(0.0)

    vbase_inv = math.sqrt(3) * base_voltage_inv
    bus.voltage.magnitude.append(topu(magnitude, tpl.magnitude,
                                      u.pfx_voltage, vbase_inv))
    bus.voltage.angle.append(topu(angle, tpl.angle, u.pfx_angle, 1.0))
    if bus.layout.optimal:
        bus.voltage.min_magnitude.append(
            topu(min_magnitude, tpl.min_magnitude, u.pfx_voltage, vbase_inv))
        bus.voltage.max_magnitude.append(
            topu(max_magnitude, tpl.max_magnitude, u.pfx_voltage, vbase_inv))

    bus_type = int(type) if type is not None else tpl.type
    if bus_type not in (1, 2, 3):
        raise ValueError(f"the bus type {bus_type} is not allowed")
    if bus_type == 3:
        if bus.layout.slack >= 0:
            raise ValueError(
                "The slack bus has already been designated.")
        bus.layout.slack = idx
    bus.layout.type.append(bus_type)
    bus.layout.area.append(area if area is not None else tpl.area)
    bus.layout.loss_zone.append(
        loss_zone if loss_zone is not None else tpl.loss_zone)

    # adding a bus invalidates the nodal models (reference bus.jl:111-127)
    system.model.ac.nodal = None
    system.model.dc.nodal = None
    system.topology_changed()
    return idx


def update_bus(system: PowerSystem, label, *, type=None, active=None,
               reactive=None, conductance=None, susceptance=None,
               magnitude=None, angle=None, min_magnitude=None,
               max_magnitude=None, base=None, area=None, loss_zone=None):
    """Reference updateBus! (bus.jl:165-258)."""
    bus = system.bus
    u = units
    idx = bus.label.index(label)
    base_power_inv = 1.0 / (system.base.power.value * system.base.power.prefix)

    if base is not None:
        system.base.voltage.value[idx] = base * u.pfx_base_voltage
    base_voltage_inv = 1.0 / system.base.voltage.value[idx]
    vbase_inv = math.sqrt(3) * base_voltage_inv

    if active is not None:
        bus.demand.active[idx] = topu(active, None, u.pfx_active,
                                      base_power_inv) \
            if u.pfx_active else float(active)
        system.injection_changed()
    if reactive is not None:
        bus.demand.reactive[idx] = topu(reactive, None, u.pfx_reactive,
                                        base_power_inv) \
            if u.pfx_reactive else float(reactive)
        system.injection_changed()

    shunt_changed = conductance is not None or susceptance is not None
    _old_shunt = complex(bus.shunt.conductance[idx],
                         bus.shunt.susceptance[idx])
    if conductance is not None:
        bus.shunt.conductance[idx] = topu(conductance, None, u.pfx_active,
                                          base_power_inv) \
            if u.pfx_active else float(conductance)
    if susceptance is not None:
        bus.shunt.susceptance[idx] = topu(susceptance, None, u.pfx_reactive,
                                          base_power_inv) \
            if u.pfx_reactive else float(susceptance)

    if magnitude is not None:
        bus.voltage.magnitude[idx] = topu(magnitude, None, u.pfx_voltage,
                                          vbase_inv) \
            if u.pfx_voltage else float(magnitude)
    if angle is not None:
        bus.voltage.angle[idx] = (angle * u.pfx_angle if u.pfx_angle
                                  else float(angle))
    if bus.layout.optimal:
        if min_magnitude is not None:
            bus.voltage.min_magnitude[idx] = topu(
                min_magnitude, None, u.pfx_voltage, vbase_inv) \
                if u.pfx_voltage else float(min_magnitude)
        if max_magnitude is not None:
            bus.voltage.max_magnitude[idx] = topu(
                max_magnitude, None, u.pfx_voltage, vbase_inv) \
                if u.pfx_voltage else float(max_magnitude)
    if area is not None:
        bus.layout.area[idx] = area
    if loss_zone is not None:
        bus.layout.loss_zone[idx] = loss_zone

    if type is not None:
        new_type = int(type)
        if new_type not in (1, 2, 3):
            raise ValueError(f"the bus type {new_type} is not allowed")
        old_type = int(bus.layout.type[idx])
        if new_type == 3 and bus.layout.slack >= 0 and bus.layout.slack != idx:
            # moving the slack designation
            bus.layout.type[bus.layout.slack] = 2
            bus.layout.slack = idx
            system.slack_changed()
        elif old_type == 3 and new_type != 3:
            bus.layout.slack = -1
            system.slack_changed()
        if new_type == 3:
            bus.layout.slack = idx
        bus.layout.type[idx] = new_type
        system.type_changed()

    if shunt_changed and system.model.ac.nodal is not None:
        # diagonal ± stamp (reference updateBusMain! shunt delta-update,
        # bus.jl:222-240): O(log nnz), not a full reassembly
        new_shunt = complex(bus.shunt.conductance[idx],
                            bus.shunt.susceptance[idx])
        system.model.ac.nodal[idx, idx] += new_shunt - _old_shunt
        system.ac_model_changed()
    return idx


def add_branch(system: PowerSystem, label=None, *, from_bus, to_bus,
               resistance=None, reactance=None, conductance=None,
               susceptance=None, turns_ratio=None, shift_angle=None,
               min_diff_angle=None, max_diff_angle=None,
               min_from_bus=None, max_from_bus=None, min_to_bus=None,
               max_to_bus=None, type=None, status=None):
    """Reference addBranch! (branch.jl:79-180)."""
    branch = system.branch
    tpl = template.branch
    u = units

    i = system.bus.label.index(from_bus)
    j = system.bus.label.index(to_bus)
    if i == j:
        raise ValueError(
            "the branch cannot connect a bus to itself")

    idx = branch.label.add(label)
    branch.number += 1

    tau = turns_ratio if turns_ratio is not None else tpl.turns_ratio
    base_power_inv = 1.0 / (system.base.power.value * system.base.power.prefix)
    base_voltage = system.base.voltage.value[i]
    from ..units import base_impedance
    zbase = base_impedance(base_voltage, base_power_inv, tau)
    zbase_inv = 1.0 / zbase if zbase != 0 else 1.0

    r = topu(resistance, tpl.resistance, u.pfx_impedance, zbase_inv)
    x = topu(reactance, tpl.reactance, u.pfx_impedance, zbase_inv)
    if r == 0.0 and x == 0.0:
        raise ValueError(
            "At least one of the keywords resistance or reactance "
            "must be provided and nonzero.")

    branch.parameter.resistance.append(r)
    branch.parameter.reactance.append(x)
    branch.parameter.conductance.append(
        topu(conductance, tpl.conductance, u.pfx_admittance, zbase))
    branch.parameter.susceptance.append(
        topu(susceptance, tpl.susceptance, u.pfx_admittance, zbase))
    branch.parameter.turns_ratio.append(tau)
    branch.parameter.shift_angle.append(
        topu(shift_angle, tpl.shift_angle, u.pfx_angle, 1.0))

    branch.layout.from_bus.append(i)
    branch.layout.to_bus.append(j)
    st = check_status(status if status is not None else tpl.status)
    branch.layout.status.append(st)
    if st == 1:
        branch.layout.inservice += 1

    if branch.flow.type is not None:
        flow_type = type if type is not None else tpl.type
        branch.flow.type.append(flow_type)
        pfx_flow = {1: u.pfx_active, 2: u.pfx_apparent, 3: u.pfx_apparent,
                    4: u.pfx_current, 5: u.pfx_current}.get(flow_type, 0.0)
        branch.flow.min_from_bus.append(
            topu(min_from_bus, tpl.min_from_bus, pfx_flow, base_power_inv))
        branch.flow.max_from_bus.append(
            topu(max_from_bus, tpl.max_from_bus, pfx_flow, base_power_inv))
        branch.flow.min_to_bus.append(
            topu(min_to_bus, tpl.min_to_bus, pfx_flow, base_power_inv))
        branch.flow.max_to_bus.append(
            topu(max_to_bus, tpl.max_to_bus, pfx_flow, base_power_inv))
        branch.voltage.min_diff_angle.append(
            topu(min_diff_angle, tpl.min_diff_angle, u.pfx_angle, 1.0))
        branch.voltage.max_diff_angle.append(
            topu(max_diff_angle, tpl.max_diff_angle, u.pfx_angle, 1.0))

    _invalidate_models(system)
    system.topology_changed()
    return idx


def update_branch(system: PowerSystem, label, *, status=None, resistance=None,
                  reactance=None, conductance=None, susceptance=None,
                  turns_ratio=None, shift_angle=None, min_diff_angle=None,
                  max_diff_angle=None, min_from_bus=None, max_from_bus=None,
                  min_to_bus=None, max_to_bus=None, type=None):
    """Reference updateBranch! (branch.jl:307-471)."""
    branch = system.branch
    u = units
    idx = branch.label.index(label)
    prm = branch.parameter

    # validate every raising conversion BEFORE touching the stamps, so a
    # bad argument cannot leave the Y-bus/B matrices half-updated
    if status is not None:
        status = check_status(status)

    # subtract the OLD stamps before any mutation (reference updateBranch!
    # does exactly this dance: -stamp, mutate, +stamp; branch.jl:307-471)
    from .model import (ac_nodal_update, ac_parameter_update,
                        dc_nodal_update, dc_parameter_update,
                        dc_shift_update)
    has_ac = system.model.ac.nodal is not None
    has_dc = system.model.dc.nodal is not None
    if has_ac:
        ac_nodal_update(system, idx, sign=-1.0)
    if has_dc:
        dc_shift_update(system, idx, sign=-1.0)
        dc_nodal_update(system, idx, sign=-1.0)

    try:
        _update_branch_body(
            system, idx, status=status, resistance=resistance,
            reactance=reactance, conductance=conductance,
            susceptance=susceptance, turns_ratio=turns_ratio,
            shift_angle=shift_angle, min_diff_angle=min_diff_angle,
            max_diff_angle=max_diff_angle, min_from_bus=min_from_bus,
            max_from_bus=max_from_bus, min_to_bus=min_to_bus,
            max_to_bus=max_to_bus, type=type)
    finally:
        # re-add stamps consistent with the CURRENT (possibly partially
        # mutated) parameters — the invariant Y-bus == assembly(params)
        # holds even if the mutation raised mid-way
        if has_ac:
            ac_parameter_update(system, idx)
            ac_nodal_update(system, idx, sign=1.0)
        if has_dc:
            dc_parameter_update(system, idx)
            dc_nodal_update(system, idx, sign=1.0)
            dc_shift_update(system, idx, sign=1.0)
    return idx


def _update_branch_body(system, idx, *, status, resistance, reactance,
                        conductance, susceptance, turns_ratio, shift_angle,
                        min_diff_angle, max_diff_angle, min_from_bus,
                        max_from_bus, min_to_bus, max_to_bus, type):
    branch = system.branch
    u = units
    prm = branch.parameter
    i = int(branch.layout.from_bus[idx])
    tau = turns_ratio if turns_ratio is not None \
        else float(prm.turns_ratio[idx])
    base_power_inv = 1.0 / (system.base.power.value * system.base.power.prefix)
    from ..units import base_impedance
    zbase = base_impedance(system.base.voltage.value[i], base_power_inv, tau)
    zbase_inv = 1.0 / zbase if zbase != 0 else 1.0

    changed = False
    for name, value, pfx, scale in (
            ("resistance", resistance, u.pfx_impedance, zbase_inv),
            ("reactance", reactance, u.pfx_impedance, zbase_inv),
            ("conductance", conductance, u.pfx_admittance, zbase),
            ("susceptance", susceptance, u.pfx_admittance, zbase)):
        if value is not None:
            getattr(prm, name)[idx] = (value * pfx * scale) if pfx \
                else float(value)
            changed = True
    if turns_ratio is not None:
        prm.turns_ratio[idx] = turns_ratio
        changed = True
    if shift_angle is not None:
        prm.shift_angle[idx] = shift_angle * u.pfx_angle if u.pfx_angle \
            else float(shift_angle)
        changed = True

    if status is not None:  # already validated by update_branch
        old = int(branch.layout.status[idx])
        if status != old:
            branch.layout.status[idx] = status
            branch.layout.inservice += 1 if status == 1 else -1
            changed = True

    if branch.flow.type is not None:
        if type is not None:
            branch.flow.type[idx] = type
        flow_type = int(branch.flow.type[idx])
        pfx_flow = {1: u.pfx_active, 2: u.pfx_apparent, 3: u.pfx_apparent,
                    4: u.pfx_current, 5: u.pfx_current}.get(flow_type, 0.0)
        for name, value in (("min_from_bus", min_from_bus),
                            ("max_from_bus", max_from_bus),
                            ("min_to_bus", min_to_bus),
                            ("max_to_bus", max_to_bus)):
            if value is not None:
                getattr(branch.flow, name)[idx] = \
                    value * pfx_flow * base_power_inv if pfx_flow \
                    else float(value)
        for name, value in (("min_diff_angle", min_diff_angle),
                            ("max_diff_angle", max_diff_angle)):
            if value is not None:
                getattr(branch.voltage, name)[idx] = \
                    value * u.pfx_angle if u.pfx_angle else float(value)

    # the caller (update_branch) refreshes the per-branch stamps and adds
    # them back — O(log nnz) instead of the O(nnz + m) full reassembly
    # (the pattern keeps out-of-service slots as structural zeros, so even
    # status flips are value-only and no analysis needs a symbolic rebuild)
    if changed:
        system.ac_model_changed()
        system.dc_model_changed()
        system.model.revision.topology += 1
    else:
        system.optimization_changed()


def add_generator(system: PowerSystem, label=None, *, bus, active=None,
                  reactive=None, magnitude=None, min_active=None,
                  max_active=None, min_reactive=None, max_reactive=None,
                  low_active=None, min_low_reactive=None,
                  max_low_reactive=None, up_active=None,
                  min_up_reactive=None, max_up_reactive=None, status=None):
    """Reference addGenerator! (generator.jl:73-148)."""
    gen = system.generator
    tpl = template.generator
    u = units

    bus_idx = system.bus.label.index(bus)
    idx = gen.label.add(label)
    gen.number += 1

    base_power_inv = 1.0 / (system.base.power.value * system.base.power.prefix)
    base_voltage_inv = math.sqrt(3) / system.base.voltage.value[bus_idx]

    p = topu(active, tpl.active, u.pfx_active, base_power_inv)
    q = topu(reactive, tpl.reactive, u.pfx_reactive, base_power_inv)
    gen.output.active.append(p)
    gen.output.reactive.append(q)

    # NaN templates derive bounds from 5x the output (reference add! shadow)
    ma, used = _nan_default(max_active, tpl.max_active, abs(p))
    gen.capability.min_active.append(
        topu(min_active, tpl.min_active, u.pfx_active, base_power_inv))
    gen.capability.max_active.append(
        ma if used else topu(max_active, tpl.max_active, u.pfx_active,
                             base_power_inv))
    mr, used = _nan_default(min_reactive, tpl.min_reactive, abs(q))
    gen.capability.min_reactive.append(
        -mr if used else topu(min_reactive, tpl.min_reactive,
                              u.pfx_reactive, base_power_inv))
    xr, used = _nan_default(max_reactive, tpl.max_reactive, abs(q))
    gen.capability.max_reactive.append(
        xr if used else topu(max_reactive, tpl.max_reactive,
                             u.pfx_reactive, base_power_inv))

    for name, value, tname in (
            ("low_active", low_active, "low_active"),
            ("min_low_reactive", min_low_reactive, "min_low_reactive"),
            ("max_low_reactive", max_low_reactive, "max_low_reactive"),
            ("up_active", up_active, "up_active"),
            ("min_up_reactive", min_up_reactive, "min_up_reactive"),
            ("max_up_reactive", max_up_reactive, "max_up_reactive")):
        pfx = u.pfx_active if "active" in tname else u.pfx_reactive
        getattr(gen.capability, name).append(
            topu(value, getattr(tpl, tname), pfx, base_power_inv))

    gen.voltage.magnitude.append(
        topu(magnitude, tpl.magnitude, u.pfx_voltage, base_voltage_inv))

    gen.layout.bus.append(bus_idx)
    st = check_status(status if status is not None else tpl.status)
    gen.layout.status.append(st)

    gen.cost.active.model.append(0)
    gen.cost.reactive.model.append(0)

    if st == 1:
        system.add_gen_in_bus(bus_idx, idx)
        system.bus.supply.active[bus_idx] += p
        system.bus.supply.reactive[bus_idx] += q
        gen.layout.inservice += 1
    system.injection_changed()
    return idx


def update_generator(system: PowerSystem, label, *, bus=None, active=None,
                     reactive=None, magnitude=None, min_active=None,
                     max_active=None, min_reactive=None, max_reactive=None,
                     low_active=None, min_low_reactive=None,
                     max_low_reactive=None, up_active=None,
                     min_up_reactive=None, max_up_reactive=None, status=None):
    """Reference updateGenerator! (generator.jl:262-381)."""
    gen = system.generator
    u = units
    idx = gen.label.index(label)
    bus_idx = int(gen.layout.bus[idx])
    base_power_inv = 1.0 / (system.base.power.value * system.base.power.prefix)

    old_status = int(gen.layout.status[idx])
    old_p = float(gen.output.active[idx])
    old_q = float(gen.output.reactive[idx])

    if active is not None:
        gen.output.active[idx] = active * u.pfx_active * base_power_inv \
            if u.pfx_active else float(active)
    if reactive is not None:
        gen.output.reactive[idx] = \
            reactive * u.pfx_reactive * base_power_inv \
            if u.pfx_reactive else float(reactive)
    if magnitude is not None:
        base_voltage_inv = math.sqrt(3) / system.base.voltage.value[bus_idx]
        gen.voltage.magnitude[idx] = \
            magnitude * u.pfx_voltage * base_voltage_inv \
            if u.pfx_voltage else float(magnitude)

    for name, value, is_active in (
            ("min_active", min_active, True), ("max_active", max_active, True),
            ("min_reactive", min_reactive, False),
            ("max_reactive", max_reactive, False),
            ("low_active", low_active, True), ("up_active", up_active, True),
            ("min_low_reactive", min_low_reactive, False),
            ("max_low_reactive", max_low_reactive, False),
            ("min_up_reactive", min_up_reactive, False),
            ("max_up_reactive", max_up_reactive, False)):
        if value is not None:
            pfx = u.pfx_active if is_active else u.pfx_reactive
            getattr(gen.capability, name)[idx] = \
                value * pfx * base_power_inv if pfx else float(value)

    new_status = check_status(status) if status is not None else old_status
    new_p = float(gen.output.active[idx])
    new_q = float(gen.output.reactive[idx])

    supply = system.bus.supply
    if old_status == 1:
        supply.active[bus_idx] -= old_p
        supply.reactive[bus_idx] -= old_q
        if new_status == 0:
            supply.generator[bus_idx].remove(idx)
            gen.layout.inservice -= 1
    if new_status == 1:
        supply.active[bus_idx] += new_p
        supply.reactive[bus_idx] += new_q
        if old_status == 0:
            system.add_gen_in_bus(bus_idx, idx)
            gen.layout.inservice += 1
    gen.layout.status[idx] = new_status
    system.injection_changed()
    return idx


def cost(system: PowerSystem, label, *, active=None, reactive=None,
         polynomial=None, piecewise=None):
    """Reference cost! (generator.jl:709-809). ``active``/``reactive``
    select which cost to set: pass active=1/2 (piecewise/polynomial model
    tag) like the reference, with the data in the matching keyword."""
    gen = system.generator
    idx = gen.label.index(label)

    def _set(store, model_tag):
        if model_tag not in (1, 2):
            raise CostError("the cost model must be 1 (piecewise) "
                            "or 2 (polynomial)")
        store.model[idx] = model_tag
        if model_tag == 2 and polynomial is not None:
            store.polynomial[idx] = np.asarray(polynomial, dtype=float)
        if model_tag == 1 and piecewise is not None:
            pts = np.asarray(piecewise, dtype=float)
            if pts.ndim != 2 or pts.shape[1] != 2:
                raise CostError("piecewise cost must be an (N, 2) matrix")
            store.piecewise[idx] = pts

    if active is not None:
        _set(gen.cost.active, int(active))
    if reactive is not None:
        _set(gen.cost.reactive, int(reactive))
    system.optimization_changed()
    return idx


def _invalidate_models(system: PowerSystem):
    system.model.ac.nodal = None
    system.model.dc.nodal = None


def _rebuild_models(system: PowerSystem):
    """Re-run vectorized assembly for models that exist."""
    if system.model.ac.nodal is not None:
        ac_model(system)
    if system.model.dc.nodal is not None:
        dc_model(system)
