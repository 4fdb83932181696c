"""Device CRUD: add/update for voltmeters, ammeters, wattmeters, varmeters,
and PMUs — manual placement and bulk generation from a solved analysis.

Behavioral equivalent of JuliaGrid src/measurement/{voltmeter,ammeter,
powermeter,pmu}.jl: template defaulting, live-unit conversion of means and
variances against the right base (voltage base for voltmeters/PMU-bus,
current base for ammeters/PMU-branch, power base for watt/varmeters), the
optional Gaussian ``noise`` on the mean (measurement/utility.jl:29-51), and
the bulk-add ordering (buses first, then in-service branches from/to).
Status -1 in bulk adds means "do not include this group".
"""

from __future__ import annotations

import math

import numpy as np

from ..templates import template
from ..units import base_current_inv, topu, units
from ..system.types import check_status
from .types import Measurement
from ..utils.errors import DeviceStatusError, VarianceError

_rng = np.random.default_rng()


def seed(value: int) -> None:
    """Seed measurement-noise generation (tests / reproducibility)."""
    global _rng
    _rng = np.random.default_rng(value)


def _meter_value(mean, variance, status, noise, def_variance, def_status,
                 pfx_live, base_inv):
    """Reference meterValue (measurement/utility.jl:29-51)."""
    var = topu(variance, def_variance, pfx_live, base_inv)
    if var <= 0:
        raise VarianceError("the variance must be positive")
    st = check_status(status if status is not None else def_status)
    measure = topu(mean, (0.0, True), pfx_live, base_inv) \
        if mean is not None else 0.0
    if noise:
        measure += math.sqrt(var) * _rng.standard_normal()
    return measure, var, st


def _wide_status(status, default):
    st = int(status) if status is not None else int(default)
    if st not in (-1, 0, 1):
        raise DeviceStatusError(f"the status {st} is not allowed")
    return st


# ---------------------------------------------------------------------------
# Voltmeter
# ---------------------------------------------------------------------------

def add_voltmeter(monitoring: Measurement, label=None, *, bus=None,
                  magnitude=None, variance=None, status=None, noise=None,
                  analysis=None):
    """Reference addVoltmeter! — manual (bus + magnitude) or bulk from a
    solved AC analysis (analysis=...)."""
    system = monitoring.system
    volt = monitoring.voltmeter
    tpl = template.voltmeter
    nz = tpl.noise if noise is None else noise

    if analysis is not None:
        st = _wide_status(status, tpl.status)
        if st == -1:
            return
        for i in range(system.bus.number):
            base_inv = math.sqrt(3) / (system.base.voltage.value[i]
                                       * system.base.voltage.prefix)
            mean, var, _ = _meter_value(
                float(analysis.voltage.magnitude[i]), variance, st, nz,
                tpl.variance, tpl.status, units.pfx_voltage, base_inv)
            volt.label.add(None)
            volt.layout.index.append(i)
            volt.magnitude.mean.append(mean)
            volt.magnitude.variance.append(var)
            volt.magnitude.status.append(st)
            volt.number += 1
        monitoring.changed()
        return

    idx_bus = system.bus.label.index(bus)
    base_inv = math.sqrt(3) / (system.base.voltage.value[idx_bus]
                               * system.base.voltage.prefix)
    mean, var, st = _meter_value(magnitude, variance, status, nz,
                                 tpl.variance, tpl.status,
                                 units.pfx_voltage, base_inv)
    volt.label.add(label)
    volt.layout.index.append(idx_bus)
    volt.magnitude.mean.append(mean)
    volt.magnitude.variance.append(var)
    volt.magnitude.status.append(st)
    volt.number += 1
    monitoring.changed()
    return volt.number - 1


def update_voltmeter(monitoring: Measurement, label, *, magnitude=None,
                     variance=None, status=None, noise=None):
    volt = monitoring.voltmeter
    idx = volt.label.index(label)
    i = int(volt.layout.index[idx])
    system = monitoring.system
    base_inv = math.sqrt(3) / (system.base.voltage.value[i]
                               * system.base.voltage.prefix)
    _update_meter(volt.magnitude, idx, magnitude, variance, status, noise,
                  units.pfx_voltage, base_inv)
    monitoring.changed_values()
    return idx


def _update_meter(meter, idx, mean, variance, status, noise, pfx, base_inv):
    if variance is not None:
        meter.variance[idx] = topu(variance, None, pfx, base_inv) \
            if pfx else float(variance)
    if mean is not None:
        val = topu(mean, None, pfx, base_inv) if pfx else float(mean)
        if noise:
            val += math.sqrt(meter.variance[idx]) * _rng.standard_normal()
        meter.mean[idx] = val
    if status is not None:
        meter.status[idx] = check_status(status)


# ---------------------------------------------------------------------------
# Ammeter
# ---------------------------------------------------------------------------

def add_ammeter(monitoring: Measurement, label=None, *, from_branch=None,
                to_branch=None, magnitude=None, variance=None, status=None,
                square=None, noise=None, analysis=None,
                variance_from=None, variance_to=None,
                status_from=None, status_to=None):
    """Reference addAmmeter! — manual (one branch end) or bulk."""
    system = monitoring.system
    amp = monitoring.ammeter
    tpl = template.ammeter
    nz = tpl.noise if noise is None else noise
    sq = tpl.square if square is None else square
    base_p_inv = 1.0 / (system.base.power.value * system.base.power.prefix)

    if analysis is not None:
        st_f = _wide_status(status_from, tpl.status_from)
        st_t = _wide_status(status_to, tpl.status_to)
        cur = analysis.current
        if cur is None:
            raise ValueError("run current postprocessing before bulk adds")
        for k in range(system.branch.number):
            if system.branch.layout.status[k] != 1:
                continue
            f = int(system.branch.layout.from_bus[k])
            t = int(system.branch.layout.to_bus[k])
            if st_f != -1:
                b_inv = base_current_inv(
                    base_p_inv, system.base.voltage.value[f]
                    * system.base.voltage.prefix)
                mean, var, _ = _meter_value(
                    float(cur.from_.magnitude[k]), variance_from, st_f, nz,
                    tpl.variance_from, tpl.status_from,
                    units.pfx_current, b_inv)
                amp.label.add(None)
                amp.layout.index.append(k)
                amp.layout.from_.append(True)
                amp.layout.to.append(False)
                amp.layout.square.append(sq)
                amp.magnitude.mean.append(mean)
                amp.magnitude.variance.append(var)
                amp.magnitude.status.append(st_f)
                amp.number += 1
            if st_t != -1:
                b_inv = base_current_inv(
                    base_p_inv, system.base.voltage.value[t]
                    * system.base.voltage.prefix)
                mean, var, _ = _meter_value(
                    float(cur.to.magnitude[k]), variance_to, st_t, nz,
                    tpl.variance_to, tpl.status_to, units.pfx_current, b_inv)
                amp.label.add(None)
                amp.layout.index.append(k)
                amp.layout.from_.append(False)
                amp.layout.to.append(True)
                amp.layout.square.append(sq)
                amp.magnitude.mean.append(mean)
                amp.magnitude.variance.append(var)
                amp.magnitude.status.append(st_t)
                amp.number += 1
        monitoring.changed()
        return

    if (from_branch is None) == (to_branch is None):
        raise ValueError("exactly one of from_branch/to_branch is required")
    is_from = from_branch is not None
    k = system.branch.label.index(from_branch if is_from else to_branch)
    end_bus = int(system.branch.layout.from_bus[k] if is_from
                  else system.branch.layout.to_bus[k])
    b_inv = base_current_inv(base_p_inv, system.base.voltage.value[end_bus]
                             * system.base.voltage.prefix)
    def_var = tpl.variance_from if is_from else tpl.variance_to
    def_st = tpl.status_from if is_from else tpl.status_to
    mean, var, st = _meter_value(magnitude, variance, status, nz,
                                 def_var, def_st, units.pfx_current, b_inv)
    amp.label.add(label)
    amp.layout.index.append(k)
    amp.layout.from_.append(is_from)
    amp.layout.to.append(not is_from)
    amp.layout.square.append(sq)
    amp.magnitude.mean.append(mean)
    amp.magnitude.variance.append(var)
    amp.magnitude.status.append(st)
    amp.number += 1
    monitoring.changed()
    return amp.number - 1


def update_ammeter(monitoring: Measurement, label, *, magnitude=None,
                   variance=None, status=None, square=None, noise=None):
    amp = monitoring.ammeter
    idx = amp.label.index(label)
    system = monitoring.system
    k = int(amp.layout.index[idx])
    end_bus = int(system.branch.layout.from_bus[k] if amp.layout.from_[idx]
                  else system.branch.layout.to_bus[k])
    base_p_inv = 1.0 / (system.base.power.value * system.base.power.prefix)
    b_inv = base_current_inv(base_p_inv, system.base.voltage.value[end_bus]
                             * system.base.voltage.prefix)
    structural = square is not None
    if square is not None:
        amp.layout.square[idx] = square
    _update_meter(amp.magnitude, idx, magnitude, variance, status, noise,
                  units.pfx_current, b_inv)
    # a square flip changes the row TYPE (reference ammeter.jl update!):
    # that is a snapshot rebuild; mean/variance/status patch in place
    monitoring.changed() if structural else monitoring.changed_values()
    return idx


# ---------------------------------------------------------------------------
# Wattmeter / Varmeter (shared powermeter machinery)
# ---------------------------------------------------------------------------

def _add_powermeter(monitoring, store, kind, label, bus, from_branch,
                    to_branch, value, variance, status, noise):
    system = monitoring.system
    tpl = getattr(template, kind)
    nz = tpl.noise if noise is None else noise
    locs = [x is not None for x in (bus, from_branch, to_branch)]
    if sum(locs) != 1:
        raise ValueError(
            "exactly one of bus/from_branch/to_branch is required")
    base_p_inv = 1.0 / (system.base.power.value * system.base.power.prefix)
    pfx = units.pfx_active if kind == "wattmeter" else units.pfx_reactive

    if bus is not None:
        idx_el = system.bus.label.index(bus)
        where = (True, False, False)
        def_var, def_st = tpl.variance_bus, tpl.status_bus
    elif from_branch is not None:
        idx_el = system.branch.label.index(from_branch)
        where = (False, True, False)
        def_var, def_st = tpl.variance_from, tpl.status_from
    else:
        idx_el = system.branch.label.index(to_branch)
        where = (False, False, True)
        def_var, def_st = tpl.variance_to, tpl.status_to

    mean, var, st = _meter_value(value, variance, status, nz, def_var,
                                 def_st, pfx, base_p_inv)
    meter = store.active if kind == "wattmeter" else store.reactive
    store.label.add(label)
    store.layout.index.append(idx_el)
    store.layout.bus.append(where[0])
    store.layout.from_.append(where[1])
    store.layout.to.append(where[2])
    meter.mean.append(mean)
    meter.variance.append(var)
    meter.status.append(st)
    store.number += 1
    monitoring.changed()
    return store.number - 1


def _add_powermeter_bulk(monitoring, store, kind, bus_values, from_values,
                         to_values, variance_bus, variance_from, variance_to,
                         status_bus, status_from, status_to, noise):
    system = monitoring.system
    tpl = getattr(template, kind)
    nz = tpl.noise if noise is None else noise
    st_b = _wide_status(status_bus, tpl.status_bus)
    st_f = _wide_status(status_from, tpl.status_from)
    st_t = _wide_status(status_to, tpl.status_to)
    base_p_inv = 1.0 / (system.base.power.value * system.base.power.prefix)
    pfx = units.pfx_active if kind == "wattmeter" else units.pfx_reactive
    meter = store.active if kind == "wattmeter" else store.reactive

    def push(idx_el, where, val, variance, def_var, def_st, st):
        mean, var, _ = _meter_value(val, variance, st, nz, def_var, def_st,
                                    pfx, base_p_inv)
        store.label.add(None)
        store.layout.index.append(idx_el)
        store.layout.bus.append(where == 0)
        store.layout.from_.append(where == 1)
        store.layout.to.append(where == 2)
        meter.mean.append(mean)
        meter.variance.append(var)
        meter.status.append(st)
        store.number += 1

    if st_b != -1:
        for i in range(system.bus.number):
            push(i, 0, float(bus_values[i]), variance_bus,
                 tpl.variance_bus, tpl.status_bus, st_b)
    if st_f != -1 or st_t != -1:
        for k in range(system.branch.number):
            if system.branch.layout.status[k] != 1:
                continue
            if st_f != -1:
                push(k, 1, float(from_values[k]), variance_from,
                     tpl.variance_from, tpl.status_from, st_f)
            if st_t != -1:
                push(k, 2, float(to_values[k]), variance_to,
                     tpl.variance_to, tpl.status_to, st_t)
    monitoring.changed()


def add_wattmeter(monitoring: Measurement, label=None, *, bus=None,
                  from_branch=None, to_branch=None, active=None,
                  variance=None, status=None, noise=None, analysis=None,
                  variance_bus=None, variance_from=None, variance_to=None,
                  status_bus=None, status_from=None, status_to=None):
    """Reference addWattmeter! (powermeter.jl:66-196 manual, :321-393 bulk)."""
    if analysis is not None:
        p = analysis.power
        if p is None:
            raise ValueError("run power postprocessing before bulk adds")
        _add_powermeter_bulk(
            monitoring, monitoring.wattmeter, "wattmeter",
            p.injection.active, p.from_.active, p.to.active,
            variance_bus, variance_from, variance_to,
            status_bus, status_from, status_to, noise)
        return
    return _add_powermeter(monitoring, monitoring.wattmeter, "wattmeter",
                           label, bus, from_branch, to_branch, active,
                           variance, status, noise)


def add_varmeter(monitoring: Measurement, label=None, *, bus=None,
                 from_branch=None, to_branch=None, reactive=None,
                 variance=None, status=None, noise=None, analysis=None,
                 variance_bus=None, variance_from=None, variance_to=None,
                 status_bus=None, status_from=None, status_to=None):
    """Reference addVarmeter! (powermeter.jl:198-320 manual, :395-466 bulk)."""
    if analysis is not None:
        p = analysis.power
        if p is None:
            raise ValueError("run power postprocessing before bulk adds")
        _add_powermeter_bulk(
            monitoring, monitoring.varmeter, "varmeter",
            p.injection.reactive, p.from_.reactive, p.to.reactive,
            variance_bus, variance_from, variance_to,
            status_bus, status_from, status_to, noise)
        return
    return _add_powermeter(monitoring, monitoring.varmeter, "varmeter",
                           label, bus, from_branch, to_branch, reactive,
                           variance, status, noise)


def update_wattmeter(monitoring: Measurement, label, *, active=None,
                     variance=None, status=None, noise=None):
    store = monitoring.wattmeter
    idx = store.label.index(label)
    base_p_inv = 1.0 / (monitoring.system.base.power.value
                        * monitoring.system.base.power.prefix)
    _update_meter(store.active, idx, active, variance, status, noise,
                  units.pfx_active, base_p_inv)
    monitoring.changed_values()
    return idx


def update_varmeter(monitoring: Measurement, label, *, reactive=None,
                    variance=None, status=None, noise=None):
    store = monitoring.varmeter
    idx = store.label.index(label)
    base_p_inv = 1.0 / (monitoring.system.base.power.value
                        * monitoring.system.base.power.prefix)
    _update_meter(store.reactive, idx, reactive, variance, status, noise,
                  units.pfx_reactive, base_p_inv)
    monitoring.changed_values()
    return idx


# ---------------------------------------------------------------------------
# PMU
# ---------------------------------------------------------------------------

def add_pmu(monitoring: Measurement, label=None, *, bus=None,
            from_branch=None, to_branch=None, magnitude=None, angle=None,
            variance_magnitude=None, variance_angle=None, status=None,
            correlated=None, polar=None, square=None, noise=None,
            analysis=None, status_bus=None, status_from=None, status_to=None,
            variance_magnitude_bus=None, variance_angle_bus=None,
            variance_magnitude_from=None, variance_angle_from=None,
            variance_magnitude_to=None, variance_angle_to=None):
    """Reference addPmu! (pmu.jl:83-251 manual, :253-420 bulk)."""
    system = monitoring.system
    pmu = monitoring.pmu
    tpl = template.pmu
    nz = tpl.noise if noise is None else noise
    corr = tpl.correlated if correlated is None else correlated
    pol = tpl.polar if polar is None else polar
    sq = tpl.square if square is None else square
    base_p_inv = 1.0 / (system.base.power.value * system.base.power.prefix)

    def push(idx_el, where, mag, ang, var_m, var_a, def_vm, def_va,
             def_st, st, b_inv, pfx_mag, lbl=None):
        mean_m, vm, st_ = _meter_value(mag, var_m, st, nz, def_vm, def_st,
                                       pfx_mag, b_inv)
        mean_a, va_, _ = _meter_value(ang, var_a, st, nz, def_va, def_st,
                                      units.pfx_angle, 1.0)
        pmu.label.add(lbl)
        pmu.layout.index.append(idx_el)
        pmu.layout.bus.append(where == 0)
        pmu.layout.from_.append(where == 1)
        pmu.layout.to.append(where == 2)
        pmu.layout.correlated.append(corr)
        pmu.layout.polar.append(pol)
        pmu.layout.square.append(sq)
        pmu.magnitude.mean.append(mean_m)
        pmu.magnitude.variance.append(vm)
        pmu.magnitude.status.append(st_)
        pmu.angle.mean.append(mean_a)
        pmu.angle.variance.append(va_)
        pmu.angle.status.append(st_)
        pmu.number += 1

    if analysis is not None:
        st_b = _wide_status(status_bus, tpl.status_bus)
        st_f = _wide_status(status_from, tpl.status_from)
        st_t = _wide_status(status_to, tpl.status_to)
        if st_b != -1:
            for i in range(system.bus.number):
                b_inv = math.sqrt(3) / (system.base.voltage.value[i]
                                        * system.base.voltage.prefix)
                push(i, 0, float(analysis.voltage.magnitude[i]),
                     float(analysis.voltage.angle[i]),
                     variance_magnitude_bus, variance_angle_bus,
                     tpl.variance_magnitude_bus, tpl.variance_angle_bus,
                     tpl.status_bus, st_b, b_inv, units.pfx_voltage)
        if st_f != -1 or st_t != -1:
            cur = analysis.current
            if cur is None:
                raise ValueError(
                    "run current postprocessing before bulk adds")
            for k in range(system.branch.number):
                if system.branch.layout.status[k] != 1:
                    continue
                f = int(system.branch.layout.from_bus[k])
                t = int(system.branch.layout.to_bus[k])
                if st_f != -1:
                    b_inv = base_current_inv(
                        base_p_inv, system.base.voltage.value[f]
                        * system.base.voltage.prefix)
                    push(k, 1, float(cur.from_.magnitude[k]),
                         float(cur.from_.angle[k]),
                         variance_magnitude_from, variance_angle_from,
                         tpl.variance_magnitude_from, tpl.variance_angle_from,
                         tpl.status_from, st_f, b_inv, units.pfx_current)
                if st_t != -1:
                    b_inv = base_current_inv(
                        base_p_inv, system.base.voltage.value[t]
                        * system.base.voltage.prefix)
                    push(k, 2, float(cur.to.magnitude[k]),
                         float(cur.to.angle[k]),
                         variance_magnitude_to, variance_angle_to,
                         tpl.variance_magnitude_to, tpl.variance_angle_to,
                         tpl.status_to, st_t, b_inv, units.pfx_current)
        monitoring.changed()
        return

    locs = [x is not None for x in (bus, from_branch, to_branch)]
    if sum(locs) != 1:
        raise ValueError(
            "exactly one of bus/from_branch/to_branch is required")
    if bus is not None:
        i = system.bus.label.index(bus)
        b_inv = math.sqrt(3) / (system.base.voltage.value[i]
                                * system.base.voltage.prefix)
        push(i, 0, magnitude, angle, variance_magnitude, variance_angle,
             tpl.variance_magnitude_bus, tpl.variance_angle_bus,
             tpl.status_bus, status, b_inv, units.pfx_voltage, lbl=label)
    else:
        is_from = from_branch is not None
        k = system.branch.label.index(from_branch if is_from else to_branch)
        end_bus = int(system.branch.layout.from_bus[k] if is_from
                      else system.branch.layout.to_bus[k])
        b_inv = base_current_inv(base_p_inv,
                                 system.base.voltage.value[end_bus]
                                 * system.base.voltage.prefix)
        if is_from:
            push(k, 1, magnitude, angle, variance_magnitude, variance_angle,
                 tpl.variance_magnitude_from, tpl.variance_angle_from,
                 tpl.status_from, status, b_inv, units.pfx_current, lbl=label)
        else:
            push(k, 2, magnitude, angle, variance_magnitude, variance_angle,
                 tpl.variance_magnitude_to, tpl.variance_angle_to,
                 tpl.status_to, status, b_inv, units.pfx_current, lbl=label)
    monitoring.changed()
    return pmu.number - 1


def update_pmu(monitoring: Measurement, label, *, magnitude=None, angle=None,
               variance_magnitude=None, variance_angle=None, status=None,
               correlated=None, polar=None, square=None, noise=None):
    system = monitoring.system
    pmu = monitoring.pmu
    idx = pmu.label.index(label)
    base_p_inv = 1.0 / (system.base.power.value * system.base.power.prefix)
    if pmu.layout.bus[idx]:
        i = int(pmu.layout.index[idx])
        b_inv = math.sqrt(3) / (system.base.voltage.value[i]
                                * system.base.voltage.prefix)
        pfx_mag = units.pfx_voltage
    else:
        k = int(pmu.layout.index[idx])
        end_bus = int(system.branch.layout.from_bus[k]
                      if pmu.layout.from_[idx]
                      else system.branch.layout.to_bus[k])
        b_inv = base_current_inv(base_p_inv,
                                 system.base.voltage.value[end_bus]
                                 * system.base.voltage.prefix)
        pfx_mag = units.pfx_current
    structural = (correlated is not None or polar is not None
                  or square is not None)
    if correlated is not None:
        pmu.layout.correlated[idx] = correlated
    if polar is not None:
        pmu.layout.polar[idx] = polar
    if square is not None:
        pmu.layout.square[idx] = square
    _update_meter(pmu.magnitude, idx, magnitude, variance_magnitude, status,
                  noise, pfx_mag, b_inv)
    _update_meter(pmu.angle, idx, angle, variance_angle, status, noise,
                  units.pfx_angle, 1.0)
    # polar/correlated/square flips change row kinds/pair structure
    # (reference pmu.jl:566-915 update! dispatch); everything else is an
    # in-place row-value patch
    monitoring.changed() if structural else monitoring.changed_values()
    return idx
