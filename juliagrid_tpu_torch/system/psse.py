"""PSSE ``.raw`` (v33+) case parser.

Behavioral equivalent of the reference PSSE reader
(JuliaGrid src/powerSystem/load.jl:661-1357): header base power;
bus data with name-or-number labels and normal voltage limits; loads
(constant power + current·V + impedance·V² composition, in-service only);
fixed and switched shunts; branches with end shunt admittances folded into
bus shunts; two-winding transformers with CW/CZ/CM code conversions,
magnetizing admittance, and winding-ratio normalization; three-winding
transformers expanded to a star bus with three equivalent branches;
generators with capability and setpoint data.
"""

from __future__ import annotations

import math

import numpy as np

from ..report.log import info
from .types import PowerSystem
from ..utils.errors import MissingDataError


def _sections(path: str):
    """Split the file into the numbered data sections."""
    sections = {i: [] for i in range(1, 8)}
    base_power = None
    current = None
    finding_start = True

    def is_break(line: str) -> bool:
        stripped = line.strip()
        if not stripped:
            return False
        if stripped[0] == "Q":
            return True
        if stripped[0] == "0":
            rest = stripped[1:].strip()
            return rest == "" or rest[0] == "/"
        return False

    with open(path) as fh:
        for raw in fh:
            line = raw.rstrip("\n")
            if not line.strip():
                continue
            if base_power is None:
                base_power = float(line.split(",")[1])
                continue
            if finding_start:
                parts = line.split(",")
                ok = len(parts) >= 9
                if ok:
                    try:
                        int(parts[0])
                        float(parts[2])
                        float(parts[8])
                        current = 1
                        finding_start = False
                    except ValueError:
                        ok = False
                if not ok:
                    continue
            if is_break(line):
                up = line.upper()
                current = 0
                for tag, idx in (("BEGIN LOAD DATA", 2),
                                 ("BEGIN FIXED SHUNT DATA", 3),
                                 ("BEGIN SWITCHED SHUNT DATA", 4),
                                 ("BEGIN BRANCH DATA", 5),
                                 ("BEGIN TRANSFORMER DATA", 6),
                                 ("BEGIN GENERATOR DATA", 7)):
                    if tag in up:
                        current = idx
                        break
                continue
            if current:
                sections[current].append(line)

    if base_power is None or base_power == 0:
        base_power = 100.0
        info("The variable basePower not found. "
             "The algorithm proceeds with value of 1e8 VA.")
    return base_power, sections


def _fields(line: str):
    return [f.strip() for f in line.split(",")]


def parse_psse(system: PowerSystem, path: str) -> None:
    from ..templates import template
    from .builders import add_branch, add_bus

    base_mva, sec = _sections(path)
    base_inv = 1.0 / base_mva
    deg2rad = math.pi / 180.0
    optimal = system.bus.layout.optimal
    system.base.power.value = base_mva  # MVA until the end (reference order)

    bus = system.bus
    if not sec[1]:
        raise MissingDataError("The bus data is missing.")

    master = {}
    for k, line in enumerate(sec[1]):
        d = _fields(line)
        label_int = int(d[0])
        name = d[1].replace("'", "").strip()
        label = name if name else label_int
        bus.label.add(label)
        bus.label.counter = max(bus.label.counter, label_int)
        master[label_int] = k
        bus.number += 1

        bus.voltage.magnitude.append(float(d[7]))
        bus.voltage.angle.append(float(d[8]) * deg2rad)
        system.base.voltage.value.append(float(d[2]) * 1e3)
        bus.layout.type.append(int(d[3]))
        bus.layout.area.append(int(d[4]))
        bus.layout.loss_zone.append(int(d[5]))
        bus.demand.active.append(0.0)
        bus.demand.reactive.append(0.0)
        bus.shunt.conductance.append(0.0)
        bus.shunt.susceptance.append(0.0)
        bus.supply.active.append(0.0)
        bus.supply.reactive.append(0.0)
        if optimal:
            if len(d) >= 11:
                bus.voltage.max_magnitude.append(float(d[9]))
                bus.voltage.min_magnitude.append(float(d[10]))
            else:
                bus.voltage.min_magnitude.append(
                    template.bus.min_magnitude[0])
                bus.voltage.max_magnitude.append(
                    template.bus.max_magnitude[0])
        if int(d[3]) == 3:
            bus.layout.slack = k

    if bus.layout.slack < 0:
        bus.layout.slack = 0
        info("The slack bus is not found. The first bus is set to be "
             "the slack.")

    # loads (reference: constant power + current*V + impedance*V^2)
    for line in sec[2]:
        d = _fields(line)
        if int(d[2]) != 1:
            continue
        idx = master[int(d[0])]
        vm = bus.voltage.magnitude[idx]
        p = float(d[5]) + float(d[7]) * vm + float(d[9]) * vm**2
        q = float(d[6]) + float(d[8]) * vm - float(d[10]) * vm**2
        bus.demand.active[idx] += p * base_inv
        bus.demand.reactive[idx] += q * base_inv

    # fixed shunts
    for line in sec[3]:
        d = _fields(line)
        if int(d[2]) != 1:
            continue
        idx = master[int(d[0])]
        bus.shunt.conductance[idx] += float(d[3]) * base_inv
        bus.shunt.susceptance[idx] += float(d[4]) * base_inv

    # switched shunts (BINIT at column 10)
    for line in sec[4]:
        d = _fields(line)
        if int(d[3]) != 1:
            continue
        idx = master[int(d[0])]
        bus.shunt.susceptance[idx] += float(d[9]) * base_inv

    branch = system.branch
    for line in sec[5]:
        d = _fields(line)
        f = master[int(d[0])]
        t = master[abs(int(d[1]))]
        status = int(d[13])
        branch.label.add(None)
        branch.number += 1
        branch.layout.from_bus.append(f)
        branch.layout.to_bus.append(t)
        branch.layout.status.append(status)
        branch.parameter.resistance.append(float(d[3]))
        branch.parameter.reactance.append(float(d[4]))
        branch.parameter.conductance.append(0.0)
        branch.parameter.susceptance.append(float(d[5]))
        branch.parameter.turns_ratio.append(1.0)
        branch.parameter.shift_angle.append(0.0)
        if optimal:
            long_term = float(d[6]) * base_inv
            branch.flow.min_from_bus.append(-long_term)
            branch.flow.max_from_bus.append(long_term)
            branch.flow.min_to_bus.append(-long_term)
            branch.flow.max_to_bus.append(long_term)
            branch.flow.type.append(3)
            branch.voltage.min_diff_angle.append(
                template.branch.min_diff_angle[0])
            branch.voltage.max_diff_angle.append(
                template.branch.max_diff_angle[0])
        if status == 1:
            branch.layout.inservice += 1
            # end shunt admittances folded into bus shunts (reference
            # load.jl:976-983 keeps them in the file's MW units)
            bus.shunt.conductance[f] += float(d[9])
            bus.shunt.susceptance[f] += float(d[10])
            bus.shunt.conductance[t] += float(d[11])
            bus.shunt.susceptance[t] += float(d[12])

    # transformers: records span 4 (two-winding) or 5 (three-winding) lines
    lines6 = sec[6]
    pos = 0
    base_v = system.base.voltage.value
    while pos < len(lines6):
        d = _fields(lines6[pos])
        three_winding = int(d[2]) != 0
        span = 5 if three_winding else 4
        for extra in range(1, span):
            d += _fields(lines6[pos + extra])
        pos += span

        cw = float(d[4])
        cz = float(d[5])

        if not three_winding:
            i = master[int(d[0])]
            j = master[int(d[1])]
            status = int(d[11])
            if status == 1:
                g_, b_ = _magnetizing(system, d, sbase_idx=23,
                                      base_mva=base_mva)
                bus.shunt.conductance[i] += g_
                bus.shunt.susceptance[i] += b_

            tau1 = float(d[24])
            tau2 = float(d[41])
            r = float(d[21])
            x = float(d[22])
            vb1 = float(d[25])
            vb2 = float(d[42])

            if cz in (2.0, 3.0):
                sb_inv = 1.0 / float(d[23])
                if cz == 3.0:
                    r *= sb_inv * 1e-6
                    x = math.sqrt(x**2 - r**2)
                if abs(vb1) < 1e-12:
                    r *= base_mva * sb_inv
                    x *= base_mva * sb_inv
                else:
                    zn = (vb1**2 * sb_inv) / (
                        (base_v[i]) ** 2 * base_inv * 1e-6)
                    r *= zn
                    x *= zn
            if cw == 1.0:
                r *= tau2**2
                x *= tau2**2
                tau = tau1 / tau2
            elif cw == 2.0:
                scale = (1e3 * tau2 / base_v[j]) ** 2
                r *= scale
                x *= scale
                tau = (tau1 / tau2) * base_v[j] / base_v[i]
            else:
                if abs(vb2) < 1e-12:
                    r *= tau2**2
                    x *= tau2**2
                else:
                    r *= (1e3 * tau2 * vb2 / base_v[j]) ** 2
                    x *= (1e3 * tau2 * vb2 / base_v[j]) ** 2
                tau = tau1 / tau2
                if vb1 != 0.0 and vb2 != 0.0:
                    tau *= (base_v[j] / base_v[i]) * (vb1 / vb2)

            branch.label.add(None)
            branch.number += 1
            branch.layout.from_bus.append(i)
            branch.layout.to_bus.append(j)
            branch.layout.status.append(status)
            if status == 1:
                branch.layout.inservice += 1
            branch.parameter.resistance.append(r)
            branch.parameter.reactance.append(x)
            branch.parameter.conductance.append(0.0)
            branch.parameter.susceptance.append(0.0)
            branch.parameter.turns_ratio.append(tau)
            branch.parameter.shift_angle.append(float(d[26]) * deg2rad)
            if optimal:
                long_term = float(d[27]) * base_inv
                branch.flow.min_from_bus.append(-long_term)
                branch.flow.max_from_bus.append(long_term)
                branch.flow.min_to_bus.append(-long_term)
                branch.flow.max_to_bus.append(long_term)
                branch.flow.type.append(3)
                branch.voltage.min_diff_angle.append(
                    template.branch.min_diff_angle[0])
                branch.voltage.max_diff_angle.append(
                    template.branch.max_diff_angle[0])
        else:
            # three-winding: star bus + three equivalent branches
            i = master[int(d[0])]
            j = master[int(d[1])]
            q = master[int(d[2])]
            status = int(d[11])
            if status not in (0, 4):
                g_, b_ = _magnetizing(system, d, sbase_idx=23,
                                      base_mva=base_mva)
                bus.shunt.conductance[i] += g_
                bus.shunt.susceptance[i] += b_

            star = bus.number
            bus.label.add(None)
            bus.number += 1
            bus.voltage.magnitude.append(float(d[30]))
            bus.voltage.angle.append(float(d[31]) * deg2rad)
            system.base.voltage.value.append(1e3)
            bus.layout.type.append(1)
            bus.layout.area.append(int(bus.layout.area[i]))
            bus.layout.loss_zone.append(int(bus.layout.loss_zone[i]))
            bus.demand.active.append(0.0)
            bus.demand.reactive.append(0.0)
            bus.shunt.conductance.append(0.0)
            bus.shunt.susceptance.append(0.0)
            bus.supply.active.append(0.0)
            bus.supply.reactive.append(0.0)
            if optimal:
                bus.voltage.min_magnitude.append(
                    template.bus.min_magnitude[0])
                bus.voltage.max_magnitude.append(
                    template.bus.max_magnitude[0])

            r12, x12 = float(d[21]), float(d[22])
            r23, x23 = float(d[24]), float(d[25])
            r31, x31 = float(d[27]), float(d[28])
            vb = (float(d[33]), float(d[50]), float(d[67]))
            ends = (i, j, q)

            if cz in (2.0, 3.0):
                sbs = (1.0 / float(d[23]), 1.0 / float(d[26]),
                       1.0 / float(d[29]))
                rs = [r12, r23, r31]
                xs = [x12, x23, x31]
                for w in range(3):
                    if cz == 3.0:
                        rs[w] *= sbs[w] * 1e-6
                        xs[w] = math.sqrt(xs[w] ** 2 - rs[w] ** 2)
                    if abs(vb[w]) < 1e-12:
                        rs[w] *= base_mva * sbs[w]
                        xs[w] *= base_mva * sbs[w]
                    else:
                        zn = (vb[w] ** 2 * sbs[w]) / (
                            base_v[ends[w]] ** 2 * base_inv * 1e-6)
                        rs[w] *= zn
                        xs[w] *= zn
                r12, r23, r31 = rs
                x12, x23, x31 = xs

            taus = [float(d[32]), float(d[49]), float(d[66])]
            if cw == 2.0:
                for w in range(3):
                    taus[w] /= base_v[ends[w]] * 1e-3
            elif cw == 3.0:
                for w in range(3):
                    if vb[w] != 0.0:
                        taus[w] *= vb[w] / (base_v[ends[w]] * 1e-3)

            shifts = (float(d[34]), float(d[51]), float(d[68]))
            rates = (float(d[35]), float(d[52]), float(d[69]))
            statuses = (0 if status in (0, 4) else 1,
                        0 if status in (0, 2) else 1,
                        0 if status in (0, 3) else 1)
            params = (
                ((r12 - r23 + r31) / 2, (x12 - x23 + x31) / 2),
                ((r12 + r23 - r31) / 2, (x12 + x23 - x31) / 2),
                ((-r12 + r23 + r31) / 2, (-x12 + x23 + x31) / 2))

            for w in range(3):
                branch.label.add(None)
                branch.number += 1
                branch.layout.from_bus.append(ends[w])
                branch.layout.to_bus.append(star)
                branch.layout.status.append(statuses[w])
                if statuses[w] == 1:
                    branch.layout.inservice += 1
                branch.parameter.resistance.append(params[w][0])
                branch.parameter.reactance.append(params[w][1])
                branch.parameter.conductance.append(0.0)
                branch.parameter.susceptance.append(0.0)
                branch.parameter.turns_ratio.append(taus[w])
                branch.parameter.shift_angle.append(shifts[w] * deg2rad)
                if optimal:
                    long_term = rates[w] * base_inv
                    branch.flow.min_from_bus.append(-long_term)
                    branch.flow.max_from_bus.append(long_term)
                    branch.flow.min_to_bus.append(-long_term)
                    branch.flow.max_to_bus.append(long_term)
                    branch.flow.type.append(3)
                    branch.voltage.min_diff_angle.append(
                        template.branch.min_diff_angle[0])
                    branch.voltage.max_diff_angle.append(
                        template.branch.max_diff_angle[0])

    # generators
    gen = system.generator
    if not sec[7]:
        raise MissingDataError("The generator data is missing.")
    for k, line in enumerate(sec[7]):
        d = _fields(line)
        gen.label.add(None)
        gen.number += 1
        b = master[int(d[0])]
        gen.layout.bus.append(b)
        gen.output.active.append(float(d[2]) * base_inv)
        gen.output.reactive.append(float(d[3]) * base_inv)
        gen.capability.max_reactive.append(float(d[4]) * base_inv)
        gen.capability.min_reactive.append(float(d[5]) * base_inv)
        gen.voltage.magnitude.append(float(d[6]))
        gen.layout.status.append(int(d[14]))
        if optimal:
            gen.capability.max_active.append(float(d[16]) * base_inv)
            gen.capability.min_active.append(float(d[17]) * base_inv)
            for f in ("low_active", "up_active", "min_low_reactive",
                      "max_low_reactive", "min_up_reactive",
                      "max_up_reactive"):
                getattr(gen.capability, f).append(0.0)
        gen.cost.active.model.append(0)
        gen.cost.reactive.model.append(0)
        if gen.layout.status[k] == 1:
            system.add_gen_in_bus(b, k)
            bus.supply.active[b] += gen.output.active[k]
            bus.supply.reactive[b] += gen.output.reactive[k]
            gen.layout.inservice += 1

    system.base.power.value = base_mva * 1e6


def _magnetizing(system, d, sbase_idx: int, base_mva: float):
    """psseTransformerMagnetizing (load.jl:1253-1280)."""
    cm = int(d[6])
    if cm == 1:
        return float(d[7]), float(d[8])
    if cm == 2:
        transformer_base = float(d[sbase_idx])
        if transformer_base == 0.0:
            transformer_base = base_mva
        core_loss = float(d[7]) * 1e-6
        exciting = float(d[8])
        conductance = core_loss / base_mva
        cond_tr = core_loss / transformer_base
        susceptance = -math.sqrt(max(exciting**2 - cond_tr**2, 0.0)) \
            * transformer_base / base_mva
        return conductance, susceptance
    return 0.0, 0.0
