"""MATPOWER ``.m`` case parser.

Behavioral equivalent of the reference parser
(JuliaGrid src/powerSystem/load.jl:292-660): same per-unit
conversions (MW/base, deg→rad, baseKV→V), same defaulting rules
(missing baseMVA → 100, turns ratio 0 → 1, missing slack → bus 1, voltage
limit defaults from the bus template), same supply accumulation and cost
scaling (polynomial coefficient k scaled by basePower^(n-k), piecewise
breakpoints divided by basePower).
"""

from __future__ import annotations

import math
import re

import numpy as np

from ..templates import template
from ..utils.vec import Vec
from .types import PowerSystem
from ..utils.errors import MissingDataError


def _extract_blocks(text: str) -> dict[str, list[list[str]]]:
    """Pull the numeric matrix blocks out of a MATPOWER file."""
    blocks: dict[str, list[list[str]]] = {}
    # strip comments
    lines = []
    for raw in text.splitlines():
        i = raw.find("%")
        lines.append(raw if i < 0 else raw[:i])
    text = "\n".join(lines)

    for name in ("bus", "branch", "gen", "gencost", "dcline"):
        mobj = re.search(
            rf"mpc\.{name}\s*=\s*\[(.*?)\]", text, re.DOTALL)
        if mobj is None:
            continue
        rows = []
        for row in mobj.group(1).replace(";", "\n").splitlines():
            row = row.strip()
            if row:
                rows.append(row.split())
        blocks[name] = rows

    mobj = re.search(r"mpc\.bus_name\s*=\s*\{(.*?)\}", text, re.DOTALL)
    if mobj is not None:
        names = []
        for row in mobj.group(1).replace(";", "\n").splitlines():
            row = row.strip().strip("'\"")
            if row:
                names.append(row)
        blocks["bus_name"] = [[n] for n in names]

    mobj = re.search(r"mpc\.baseMVA\s*=\s*([0-9.eE+-]+)", text)
    blocks["baseMVA"] = [[mobj.group(1)]] if mobj else []
    return blocks


def parse_matpower(system: PowerSystem, path: str) -> None:
    with open(path) as fh:
        blocks = _extract_blocks(fh.read())

    base_mva = float(blocks["baseMVA"][0][0]) if blocks.get("baseMVA") else 0.0
    if base_mva == 0.0:
        base_mva = 100.0
    base_inv = 1.0 / base_mva
    deg2rad = math.pi / 180.0
    optimal = system.bus.layout.optimal

    bus_rows = blocks.get("bus")
    if not bus_rows:
        raise MissingDataError("The bus data is missing.")

    bus = system.bus
    n = len(bus_rows)
    bus.number = n
    names = blocks.get("bus_name")

    data = np.array([r[: (13 if optimal and len(bus_rows[0]) >= 13 else 11)]
                     for r in bus_rows], dtype=np.float64)
    has_vlim = optimal and data.shape[1] >= 13

    raw_id = data[:, 0].astype(np.int64)
    for k in range(n):
        label = names[k][0] if names else int(raw_id[k])
        bus.label.add(label)
    bus.label.counter = int(raw_id.max())
    id_to_idx = {int(b): k for k, b in enumerate(raw_id)}

    bus.layout.type = Vec("int8", data[:, 1].astype(np.int8))
    bus.demand.active = Vec("float64", data[:, 2] * base_inv)
    bus.demand.reactive = Vec("float64", data[:, 3] * base_inv)
    bus.shunt.conductance = Vec("float64", data[:, 4] * base_inv)
    bus.shunt.susceptance = Vec("float64", data[:, 5] * base_inv)
    bus.layout.area = Vec("int64", data[:, 6].astype(np.int64))
    bus.voltage.magnitude = Vec("float64", data[:, 7])
    bus.voltage.angle = Vec("float64", data[:, 8] * deg2rad)
    system.base.voltage.value = Vec("float64", data[:, 9] * 1e3)
    bus.layout.loss_zone = Vec("int64", data[:, 10].astype(np.int64))
    bus.supply.active = Vec("float64", np.zeros(n))
    bus.supply.reactive = Vec("float64", np.zeros(n))

    if optimal:
        if has_vlim:
            bus.voltage.max_magnitude = Vec("float64", data[:, 11])
            bus.voltage.min_magnitude = Vec("float64", data[:, 12])
        else:
            lo, lo_pu = template.bus.min_magnitude
            hi, hi_pu = template.bus.max_magnitude
            bus.voltage.min_magnitude = Vec("float64", np.full(n, lo))
            bus.voltage.max_magnitude = Vec("float64", np.full(n, hi))

    slack = np.flatnonzero(data[:, 1] == 3)
    bus.layout.slack = int(slack[-1]) if len(slack) else 0

    # ---- branches --------------------------------------------------------
    br_rows = blocks.get("branch")
    if not br_rows:
        raise MissingDataError("The branch data is missing.")
    branch = system.branch
    m = len(br_rows)
    branch.number = m
    bdata = np.array([r[:13] for r in br_rows], dtype=np.float64)

    for k in range(m):
        branch.label.add(k + 1)

    branch.layout.from_bus = Vec("int64", [id_to_idx[int(b)] for b in bdata[:, 0]])
    branch.layout.to_bus = Vec("int64", [id_to_idx[int(b)] for b in bdata[:, 1]])
    branch.parameter.resistance = Vec("float64", bdata[:, 2])
    branch.parameter.reactance = Vec("float64", bdata[:, 3])
    branch.parameter.conductance = Vec("float64", np.zeros(m))
    branch.parameter.susceptance = Vec("float64", bdata[:, 4])
    ratio = bdata[:, 8]
    branch.parameter.turns_ratio = Vec("float64", np.where(ratio == 0.0, 1.0, ratio))
    branch.parameter.shift_angle = Vec("float64", bdata[:, 9] * deg2rad)
    branch.layout.status = Vec("int8", bdata[:, 10].astype(np.int8))
    branch.layout.inservice = int((bdata[:, 10] == 1).sum())

    if optimal:
        long_term = bdata[:, 5] * base_inv
        branch.flow.min_from_bus = Vec("float64", -long_term)
        branch.flow.max_from_bus = Vec("float64", long_term)
        branch.flow.min_to_bus = Vec("float64", -long_term)
        branch.flow.max_to_bus = Vec("float64", long_term)
        branch.flow.type = Vec("int8", np.full(m, 3, dtype=np.int8))
        branch.voltage.min_diff_angle = Vec("float64", bdata[:, 11] * deg2rad)
        branch.voltage.max_diff_angle = Vec("float64", bdata[:, 12] * deg2rad)

    # ---- generators ------------------------------------------------------
    gen_rows = blocks.get("gen")
    if not gen_rows:
        raise MissingDataError("The generator data is missing.")
    gen = system.generator
    g = len(gen_rows)
    gen.number = g
    width = 16 if optimal and len(gen_rows[0]) >= 16 else 8
    gdata = np.array([r[:width] for r in gen_rows], dtype=np.float64)

    for k in range(g):
        gen.label.add(k + 1)

    gen.layout.bus = Vec("int64", [id_to_idx[int(b)] for b in gdata[:, 0]])
    gen.output.active = Vec("float64", gdata[:, 1] * base_inv)
    gen.output.reactive = Vec("float64", gdata[:, 2] * base_inv)
    gen.capability.max_reactive = Vec("float64", gdata[:, 3] * base_inv)
    gen.capability.min_reactive = Vec("float64", gdata[:, 4] * base_inv)
    gen.voltage.magnitude = Vec("float64", gdata[:, 5])
    gen.layout.status = Vec("int8", gdata[:, 7].astype(np.int8))

    if optimal:
        if width == 16:
            gen.capability.max_active = Vec("float64", gdata[:, 8] * base_inv)
            gen.capability.min_active = Vec("float64", gdata[:, 9] * base_inv)
            gen.capability.low_active = Vec("float64", gdata[:, 10] * base_inv)
            gen.capability.up_active = Vec("float64", gdata[:, 11] * base_inv)
            gen.capability.min_low_reactive = Vec("float64", gdata[:, 12] * base_inv)
            gen.capability.max_low_reactive = Vec("float64", gdata[:, 13] * base_inv)
            gen.capability.min_up_reactive = Vec("float64", gdata[:, 14] * base_inv)
            gen.capability.max_up_reactive = Vec("float64", gdata[:, 15] * base_inv)
        else:
            z = np.zeros(g)
            for f in ("max_active", "min_active", "low_active", "up_active",
                      "min_low_reactive", "max_low_reactive",
                      "min_up_reactive", "max_up_reactive"):
                setattr(gen.capability, f, Vec("float64", z))

    for k in range(g):
        if gen.layout.status[k] == 1:
            i = int(gen.layout.bus[k])
            system.add_gen_in_bus(i, k)
            bus.supply.active[i] += gen.output.active[k]
            bus.supply.reactive[i] += gen.output.reactive[k]
            gen.layout.inservice += 1

    # ---- generator costs -------------------------------------------------
    if optimal:
        gen.cost.active.model = Vec("int8", np.zeros(g, dtype=np.int8))
        gen.cost.reactive.model = Vec("int8", np.zeros(g, dtype=np.int8))
        cost_rows = blocks.get("gencost", [])
        if cost_rows:
            _parse_cost(gen.cost.active, cost_rows[:g], base_mva)
            if len(cost_rows) == 2 * g:
                _parse_cost(gen.cost.reactive, cost_rows[g:], base_mva)

    system.base.power.value = base_mva * 1e6

    if len(slack) == 0:
        from ..report.log import info
        info("The slack bus is not found. The first bus is set to be the slack.")


def _parse_cost(cost, rows: list[list[str]], base_mva: float) -> None:
    """MATPOWER gencost rows (reference costParser, load.jl:622-658)."""
    base_inv = 1.0 / base_mva
    for i, row in enumerate(rows):
        model = int(float(row[0]))
        npts = int(float(row[3]))
        cost.model[i] = model
        vals = [float(v) for v in row[4:]]
        if model == 1:
            pts = np.empty((npts, 2))
            pts[:, 0] = [vals[2 * k] * base_inv for k in range(npts)]
            pts[:, 1] = [vals[2 * k + 1] for k in range(npts)]
            cost.piecewise[i] = pts
        elif model == 2:
            # stored so evaluation at per-unit power gives original currency
            cost.polynomial[i] = np.array(
                [vals[k] * base_mva ** (npts - 1 - k) for k in range(npts)])
