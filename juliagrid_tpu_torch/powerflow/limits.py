"""Reactive-limit enforcement and angle adjustment after slack handoff.

Reference JuliaGrid src/powerFlow/acPowerFlow.jl:1081-1202:
``reactiveLimit!`` recomputes generator powers from the solved state,
converts violating PV/slack buses to PQ with reactive output pinned at the
limit (slack duty re-assigned to the first remaining PV bus), and returns
the per-generator violation flags (-1 min, +1 max); ``adjustAngle!`` shifts
all angles so a chosen bus matches its stored angle.
"""

from __future__ import annotations

import numpy as np

from ..postprocessing.ac import power as ac_power
from ..report.log import info
from ..utils.errors import SlackDefinitionError


def reactive_limit(analysis):
    """Reference reactiveLimit! — returns violation flags per generator."""
    system = analysis.system
    bus = system.bus
    gen = system.generator
    g = gen.number

    ac_power(analysis)
    gen_active = analysis.power.generator.active
    gen_reactive = analysis.power.generator.reactive

    violate = np.zeros(g, dtype=np.int64)
    bus.supply.active.fill(0.0)
    bus.supply.reactive.fill(0.0)
    output_reactive = np.zeros(g)
    for k in range(g):
        if gen.layout.status[k] == 1:
            b = int(gen.layout.bus[k])
            gen.output.active[k] = gen_active[k]
            bus.supply.active[b] += gen_active[k]
            bus.supply.reactive[b] += gen_reactive[k]
            output_reactive[k] = gen_reactive[k]

    for i in range(g):
        if gen.layout.status[i] == 0:
            continue
        qmin = gen.capability.min_reactive[i]
        qmax = gen.capability.max_reactive[i]
        if not qmin < qmax:
            continue
        j = int(gen.layout.bus[i])
        violate_min = output_reactive[i] < qmin
        violate_max = output_reactive[i] > qmax
        if bus.layout.type[j] != 1 and (violate_min or violate_max):
            new_q = qmin if violate_min else qmax
            violate[i] = -1 if violate_min else 1
            bus.layout.type[j] = 1
            system.type_changed()
            bus.supply.reactive[j] -= output_reactive[i]
            gen.output.reactive[i] = new_q
            bus.supply.reactive[j] += new_q

            if j == bus.layout.slack:
                for k in range(bus.number):
                    if bus.layout.type[k] == 2:
                        info(f"The slack bus labeled {bus.label.label(j)} "
                             "is converted to generator bus. The bus "
                             f"labeled {bus.label.label(k)} is the new "
                             "slack bus.")
                        bus.layout.slack = k
                        system.slack_changed()
                        bus.layout.type[k] = 3
                        system.type_changed()
                        break

    if bus.layout.type[bus.layout.slack] != 3:
        raise SlackDefinitionError(
            "No generator buses with an in-service generator are "
            "available; a slack bus cannot be designated.")
    return violate


def adjust_angle(analysis, slack):
    """Reference adjustAngle! — re-reference angles to the given bus."""
    system = analysis.system
    idx = system.bus.label.index(slack)
    shift = system.bus.voltage.angle[idx] - analysis.voltage.angle[idx]
    analysis.voltage.angle = analysis.voltage.angle + shift
