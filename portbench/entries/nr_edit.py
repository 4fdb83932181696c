"""The live-edit power flow: a load snapshot applied through the public
edits, then one Newton-Raphson ``power_flow`` of the whole grid, a call.

An energy management system keeps one analysis of its network and
re-solves it after each snapshot of the loads. A call sets every bus that
has demand through ``update_bus`` to its base demand times the call's
factor (so edits never compound across calls), restores the set-point
start (``set_initial_point``) and runs ``power_flow``; the analysis brings
its device arrays up to the system's revision itself. A mix's keys
(``traffic/<mix>.json``, besides ``entry``, ``scenarios`` (1), ``tol``,
``max_iter`` and ``check_calls``):

- ``load_sigma``: each bus's demand, P and Q, is its base demand times one
  factor 1 + load_sigma * N(0, 1);
- ``start``: ``"setpoints"`` (the case's voltages, generator set points at
  PV and slack buses: ``set_initial_point``'s start).

The reference solves p = p_sched - (f - 1) P_demand, q = q_sched - (f - 1)
Q_demand from the same start, the demand read from the case file by
``reference/demand.py``.
"""

from __future__ import annotations

from pathlib import Path

import juliagrid_tpu_torch as jgt
import numpy as np
import torch

from portbench.entries.nr import shape as fleet_shape
from portbench.generator import start_state
from portbench.reference import grid as ref
from portbench.reference.demand import load_demand

ROOT = Path(__file__).resolve().parents[2]


def prepare(case, config, device) -> dict:
    """The base demand the mix scales, read by the reference from the case
    file."""
    pd, qd = load_demand(str(ROOT / config["case"]))
    return dict(pd=pd, qd=qd)


def base(params, case, prep, device) -> dict:
    if int(params["scenarios"]) != 1:
        raise ValueError("the live-edit power flow solves one scenario a "
                         "call")
    vm0, va0 = start_state(params, case, device)

    def row(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)[None]

    return dict(vm0=vm0, va0=va0, p=row(case.p_sched), q=row(case.q_sched),
                pd=row(prep["pd"]), qd=row(prep["qd"]))


def draw(params, base, gen) -> dict:
    """One call's inputs from the generator ``gen``: a factor a bus, and the
    injections the reference solves."""
    z = torch.randn(base["vm0"].shape, generator=gen, dtype=torch.float64,
                    device=base["vm0"].device)
    factor = 1.0 + params["load_sigma"] * z
    grown = factor - 1.0
    return dict(vm0=base["vm0"], va0=base["va0"], factor=factor,
                p=base["p"] - grown * base["pd"],
                q=base["q"] - grown * base["qd"])


class Program:
    """One analysis of the case, edited and re-solved each call."""

    def __init__(self, system, analysis, tol, max_iter):
        self.system, self.analysis = system, analysis
        self.tol, self.max_iter = tol, max_iter
        n = system.bus.number
        pd = np.asarray(system.bus.demand.active.array[:n], dtype=float)
        qd = np.asarray(system.bus.demand.reactive.array[:n], dtype=float)
        self.buses = np.flatnonzero((pd != 0.0) | (qd != 0.0))
        self.labels = [system.bus.label.label(int(i)) for i in self.buses]
        self.pd, self.qd = pd[self.buses], qd[self.buses]

    def solve(self, inputs):
        """``(vm, va, iterations, converged)`` of one call, each ``[1, ...]``
        on the host."""
        factor = inputs["factor"][0].cpu().numpy()[self.buses]
        for label, pd, qd, f in zip(self.labels, self.pd, self.qd, factor):
            jgt.update_bus(self.system, label, active=pd * f,
                           reactive=qd * f)
        pf = self.analysis
        jgt.set_initial_point(pf)
        jgt.power_flow(pf, iteration=self.max_iter, tolerance=self.tol)
        return (torch.tensor(pf.voltage.magnitude)[None],
                torch.tensor(pf.voltage.angle)[None],
                torch.tensor([pf.method.iteration], dtype=torch.int32),
                torch.tensor([pf.method.converged]))


def build(case_path, params, device, prep) -> Program:
    """The port's system and Newton-Raphson analysis of the case at
    ``case_path``."""
    system = jgt.power_system(str(case_path))
    analysis = jgt.newton_raphson(system, device=device)
    return Program(system, analysis, params["tol"], params["max_iter"])


def chunk(case, prep) -> int:
    """One scenario a call: the reference holds it alone."""
    return 1


def shape(case, prep) -> dict:
    """The power flow's sizes, counted as the fleet's (``entries/nr.py``)."""
    return fleet_shape(case, prep)


def reference_solve(grid, prep, params, inputs, chunk):
    return ref.nr_solve(grid, inputs["vm0"], inputs["va0"], inputs["p"],
                        inputs["q"], tol=params["tol"],
                        max_iter=params["max_iter"], chunk=chunk)
