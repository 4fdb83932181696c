"""A grid read from its case file, with no code of the program under test.

Reads a MATPOWER ``.m`` case or a JuliaGrid case snapshot (``.npz``: the
HDF5 layout of JuliaGrid's ``savePowerSystem``, one array per dataset, a
scalar dataset standing for a constant vector, 1-based indices, values in
per unit) and gives the per-unit network under JuliaGrid's rules:

- MATPOWER's MW and MVAr are divided by ``baseMVA``, degrees become
  radians, a turns ratio of 0 is 1;
- a PV bus without an in-service generator is a PQ bus;
- at a PV or slack bus the start magnitude is the set point of the first
  in-service generator there (generator order);
- a bus's scheduled injection is the sum of its in-service generators'
  outputs, in generator order, less its demand;
- the branch is JuliaGrid's pi model: series admittance y = 1/(r + jx),
  shunt (g + jb)/2 at both ends, the transformer (ratio tau, shift phi) at
  the from end: Yff = (y + (g+jb)/2)/tau², Yft = -y/(tau e^{-j phi}),
  Ytf = -y/(tau e^{j phi}), Ytt = y + (g+jb)/2.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np


@dataclass
class Case:
    n: int
    bus_type: np.ndarray     # 1 PQ, 2 PV, 3 slack (after the PV repair)
    slack: int
    vm_case: np.ndarray      # the bus data's stored voltages
    va_case: np.ndarray
    vm_start: np.ndarray     # NR start: generator set points at PV/slack
    p_sched: np.ndarray      # supply - demand, per unit
    q_sched: np.ndarray
    shunt: np.ndarray        # complex bus shunt admittance
    f: np.ndarray            # in-service branches only
    t: np.ndarray
    yff: np.ndarray
    yft: np.ndarray
    ytf: np.ndarray
    ytt: np.ndarray

    def ybus(self) -> np.ndarray:
        """The dense complex bus admittance matrix."""
        y = np.zeros((self.n, self.n), dtype=np.complex128)
        y[np.arange(self.n), np.arange(self.n)] += self.shunt
        np.add.at(y, (self.f, self.f), self.yff)
        np.add.at(y, (self.f, self.t), self.yft)
        np.add.at(y, (self.t, self.f), self.ytf)
        np.add.at(y, (self.t, self.t), self.ytt)
        return y

    def pattern(self):
        """The bus admittance matrix's structural nonzeros, as sorted row
        and column indices: the diagonal and both orientations of every
        connected bus pair."""
        pairs = {(int(a), int(b)) for a, b in zip(self.f, self.t) if a != b}
        pairs |= {(b, a) for a, b in pairs}
        pairs |= {(i, i) for i in range(self.n)}
        rows, cols = np.asarray(sorted(pairs), dtype=np.int64).T
        return rows, cols

    def pattern_nnz(self) -> int:
        return len(self.pattern()[0])


def _matpower_blocks(text: str) -> dict:
    base = re.search(r"mpc\.baseMVA\s*=\s*([0-9.eE+-]+)", text)
    out = {"baseMVA": float(base.group(1)) if base else 100.0}
    for name in ("bus", "gen", "branch"):
        found = re.search(r"mpc\.%s\s*=\s*\[(.*?)\];" % name, text, re.S)
        rows = []
        for line in found.group(1).splitlines():
            line = line.split("%")[0].replace(";", " ").strip()
            if line:
                rows.append([float(v) for v in line.split()])
        out[name] = np.array(rows)
    return out


def _raw_matpower(path: str) -> dict:
    with open(path) as fh:
        blk = _matpower_blocks(fh.read())
    base = blk["baseMVA"] or 100.0
    bus, gen, br = blk["bus"], blk["gen"], blk["branch"]
    index = {int(b): k for k, b in enumerate(bus[:, 0])}
    ratio = br[:, 8]
    return dict(
        bus_type=bus[:, 1].astype(int), pd=bus[:, 2] / base,
        qd=bus[:, 3] / base, gs=bus[:, 4] / base, bs=bus[:, 5] / base,
        vm=bus[:, 7].copy(), va=np.deg2rad(bus[:, 8]),
        gen_bus=np.array([index[int(b)] for b in gen[:, 0]]),
        pg=gen[:, 1] / base, qg=gen[:, 2] / base, vg=gen[:, 5].copy(),
        gen_status=gen[:, 7].astype(int),
        f=np.array([index[int(b)] for b in br[:, 0]]),
        t=np.array([index[int(b)] for b in br[:, 1]]),
        r=br[:, 2], x=br[:, 3], g=np.zeros(len(br)), b=br[:, 4],
        tau=np.where(ratio == 0.0, 1.0, ratio), phi=np.deg2rad(br[:, 9]),
        br_status=br[:, 10].astype(int))


def _raw_snapshot(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        n = int(z["@number of buses"])
        m = int(z["@number of branches"])
        g = int(z["@number of generators"])

        def get(key, size, dtype=np.float64):
            val = z[key]
            if val.ndim == 0:
                return np.full(size, val, dtype=dtype)
            return np.asarray(val, dtype=dtype)

        return dict(
            bus_type=get("bus/layout/type", n, int),
            pd=get("bus/demand/active", n), qd=get("bus/demand/reactive", n),
            gs=get("bus/shunt/conductance", n),
            bs=get("bus/shunt/susceptance", n),
            vm=get("bus/voltage/magnitude", n),
            va=get("bus/voltage/angle", n),
            gen_bus=get("generator/layout/bus", g, int) - 1,
            pg=get("generator/output/active", g),
            qg=get("generator/output/reactive", g),
            vg=get("generator/voltage/magnitude", g),
            gen_status=get("generator/layout/status", g, int),
            f=get("branch/layout/from", m, int) - 1,
            t=get("branch/layout/to", m, int) - 1,
            r=get("branch/parameter/resistance", m),
            x=get("branch/parameter/reactance", m),
            g=get("branch/parameter/conductance", m),
            b=get("branch/parameter/susceptance", m),
            tau=get("branch/parameter/turnsRatio", m),
            phi=get("branch/parameter/shiftAngle", m),
            br_status=get("branch/layout/status", m, int))


def load_case(path: str) -> Case:
    """The grid of the case file at ``path`` (``.m`` or ``.npz``)."""
    raw = _raw_matpower(path) if path.endswith(".m") else _raw_snapshot(path)
    n = len(raw["bus_type"])
    bus_type = raw["bus_type"].copy()
    slack = np.flatnonzero(bus_type == 3)
    if len(slack) != 1:
        raise ValueError(f"{path}: {len(slack)} slack buses, not one")
    supply_p, supply_q = np.zeros(n), np.zeros(n)
    first_gen = {}
    for k in range(len(raw["gen_bus"])):
        if raw["gen_status"][k] != 1:
            continue
        i = int(raw["gen_bus"][k])
        supply_p[i] += raw["pg"][k]
        supply_q[i] += raw["qg"][k]
        first_gen.setdefault(i, k)
    if int(slack[0]) not in first_gen:
        raise ValueError(f"{path}: no in-service generator at the slack")
    vm_start = raw["vm"].copy()
    for i in range(n):
        if i not in first_gen and bus_type[i] == 2:
            bus_type[i] = 1
        if i in first_gen and bus_type[i] != 1:
            vm_start[i] = raw["vg"][first_gen[i]]
    on = raw["br_status"] == 1
    y = 1.0 / (raw["r"][on] + 1j * raw["x"][on])
    half_shunt = 0.5 * (raw["g"][on] + 1j * raw["b"][on])
    tau, phi = raw["tau"][on], raw["phi"][on]
    return Case(
        n=n, bus_type=bus_type, slack=int(slack[0]),
        vm_case=raw["vm"].copy(), va_case=raw["va"].copy(),
        vm_start=vm_start,
        p_sched=supply_p - raw["pd"], q_sched=supply_q - raw["qd"],
        shunt=raw["gs"] + 1j * raw["bs"],
        f=raw["f"][on], t=raw["t"][on],
        yff=(y + half_shunt) / tau ** 2,
        yft=-y / (tau * np.exp(-1j * phi)),
        ytf=-y / (tau * np.exp(1j * phi)),
        ytt=y + half_shunt)
