"""HDF5 power-system reader/writer, format-compatible with the reference.

Layout and conventions match JuliaGrid src/powerSystem/load.jl
(hdf5Bus/Branch/Generator/Base, :141-281) and save.jl (:22-412):
group-per-subsystem datasets in per-unit, constant-vector compression
(a scalar dataset expands to a full vector), 1-based layout indices,
string-or-int labels, polynomial costs as rows [gen, n, coeffs...] and
piecewise costs as stacked rows [gen, output, price].
"""

from __future__ import annotations

import numpy as np

from ..utils.labels import LabelRegistry
from ..utils.vec import Vec
from .types import PowerSystem


def _expand(ds, n, dtype=np.float64):
    """readHDF5 scalar-or-vector expansion (load.jl:1360)."""
    val = ds[()]
    if np.ndim(val) == 0:
        return np.full(n, val, dtype=dtype)
    return np.asarray(val, dtype=dtype)


def _labels(ds):
    out = []
    for v in ds[()]:
        if isinstance(v, bytes):
            v = v.decode()
        try:
            out.append(int(v))
        except (TypeError, ValueError):
            out.append(v)
    return out


def load_power_system(system: PowerSystem, path: str) -> None:
    import h5py

    with h5py.File(path, "r") as fh:
        load_tables(system, fh)


def load_tables(system: PowerSystem, fh) -> None:
    """Fill ``system`` from an open case: an ``h5py.File``, or anything
    that answers the same ``attrs``, ``in``, ``[path]`` and ``[()]``
    (``system/snapshot.py``'s numpy-only reader)."""
    n = int(fh.attrs["number of buses"])
    m = int(fh.attrs["number of branches"])
    g = int(fh.attrs["number of generators"])
    optimal = bool(fh.attrs.get("optimal", 1)) \
        and system.bus.layout.optimal

    bus = system.bus
    bus.number = n
    for lbl in _labels(fh["bus/label"]):
        bus.label.add(lbl)
    if "bus/layout/label" in fh:
        bus.label.counter = int(fh["bus/layout/label"][()])
    bus.layout.type = Vec("int8", _expand(fh["bus/layout/type"], n,
                                          np.int8))
    bus.layout.area = Vec("int64", _expand(fh["bus/layout/area"], n,
                                           np.int64))
    bus.layout.loss_zone = Vec("int64", _expand(
        fh["bus/layout/lossZone"], n, np.int64))
    bus.demand.active = Vec("float64", _expand(fh["bus/demand/active"], n))
    bus.demand.reactive = Vec("float64", _expand(
        fh["bus/demand/reactive"], n))
    bus.shunt.conductance = Vec("float64", _expand(
        fh["bus/shunt/conductance"], n))
    bus.shunt.susceptance = Vec("float64", _expand(
        fh["bus/shunt/susceptance"], n))
    bus.voltage.magnitude = Vec("float64", _expand(
        fh["bus/voltage/magnitude"], n))
    bus.voltage.angle = Vec("float64", _expand(fh["bus/voltage/angle"], n))
    if optimal and "bus/voltage/minMagnitude" in fh:
        bus.voltage.min_magnitude = Vec("float64", _expand(
            fh["bus/voltage/minMagnitude"], n))
        bus.voltage.max_magnitude = Vec("float64", _expand(
            fh["bus/voltage/maxMagnitude"], n))
    types = bus.layout.type.array[:n]
    slack = np.flatnonzero(types == 3)
    # reference load.jl:155-160 keeps the FIRST type-3 bus as slack
    bus.layout.slack = int(slack[0]) if len(slack) else 0
    bus.supply.active = Vec("float64", np.zeros(n))
    bus.supply.reactive = Vec("float64", np.zeros(n))

    system.base.power.value = float(fh["base/power"][()])
    system.base.voltage.value = Vec("float64", _expand(
        fh["base/voltage"], n))

    branch = system.branch
    branch.number = m
    for lbl in _labels(fh["branch/label"]):
        branch.label.add(lbl)
    branch.layout.from_bus = Vec("int64", _expand(
        fh["branch/layout/from"], m, np.int64) - 1)
    branch.layout.to_bus = Vec("int64", _expand(
        fh["branch/layout/to"], m, np.int64) - 1)
    branch.layout.status = Vec("int8", _expand(
        fh["branch/layout/status"], m, np.int8))
    branch.layout.inservice = int(
        (branch.layout.status.array[:m] == 1).sum())
    prm = branch.parameter
    prm.resistance = Vec("float64", _expand(
        fh["branch/parameter/resistance"], m))
    prm.reactance = Vec("float64", _expand(
        fh["branch/parameter/reactance"], m))
    prm.conductance = Vec("float64", _expand(
        fh["branch/parameter/conductance"], m))
    prm.susceptance = Vec("float64", _expand(
        fh["branch/parameter/susceptance"], m))
    prm.turns_ratio = Vec("float64", _expand(
        fh["branch/parameter/turnsRatio"], m))
    prm.shift_angle = Vec("float64", _expand(
        fh["branch/parameter/shiftAngle"], m))
    if optimal and "branch/flow/minFromBus" in fh:
        branch.flow.min_from_bus = Vec("float64", _expand(
            fh["branch/flow/minFromBus"], m))
        branch.flow.max_from_bus = Vec("float64", _expand(
            fh["branch/flow/maxFromBus"], m))
        branch.flow.min_to_bus = Vec("float64", _expand(
            fh["branch/flow/minToBus"], m))
        branch.flow.max_to_bus = Vec("float64", _expand(
            fh["branch/flow/maxToBus"], m))
        branch.flow.type = Vec("int8", _expand(
            fh["branch/flow/type"], m, np.int8))
        branch.voltage.min_diff_angle = Vec("float64", _expand(
            fh["branch/voltage/minDiffAngle"], m))
        branch.voltage.max_diff_angle = Vec("float64", _expand(
            fh["branch/voltage/maxDiffAngle"], m))

    gen = system.generator
    gen.number = g
    for lbl in _labels(fh["generator/label"]):
        gen.label.add(lbl)
    gen.layout.bus = Vec("int64", _expand(
        fh["generator/layout/bus"], g, np.int64) - 1)
    gen.layout.status = Vec("int8", _expand(
        fh["generator/layout/status"], g, np.int8))
    gen.output.active = Vec("float64", _expand(
        fh["generator/output/active"], g))
    gen.output.reactive = Vec("float64", _expand(
        fh["generator/output/reactive"], g))
    gen.voltage.magnitude = Vec("float64", _expand(
        fh["generator/voltage/magnitude"], g))
    cap = gen.capability
    for attr, name in (
            ("min_active", "minActive"), ("max_active", "maxActive"),
            ("min_reactive", "minReactive"),
            ("max_reactive", "maxReactive"),
            ("low_active", "lowActive"), ("up_active", "upActive"),
            ("min_low_reactive", "minLowReactive"),
            ("max_low_reactive", "maxLowReactive"),
            ("min_up_reactive", "minUpReactive"),
            ("max_up_reactive", "maxUpReactive")):
        key = f"generator/capability/{name}"
        if key in fh:
            setattr(cap, attr, Vec("float64", _expand(fh[key], g)))

    for i in range(g):
        if gen.layout.status[i] == 1:
            b = int(gen.layout.bus[i])
            system.add_gen_in_bus(b, i)
            bus.supply.active[b] += gen.output.active[i]
            bus.supply.reactive[b] += gen.output.reactive[i]
            gen.layout.inservice += 1

    if optimal:
        gen.cost.active.model = Vec("int8", _expand(
            fh["generator/cost/active/model"], g, np.int8)) \
            if "generator/cost/active/model" in fh \
            else Vec("int8", np.zeros(g, dtype=np.int8))
        gen.cost.reactive.model = Vec("int8", _expand(
            fh["generator/cost/reactive/model"], g, np.int8)) \
            if "generator/cost/reactive/model" in fh \
            else Vec("int8", np.zeros(g, dtype=np.int8))
        for kind, store in (("active", gen.cost.active),
                            ("reactive", gen.cost.reactive)):
            pkey = f"generator/cost/{kind}/polynomial"
            if pkey in fh and fh[pkey].size:
                rows = np.atleast_2d(np.asarray(fh[pkey]))
                for r in rows:
                    if len(r) < 2:
                        continue
                    gi = int(r[0]) - 1
                    nco = int(r[1])
                    if nco > 0:
                        store.polynomial[gi] = np.asarray(r[2:2 + nco])
            wkey = f"generator/cost/{kind}/piecewise"
            if wkey in fh and fh[wkey].size:
                rows = np.atleast_2d(np.asarray(fh[wkey]))
                if rows.shape[1] != 3:
                    rows = rows.T
                by_gen: dict = {}
                for r in rows:
                    by_gen.setdefault(int(r[0]) - 1, []).append(
                        (r[1], r[2]))
                for gi, pts in by_gen.items():
                    store.piecewise[gi] = np.asarray(pts)
    else:
        gen.cost.active.model = Vec("int8", np.zeros(g, dtype=np.int8))
        gen.cost.reactive.model = Vec("int8", np.zeros(g, dtype=np.int8))


def _compress(arr):
    """Constant-vector compression (reference compresseArray, save.jl:328)."""
    arr = np.asarray(arr)
    if arr.size and np.all(arr == arr.flat[0]):
        return arr.flat[0]
    return arr


def save_power_system(system: PowerSystem, path: str,
                      reference: str = "", note: str = "") -> None:
    """Reference savePowerSystem (save.jl:22-412)."""
    import h5py

    n, m, g = system.bus.number, system.branch.number, system.generator.number
    bus, branch, gen = system.bus, system.branch, system.generator
    with h5py.File(path, "w") as fh:
        fh.attrs["number of buses"] = n
        fh.attrs["number of branches"] = m
        fh.attrs["number of generators"] = g
        fh.attrs["number of in-service branches"] = branch.layout.inservice
        fh.attrs["number of in-service generators"] = gen.layout.inservice
        fh.attrs["optimal"] = np.uint8(1 if bus.layout.optimal else 0)
        if reference:
            fh.attrs["reference"] = np.bytes_(reference.encode())
        if note:
            fh.attrs["note"] = np.bytes_(note.encode())

        def w(name, data):
            fh.create_dataset(name, data=_compress(data))

        labels = [str(x).encode() for x in bus.label.labels()]
        fh.create_dataset("bus/label", data=labels)
        w("bus/layout/type", bus.layout.type.array[:n])
        w("bus/layout/area", bus.layout.area.array[:n])
        w("bus/layout/lossZone", bus.layout.loss_zone.array[:n])
        fh["bus/layout/label"] = bus.label.counter
        w("bus/demand/active", bus.demand.active.array[:n])
        w("bus/demand/reactive", bus.demand.reactive.array[:n])
        w("bus/shunt/conductance", bus.shunt.conductance.array[:n])
        w("bus/shunt/susceptance", bus.shunt.susceptance.array[:n])
        w("bus/voltage/magnitude", bus.voltage.magnitude.array[:n])
        w("bus/voltage/angle", bus.voltage.angle.array[:n])
        if bus.layout.optimal and len(bus.voltage.min_magnitude):
            w("bus/voltage/minMagnitude", bus.voltage.min_magnitude.array[:n])
            w("bus/voltage/maxMagnitude", bus.voltage.max_magnitude.array[:n])

        w("base/power", system.base.power.value)
        w("base/voltage", system.base.voltage.value.array[:n])

        labels = [str(x).encode() for x in branch.label.labels()]
        fh.create_dataset("branch/label", data=labels)
        fh["branch/layout/label"] = branch.label.counter
        w("branch/layout/from", branch.layout.from_bus.array[:m] + 1)
        w("branch/layout/to", branch.layout.to_bus.array[:m] + 1)
        w("branch/layout/status", branch.layout.status.array[:m])
        prm = branch.parameter
        w("branch/parameter/resistance", prm.resistance.array[:m])
        w("branch/parameter/reactance", prm.reactance.array[:m])
        w("branch/parameter/conductance", prm.conductance.array[:m])
        w("branch/parameter/susceptance", prm.susceptance.array[:m])
        w("branch/parameter/turnsRatio", prm.turns_ratio.array[:m])
        w("branch/parameter/shiftAngle", prm.shift_angle.array[:m])
        if bus.layout.optimal and len(branch.flow.type):
            w("branch/flow/minFromBus", branch.flow.min_from_bus.array[:m])
            w("branch/flow/maxFromBus", branch.flow.max_from_bus.array[:m])
            w("branch/flow/minToBus", branch.flow.min_to_bus.array[:m])
            w("branch/flow/maxToBus", branch.flow.max_to_bus.array[:m])
            w("branch/flow/type", branch.flow.type.array[:m])
            w("branch/voltage/minDiffAngle",
              branch.voltage.min_diff_angle.array[:m])
            w("branch/voltage/maxDiffAngle",
              branch.voltage.max_diff_angle.array[:m])

        labels = [str(x).encode() for x in gen.label.labels()]
        fh.create_dataset("generator/label", data=labels)
        fh["generator/layout/label"] = gen.label.counter
        w("generator/layout/bus", gen.layout.bus.array[:g] + 1)
        w("generator/layout/status", gen.layout.status.array[:g])
        w("generator/output/active", gen.output.active.array[:g])
        w("generator/output/reactive", gen.output.reactive.array[:g])
        w("generator/voltage/magnitude", gen.voltage.magnitude.array[:g])
        cap = gen.capability
        for attr, name in (
                ("min_active", "minActive"), ("max_active", "maxActive"),
                ("min_reactive", "minReactive"),
                ("max_reactive", "maxReactive"),
                ("low_active", "lowActive"), ("up_active", "upActive"),
                ("min_low_reactive", "minLowReactive"),
                ("max_low_reactive", "maxLowReactive"),
                ("min_up_reactive", "minUpReactive"),
                ("max_up_reactive", "maxUpReactive")):
            vec = getattr(cap, attr)
            if len(vec):
                w(f"generator/capability/{name}", vec.array[:g])

        if bus.layout.optimal:
            for kind, store in (("active", gen.cost.active),
                                ("reactive", gen.cost.reactive)):
                w(f"generator/cost/{kind}/model",
                  store.model.array[:g] if len(store.model)
                  else np.zeros(g, dtype=np.int8))
                maxdeg = max((len(p) for p in store.polynomial.values()),
                             default=0)
                rows = np.zeros((len(store.polynomial), maxdeg + 2))
                for k, (gi, poly) in enumerate(store.polynomial.items()):
                    rows[k, 0] = gi + 1
                    rows[k, 1] = len(poly)
                    rows[k, 2:2 + len(poly)] = poly
                fh.create_dataset(f"generator/cost/{kind}/polynomial",
                                  data=rows)
                pts = []
                for gi, mat in store.piecewise.items():
                    for row in np.asarray(mat):
                        pts.append((gi + 1, row[0], row[1]))
                fh.create_dataset(f"generator/cost/{kind}/piecewise",
                                  data=np.asarray(pts).reshape(-1, 3))
