"""HDF5 measurement reader/writer, format-compatible with the reference
(JuliaGrid src/measurement/load.jl:31-274, save.jl:31-168):
per-device groups with GaussMeter datasets (scalar-compressed), 1-based
layout indices, uint8 booleans."""

from __future__ import annotations

import numpy as np

from ..utils.vec import Vec
from .types import Measurement


def _expand(ds, n, dtype=np.float64):
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


def load_measurement(monitoring: Measurement, path: str) -> None:
    import h5py

    with h5py.File(path, "r") as fh:
        def meter(grp, name, count):
            return (
                Vec("float64", _expand(fh[f"{grp}/{name}/mean"], count)),
                Vec("float64", _expand(fh[f"{grp}/{name}/variance"], count)),
                Vec("int8", _expand(fh[f"{grp}/{name}/status"], count,
                                    np.int8)))

        if "voltmeter" in fh:
            v = monitoring.voltmeter
            count = int(fh.attrs.get("number of voltmeters",
                                     len(fh["voltmeter/label"])))
            v.number = count
            for lbl in _labels(fh["voltmeter/label"]):
                v.label.add(lbl)
            (v.magnitude.mean, v.magnitude.variance,
             v.magnitude.status) = meter("voltmeter", "magnitude", count)
            v.layout.index = Vec("int64", _expand(
                fh["voltmeter/layout/index"], count, np.int64) - 1)

        if "ammeter" in fh:
            a = monitoring.ammeter
            count = int(fh.attrs.get("number of ammeters",
                                     len(fh["ammeter/label"])))
            a.number = count
            for lbl in _labels(fh["ammeter/label"]):
                a.label.add(lbl)
            (a.magnitude.mean, a.magnitude.variance,
             a.magnitude.status) = meter("ammeter", "magnitude", count)
            a.layout.index = Vec("int64", _expand(
                fh["ammeter/layout/index"], count, np.int64) - 1)
            a.layout.from_ = Vec("bool", _expand(
                fh["ammeter/layout/from"], count, np.uint8).astype(bool))
            a.layout.to = Vec("bool", _expand(
                fh["ammeter/layout/to"], count, np.uint8).astype(bool))
            a.layout.square = Vec("bool", _expand(
                fh["ammeter/layout/square"], count, np.uint8).astype(bool))

        for grp, store, meter_name in (
                ("wattmeter", monitoring.wattmeter, "active"),
                ("varmeter", monitoring.varmeter, "reactive")):
            if grp not in fh:
                continue
            count = int(fh.attrs.get(f"number of {grp}s",
                                     len(fh[f"{grp}/label"])))
            store.number = count
            for lbl in _labels(fh[f"{grp}/label"]):
                store.label.add(lbl)
            mtr = getattr(store, meter_name)
            mtr.mean, mtr.variance, mtr.status = meter(grp, meter_name, count)
            store.layout.index = Vec("int64", _expand(
                fh[f"{grp}/layout/index"], count, np.int64) - 1)
            store.layout.bus = Vec("bool", _expand(
                fh[f"{grp}/layout/bus"], count, np.uint8).astype(bool))
            store.layout.from_ = Vec("bool", _expand(
                fh[f"{grp}/layout/from"], count, np.uint8).astype(bool))
            store.layout.to = Vec("bool", _expand(
                fh[f"{grp}/layout/to"], count, np.uint8).astype(bool))

        if "pmu" in fh:
            p = monitoring.pmu
            count = int(fh.attrs.get("number of pmus", len(fh["pmu/label"])))
            p.number = count
            for lbl in _labels(fh["pmu/label"]):
                p.label.add(lbl)
            (p.magnitude.mean, p.magnitude.variance,
             p.magnitude.status) = meter("pmu", "magnitude", count)
            (p.angle.mean, p.angle.variance,
             p.angle.status) = meter("pmu", "angle", count)
            p.layout.index = Vec("int64", _expand(
                fh["pmu/layout/index"], count, np.int64) - 1)
            for attr, name in (("bus", "bus"), ("from_", "from"),
                               ("to", "to"), ("correlated", "correlated"),
                               ("polar", "polar"), ("square", "square")):
                setattr(p.layout, attr, Vec("bool", _expand(
                    fh[f"pmu/layout/{name}"], count,
                    np.uint8).astype(bool)))
    monitoring.changed()


def _compress(arr):
    arr = np.asarray(arr)
    if arr.size and np.all(arr == arr.flat[0]):
        return arr.flat[0]
    return arr


def save_measurement(monitoring: Measurement, path: str,
                     reference: str = "", note: str = "") -> None:
    """Reference saveMeasurement (measurement/save.jl:31-168)."""
    import h5py

    with h5py.File(path, "w") as fh:
        if reference:
            fh.attrs["reference"] = np.bytes_(reference.encode())
        if note:
            fh.attrs["note"] = np.bytes_(note.encode())

        def w(name, data):
            fh.create_dataset(name, data=_compress(data))

        def meter(grp, name, mtr, count):
            w(f"{grp}/{name}/mean", mtr.mean.array[:count])
            w(f"{grp}/{name}/variance", mtr.variance.array[:count])
            w(f"{grp}/{name}/status", mtr.status.array[:count])

        v = monitoring.voltmeter
        fh.attrs["number of voltmeters"] = v.number
        if v.number:
            fh.create_dataset("voltmeter/label", data=[
                str(x).encode() for x in v.label.labels()])
            fh["voltmeter/layout/label"] = v.label.counter
            w("voltmeter/layout/index", v.layout.index.array[:v.number] + 1)
            meter("voltmeter", "magnitude", v.magnitude, v.number)

        a = monitoring.ammeter
        fh.attrs["number of ammeters"] = a.number
        if a.number:
            fh.create_dataset("ammeter/label", data=[
                str(x).encode() for x in a.label.labels()])
            fh["ammeter/layout/label"] = a.label.counter
            w("ammeter/layout/index", a.layout.index.array[:a.number] + 1)
            w("ammeter/layout/from",
              a.layout.from_.array[:a.number].astype(np.uint8))
            w("ammeter/layout/to",
              a.layout.to.array[:a.number].astype(np.uint8))
            w("ammeter/layout/square",
              a.layout.square.array[:a.number].astype(np.uint8))
            meter("ammeter", "magnitude", a.magnitude, a.number)

        for grp, store, meter_name in (
                ("wattmeter", monitoring.wattmeter, "active"),
                ("varmeter", monitoring.varmeter, "reactive")):
            fh.attrs[f"number of {grp}s"] = store.number
            if not store.number:
                continue
            fh.create_dataset(f"{grp}/label", data=[
                str(x).encode() for x in store.label.labels()])
            fh[f"{grp}/layout/label"] = store.label.counter
            w(f"{grp}/layout/index",
              store.layout.index.array[:store.number] + 1)
            w(f"{grp}/layout/bus",
              store.layout.bus.array[:store.number].astype(np.uint8))
            w(f"{grp}/layout/from",
              store.layout.from_.array[:store.number].astype(np.uint8))
            w(f"{grp}/layout/to",
              store.layout.to.array[:store.number].astype(np.uint8))
            meter(grp, meter_name, getattr(store, meter_name), store.number)

        p = monitoring.pmu
        fh.attrs["number of pmus"] = p.number
        if p.number:
            fh.create_dataset("pmu/label", data=[
                str(x).encode() for x in p.label.labels()])
            fh["pmu/layout/label"] = p.label.counter
            w("pmu/layout/index", p.layout.index.array[:p.number] + 1)
            for attr, name in (("bus", "bus"), ("from_", "from"),
                               ("to", "to"), ("correlated", "correlated"),
                               ("polar", "polar"), ("square", "square")):
                w(f"pmu/layout/{name}", getattr(
                    p.layout, attr).array[:p.number].astype(np.uint8))
            meter("pmu", "magnitude", p.magnitude, p.number)
            meter("pmu", "angle", p.angle, p.number)
