"""Measurement-set configuration: randomized in/out-of-service selection.

Reference: JuliaGrid src/measurement/configuration.jl:44-763. A device
set can be configured by the number in service, number out of service, or a
redundancy ratio (devices kept / (2*buses - 1)). Per-device and per-location
variants mirror the reference function family.
"""

from __future__ import annotations

import numpy as np

from .types import Measurement
from ..utils.errors import StatusCountError

_rng = np.random.default_rng()


def seed(value: int) -> None:
    global _rng
    _rng = np.random.default_rng(value)


def _apply(statuses, inservice=None, outservice=None, redundancy=None,
           n_buses=None):
    total = sum(len(s) for s in statuses)
    if total == 0:
        return
    if redundancy is not None:
        inservice = int(round(redundancy * (2 * n_buses - 1)))
    if inservice is not None:
        if int(inservice) > total:
            raise StatusCountError(
                "The total number of available devices is less than the "
                "requested number for a status change.")
        keep = int(inservice)
    elif outservice is not None:
        if int(outservice) > total:
            raise StatusCountError(
                "The total number of available devices is less than the "
                "requested number for a status change.")
        keep = total - int(outservice)
    else:
        return
    order = _rng.permutation(total)
    chosen = set(order[:keep].tolist())
    pos = 0
    for s in statuses:
        for i in range(len(s)):
            s[i] = 1 if pos in chosen else 0
            pos += 1


def status(monitoring: Measurement, *, inservice=None, outservice=None,
           redundancy=None):
    """Reference status!: randomize across all device types at once."""
    pmu = monitoring.pmu
    _apply(
        [monitoring.voltmeter.magnitude.status,
         monitoring.ammeter.magnitude.status,
         monitoring.wattmeter.active.status,
         monitoring.varmeter.reactive.status],
        inservice, outservice, redundancy, monitoring.system.bus.number)
    # PMUs: magnitude/angle share status
    _apply([pmu.magnitude.status], inservice=None if inservice is None else 0)
    if inservice is not None or outservice is not None \
            or redundancy is not None:
        for i in range(pmu.number):
            pmu.angle.status[i] = pmu.magnitude.status[i]
    monitoring.changed_values()


def _status_single(monitoring, store, meter, inservice, outservice,
                   redundancy):
    _apply([meter.status], inservice, outservice, redundancy,
           monitoring.system.bus.number)
    monitoring.changed_values()


def status_voltmeter(monitoring: Measurement, *, inservice=None,
                     outservice=None, redundancy=None):
    _status_single(monitoring, monitoring.voltmeter,
                   monitoring.voltmeter.magnitude, inservice, outservice,
                   redundancy)


def _apply_where(meter, mask, inservice, outservice, redundancy, n_buses):
    idxs = np.flatnonzero(mask)
    total = len(idxs)
    if total == 0:
        return
    if redundancy is not None:
        inservice = int(round(redundancy * (2 * n_buses - 1)))
    if inservice is not None:
        if int(inservice) > total:
            raise StatusCountError(
                "The total number of available devices is less than the "
                "requested number for a status change.")
        keep = int(inservice)
    elif outservice is not None:
        if int(outservice) > total:
            raise StatusCountError(
                "The total number of available devices is less than the "
                "requested number for a status change.")
        keep = total - int(outservice)
    else:
        return
    chosen = set(_rng.permutation(total)[:keep].tolist())
    for pos, i in enumerate(idxs):
        meter.status[int(i)] = 1 if pos in chosen else 0


def status_ammeter(monitoring: Measurement, *, inservice=None,
                   outservice=None, redundancy=None,
                   inservice_from=None, outservice_from=None,
                   redundancy_from=None, inservice_to=None,
                   outservice_to=None, redundancy_to=None):
    amp = monitoring.ammeter
    n = monitoring.system.bus.number
    if any(v is not None for v in (inservice, outservice, redundancy)):
        _apply([amp.magnitude.status], inservice, outservice, redundancy, n)
    _apply_where(amp.magnitude, amp.layout.from_.array[: amp.number],
                 inservice_from, outservice_from, redundancy_from, n)
    _apply_where(amp.magnitude, amp.layout.to.array[: amp.number],
                 inservice_to, outservice_to, redundancy_to, n)
    monitoring.changed_values()


def _status_powermeter(monitoring, store, meter, kw):
    n = monitoring.system.bus.number
    if any(kw.get(k) is not None
           for k in ("inservice", "outservice", "redundancy")):
        _apply([meter.status], kw.get("inservice"), kw.get("outservice"),
               kw.get("redundancy"), n)
    _apply_where(meter, store.layout.bus.array[: store.number],
                 kw.get("inservice_bus"), kw.get("outservice_bus"),
                 kw.get("redundancy_bus"), n)
    _apply_where(meter, store.layout.from_.array[: store.number],
                 kw.get("inservice_from"), kw.get("outservice_from"),
                 kw.get("redundancy_from"), n)
    _apply_where(meter, store.layout.to.array[: store.number],
                 kw.get("inservice_to"), kw.get("outservice_to"),
                 kw.get("redundancy_to"), n)
    monitoring.changed_values()


def status_wattmeter(monitoring: Measurement, **kw):
    _status_powermeter(monitoring, monitoring.wattmeter,
                       monitoring.wattmeter.active, kw)


def status_varmeter(monitoring: Measurement, **kw):
    _status_powermeter(monitoring, monitoring.varmeter,
                       monitoring.varmeter.reactive, kw)


def status_pmu(monitoring: Measurement, *, inservice=None, outservice=None,
               redundancy=None, **kw):
    pmu = monitoring.pmu
    n = monitoring.system.bus.number
    if any(v is not None for v in (inservice, outservice, redundancy)):
        _apply([pmu.magnitude.status], inservice, outservice, redundancy, n)
    _apply_where(pmu.magnitude, pmu.layout.bus.array[: pmu.number],
                 kw.get("inservice_bus"), kw.get("outservice_bus"),
                 kw.get("redundancy_bus"), n)
    _apply_where(pmu.magnitude, pmu.layout.from_.array[: pmu.number],
                 kw.get("inservice_from"), kw.get("outservice_from"),
                 kw.get("redundancy_from"), n)
    _apply_where(pmu.magnitude, pmu.layout.to.array[: pmu.number],
                 kw.get("inservice_to"), kw.get("outservice_to"),
                 kw.get("redundancy_to"), n)
    for i in range(pmu.number):
        pmu.angle.status[i] = pmu.magnitude.status[i]
    monitoring.changed_values()
