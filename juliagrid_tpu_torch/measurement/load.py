"""Measurement constructors and the ``ems`` bootstrap
(reference measurement/load.jl:31-163)."""

from __future__ import annotations

import os

from ..system.load import power_system
from .types import Measurement


def measurement(system, path: str | None = None) -> Measurement:
    monitoring = Measurement(system=system)
    if path is not None:
        ext = os.path.splitext(path)[1].lower()
        if ext in (".h5", ".hdf5"):
            from .hdf5io import load_measurement
            load_measurement(monitoring, path)
        else:
            raise ValueError(f"the file extension {ext!r} is not supported")
    return monitoring


def ems(system_file: str | None = None, *monitoring_files,
        optimal: bool = True):
    """One-call bootstrap (reference ems, measurement/load.jl:134-163):
    returns (system, monitoring[, pseudo, ...]) — one Measurement per
    monitoring file (or a single empty one when none is given)."""
    system = power_system(system_file, optimal=optimal)
    if not monitoring_files:
        return system, measurement(system)
    sets = tuple(measurement(system, f) for f in monitoring_files)
    return (system, *sets)
