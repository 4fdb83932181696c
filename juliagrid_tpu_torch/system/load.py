"""Power-system constructors: from files or empty.

Equivalent of the reference ``powerSystem`` entry points
(JuliaGrid src/powerSystem/load.jl:36-103): dispatch on file
extension (.m / .raw / .h5, and .npz for the numpy-only snapshot of an
HDF5 case, ``system/snapshot.py``), or build an empty system for manual
construction with the add_* builders.
"""

from __future__ import annotations

import os

from .types import PowerSystem


def power_system(path: str | None = None, optimal: bool = True) -> PowerSystem:
    system = PowerSystem()
    system.bus.layout.optimal = optimal

    if path is None:
        return system

    ext = os.path.splitext(path)[1].lower()
    if ext == ".m":
        from .matpower import parse_matpower
        parse_matpower(system, path)
    elif ext == ".raw":
        from .psse import parse_psse
        parse_psse(system, path)
    elif ext in (".h5", ".hdf5"):
        from .hdf5io import load_power_system
        load_power_system(system, path)
    elif ext == ".npz":
        from .snapshot import load_snapshot
        load_snapshot(system, path)
    else:
        raise ValueError(f"the file extension {ext!r} is not supported")
    return system
