"""Numpy-only snapshots of HDF5 power-system cases.

A snapshot is a compressed ``.npz`` that holds every dataset of an HDF5
case (the layout of ``system/hdf5io.py``) under its ``group/dataset`` path
and every file attribute under ``@`` and its name. Labels are stored as
byte strings, so the file loads without pickle. Writing one needs h5py
(``h5_to_npz``); reading one needs numpy only, so ``power_system("x.npz")``
loads a real case on a machine without h5py.
"""

from __future__ import annotations

import numpy as np

from .hdf5io import load_tables
from .types import PowerSystem

ATTR = "@"


def h5_to_npz(h5_path: str, npz_path: str) -> None:
    """Write the snapshot of the HDF5 case ``h5_path`` to ``npz_path``."""
    import h5py

    out = {}

    def take(name, obj):
        if isinstance(obj, h5py.Dataset):
            val = np.asarray(obj[()])
            if val.dtype == object:
                val = np.asarray([v if isinstance(v, bytes)
                                  else str(v).encode() for v in val.flat],
                                 dtype=bytes).reshape(val.shape)
            out[name] = val

    with h5py.File(h5_path, "r") as fh:
        fh.visititems(take)
        for key, val in fh.attrs.items():
            out[ATTR + key] = np.asarray(val)
    np.savez_compressed(npz_path, **out)


class _Dataset:
    """One stored array, read as h5py reads a dataset."""

    def __init__(self, value: np.ndarray):
        self.value = value
        self.size = value.size

    def __getitem__(self, key):
        return self.value[key]

    def __array__(self, dtype=None, copy=None):
        return self.value if dtype is None else self.value.astype(dtype)


class _Snapshot:
    """The arrays of a loaded snapshot, under ``hdf5io.load_tables``'s
    file interface."""

    def __init__(self, arrays: dict):
        self.arrays = {k: v for k, v in arrays.items()
                       if not k.startswith(ATTR)}
        self.attrs = {k[len(ATTR):]: v[()] for k, v in arrays.items()
                      if k.startswith(ATTR)}

    def __contains__(self, path):
        return path in self.arrays

    def __getitem__(self, path):
        return _Dataset(self.arrays[path])


def load_snapshot(system: PowerSystem, path: str) -> None:
    """Fill ``system`` from the snapshot at ``path`` (numpy only)."""
    with np.load(path, allow_pickle=False) as data:
        load_tables(system, _Snapshot({k: data[k] for k in data.files}))
