"""Growable numpy-backed vector with amortized O(1) append.

The reference grows its SoA fields with Julia ``push!``; this is the numpy
equivalent used by all host-side builders. ``.array`` exposes the live
portion as a (non-owning) numpy view for vectorized assembly.
"""

from __future__ import annotations

import numpy as np


class Vec:
    __slots__ = ("_buf", "_n")

    def __init__(self, dtype="float64", data=None):
        if data is not None:
            arr = np.asarray(data, dtype=dtype)
            self._buf = arr.copy()
            self._n = len(arr)
        else:
            self._buf = np.empty(8, dtype=dtype)
            self._n = 0

    # -- growth ------------------------------------------------------------
    def _ensure(self, extra: int) -> None:
        need = self._n + extra
        if need > len(self._buf):
            cap = max(need, 2 * len(self._buf))
            buf = np.empty(cap, dtype=self._buf.dtype)
            buf[: self._n] = self._buf[: self._n]
            self._buf = buf

    def append(self, value) -> None:
        self._ensure(1)
        self._buf[self._n] = value
        self._n += 1

    def extend(self, values) -> None:
        values = np.asarray(values, dtype=self._buf.dtype)
        self._ensure(len(values))
        self._buf[self._n : self._n + len(values)] = values
        self._n += len(values)

    def pop(self):
        self._n -= 1
        return self._buf[self._n]

    # -- access ------------------------------------------------------------
    @property
    def array(self) -> np.ndarray:
        return self._buf[: self._n]

    def __getitem__(self, i):
        return self.array[i]

    def __setitem__(self, i, v):
        self.array[i] = v

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return iter(self.array)

    def __eq__(self, other):
        if isinstance(other, Vec):
            other = other.array
        return bool(np.array_equal(self.array, np.asarray(other)))

    def __repr__(self) -> str:
        return f"Vec({self.array!r})"

    def copy(self) -> "Vec":
        return Vec(self._buf.dtype, self.array)

    def fill(self, value) -> None:
        self.array[:] = value
