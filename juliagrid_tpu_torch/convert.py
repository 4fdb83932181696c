"""Network state carried across: numpy arrays to the port's device snapshots.

``ac_arrays_from_numpy`` takes the fields of an ``AcArrays`` as numpy
arrays — from the port's own host layer, or ``np.asarray`` of each field of
the JAX package's ``AcArrays`` — and places them on a torch device with the
CSR row offsets K1 needs. Feeding both packages the same arrays lets a test
compare their kernels without going through either host layer.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .powerflow.ac import AcArrays, check_entry_list


def ac_arrays_from_numpy(*, rows, cols, yg, yb, diag, bus_type, slack,
                         p_sched, q_sched, device=None) -> AcArrays:
    """``AcArrays`` on ``device`` (default ``config.device``) from numpy."""
    dev = resolve_device(device)
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    diag = np.asarray(diag, dtype=np.int32)
    n = len(p_sched)
    check_entry_list(rows, cols, diag, n)
    row_ptr = np.searchsorted(rows, np.arange(n + 1)).astype(np.int32)

    def i32(a):
        return torch.tensor(np.asarray(a, dtype=np.int32), device=dev)

    def f64(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)

    return AcArrays(rows=i32(rows), cols=i32(cols), yg=f64(yg), yb=f64(yb),
                    diag=i32(diag), bus_type=i32(bus_type), slack=int(slack),
                    p_sched=f64(p_sched), q_sched=f64(q_sched),
                    row_ptr=i32(row_ptr))
