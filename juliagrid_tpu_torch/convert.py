"""Network and measurement state carried across: numpy arrays to the port's
device snapshots.

``ac_arrays_from_numpy`` takes the fields of an ``AcArrays`` as numpy
arrays — from the port's own host layer, or ``np.asarray`` of each field of
the JAX package's ``AcArrays`` — and places them on a torch device with the
CSR row offsets K1 needs. ``se_arrays_from_numpy`` does the same for the
measurement-row IR: it takes an ``SeArrays`` host mirror (the port's, or
the JAX package's from ``compile_se_arrays(..., return_host=True)``) and
adds K3's descriptor table. Feeding both packages the same arrays lets a
test compare their kernels without going through either host layer.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .estimation.acse import BranchGroup, SeArrays
from .kernels.se_fill import SeFillTable, se_fill_table
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


def se_arrays_from_numpy(host, device=None) -> SeArrays:
    """``SeArrays`` on ``device`` (default ``config.device``), with K3's
    descriptor table, from a host mirror whose fields are numpy arrays.
    Index fields become int64 tensors; the table is checked on the host
    (``se_fill_table``) before it reaches K3."""
    dev = resolve_device(device)
    idx, coef = se_fill_table(host)

    def i64(a):
        return torch.tensor(np.asarray(a, dtype=np.int64), device=dev)

    def f64(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)

    branch = tuple(BranchGroup(rows=i64(g.rows), f=i64(g.f), t=i64(g.t),
                               a=f64(g.a), b=f64(g.b), c=f64(g.c),
                               d=f64(g.d), phi=f64(g.phi))
                   for g in host.branch)
    index = {name: i64(getattr(host, name)) for name in (
        "pair_r1", "pair_r2", "vm_rows", "vm_bus", "va_rows", "va_bus",
        "rev_rows", "rev_bus", "imv_rows", "imv_bus", "p_rows", "p_bus",
        "p_ent_meas", "p_ent_k", "q_rows", "q_bus", "q_ent_meas",
        "q_ent_k")}
    return SeArrays(
        mean=f64(host.mean), w=f64(host.w), status=f64(host.status),
        pair_off=f64(host.pair_off), slack=int(host.slack), branch=branch,
        desc=SeFillTable(
            idx=torch.tensor(idx, device=dev),
            coef=torch.tensor(coef, device=dev)),
        **index)
