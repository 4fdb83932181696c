"""Network and measurement state carried across: numpy arrays to the port's
device snapshots.

``ac_arrays_from_numpy`` takes the fields of an ``AcArrays`` as numpy
arrays — from the port's own host layer, or ``np.asarray`` of each field of
the JAX package's ``AcArrays`` — and places them on a torch device with the
CSR row offsets K1 needs. ``dc_arrays_from_numpy``,
``fnr_arrays_from_numpy`` and ``gs_arrays_from_numpy`` do the same for the
``DcArrays``, ``FnrArrays`` (whose masked B' and B'' they factor in f64)
and ``GsArrays`` (to which they add the PQ and PV bus lists of K4's two
passes). ``se_arrays_from_numpy`` does the same for the
measurement-row IR: it takes an ``SeArrays`` host mirror (the port's, or
the JAX package's from ``compile_se_arrays(..., return_host=True)``) and
adds K3's descriptor table. ``dcse_arrays_from_numpy`` and
``pmuse_arrays_from_numpy`` take the fields of the JAX package's
``DcSeArrays`` and ``PmuSeArrays`` (dense H included) for the linear
estimators. Feeding both packages the same arrays lets a test compare their
kernels and solves without going through either host layer.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .estimation.acse import BranchGroup, SeArrays
from .estimation.dcse import DcSeArrays
from .estimation.pmuse import PmuSeArrays
from .kernels.se_fill import SeFillTable, se_fill_table
from .ops import linalg
from .powerflow.ac import AcArrays, check_entry_list
from .powerflow.dc import DcArrays
from .powerflow.fast_decoupled import FnrArrays
from .powerflow.gauss_seidel import GsArrays


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


def dc_arrays_from_numpy(*, b_dense, slack, p_sched, shift, gshunt,
                         slack_angle, device=None) -> DcArrays:
    """``DcArrays`` on ``device`` (default ``config.device``) from numpy
    (``b_dense`` may already be a tensor on that device)."""
    dev = resolve_device(device)

    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    return DcArrays(
        b_dense=torch.as_tensor(b_dense, dtype=torch.float64, device=dev),
        slack=int(slack), p_sched=f64(p_sched), shift=f64(shift),
        gshunt=f64(gshunt), slack_angle=float(slack_angle))


def fnr_arrays(base: AcArrays, bp: torch.Tensor,
               bq: torch.Tensor) -> FnrArrays:
    """``FnrArrays`` of the network ``base`` and the masked B' and B'' on
    its device, each factored once in f64."""
    return FnrArrays(*base, bp=linalg.factorize(bp, linalg.LU),
                     bq=linalg.factorize(bq, linalg.LU))


def fnr_arrays_from_numpy(*, rows, cols, yg, yb, diag, bus_type, slack,
                          p_sched, q_sched, bp_a64, bq_a64,
                          device=None) -> FnrArrays:
    """``FnrArrays`` on ``device`` (default ``config.device``) from the
    numpy fields of the JAX package's ``FnrArrays``: its network and its
    f64 masked B' (``bp_a64``) and B'' (``bq_a64``), which are factored
    here in f64 (the JAX package's f32 factors are not taken)."""
    base = ac_arrays_from_numpy(
        rows=rows, cols=cols, yg=yg, yb=yb, diag=diag, bus_type=bus_type,
        slack=slack, p_sched=p_sched, q_sched=q_sched, device=device)
    dev = base.cols.device
    return fnr_arrays(
        base, torch.tensor(np.asarray(bp_a64, dtype=np.float64), device=dev),
        torch.tensor(np.asarray(bq_a64, dtype=np.float64), device=dev))


def gs_arrays_from_numpy(*, nb, yre, yim, dre, dim, bus_type, slack,
                         p_sched, q_sched, vg, device=None) -> GsArrays:
    """``GsArrays`` on ``device`` (default ``config.device``) from numpy,
    with the ascending PQ and PV bus lists K4 walks."""
    dev = resolve_device(device)
    bus_type = np.asarray(bus_type, dtype=np.int32)

    def i32(a):
        return torch.tensor(np.asarray(a, dtype=np.int32), device=dev)

    def f64(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)

    return GsArrays(
        nb=i32(nb), yre=f64(yre), yim=f64(yim), dre=f64(dre), dim=f64(dim),
        bus_type=i32(bus_type), slack=int(slack), p_sched=f64(p_sched),
        q_sched=f64(q_sched), vg=f64(vg),
        pq=i32(np.flatnonzero(bus_type == 1)),
        pv=i32(np.flatnonzero(bus_type == 2)))


def _f64(a, dev) -> torch.Tensor:
    """An f64 tensor on ``dev``: a tensor moved there, or a numpy array
    copied there."""
    if isinstance(a, torch.Tensor):
        return a.to(dev, torch.float64)
    return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)


def dcse_arrays_from_numpy(*, h_dense, mean, w, slack, slack_angle,
                           device=None) -> DcSeArrays:
    """``DcSeArrays`` on ``device`` (default ``config.device``) from the
    numpy fields of a ``DcSeArrays`` (``h_dense`` may already be a tensor
    on that device)."""
    dev = resolve_device(device)
    return DcSeArrays(
        h_dense=_f64(h_dense, dev), mean=_f64(mean, dev), w=_f64(w, dev),
        slack=int(slack), slack_angle=float(slack_angle))


def pmuse_arrays_from_numpy(*, h_dense, mean, w, pair_r1, pair_r2, pair_off,
                            device=None) -> PmuSeArrays:
    """``PmuSeArrays`` on ``device`` (default ``config.device``) from the
    numpy fields of a ``PmuSeArrays`` (``h_dense`` may already be a tensor
    on that device); the pair indices become int64."""
    dev = resolve_device(device)

    def i64(a):
        return torch.tensor(np.asarray(a, dtype=np.int64), device=dev)

    return PmuSeArrays(
        h_dense=_f64(h_dense, dev), mean=_f64(mean, dev), w=_f64(w, dev),
        pair_r1=i64(pair_r1), pair_r2=i64(pair_r2),
        pair_off=_f64(pair_off, dev))


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
