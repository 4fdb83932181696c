"""DC state estimation (linear WLS) on PyTorch tensors.

Port of ``juliagrid_tpu/estimation/dcse.py`` (after JuliaGrid
src/stateEstimation/dcStateEstimation.jl:44-153, the constructor, and
:342-435, the Normal/Orthogonal solves). Rows: wattmeter injections (the
nodal B row, mean adjusted by the shift power and the shunt conductance),
wattmeter flows (± the branch admittance, mean adjusted by the shift-angle
power), PMU bus angles (identity, mean relative to the slack angle).

The JAX package fills a dense H row by row on the host, from a dense copy
of B. The port collects the same entries as COO on the host
(``_dcse_host``) and scatters them into the dense f64 H on the analysis
device (``ops/linalg.py::dense_from_coo``); on the CPU the result equals the
JAX package's H bit for bit. The solve is one f64 gain ``(W½Hm)ᵀ(W½Hm)``
(one ``torch.matmul``, the slack column masked) and an LU, or a QR of the
stacked ``[W½Hm; e_s]``. There is no iteration.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..ops import linalg
from ..powerflow.dc import Angle
from ..system.model import model
from ..system.types import PowerSystem


class DcSeArrays(NamedTuple):
    """Device snapshot of the DC measurement model."""

    h_dense: torch.Tensor  # f64[m, n] coefficient matrix
    mean: torch.Tensor     # f64[m]
    w: torch.Tensor        # f64[m]
    slack: int             # slack bus (host int: no device readback)
    slack_angle: float     # stored angle of the slack bus


class DcSeHost(NamedTuple):
    """The DC measurement rows on the host: H as COO entries."""

    rows: np.ndarray        # i64 COO row of each H entry
    cols: np.ndarray        # i64 COO column
    vals: np.ndarray        # f64 value
    shape: tuple            # (m, n)
    mean: np.ndarray        # f64[m]
    w: np.ndarray           # f64[m]
    row_device: list        # ("wattmeter", i) or ("pmu", i) per row
    inservice: int
    slack: int
    slack_angle: float


@dataclass
class DcSeMethod:
    name: str
    factorization: str = linalg.LU
    iteration: int = 0
    converged: bool = False
    inservice: int = 0
    residual: Optional[np.ndarray] = None
    #: the arrays' device H itself, not a host copy (4 GB at 10k buses)
    jacobian: Optional[torch.Tensor] = None
    precision_diag: Optional[np.ndarray] = None
    mean: Optional[np.ndarray] = None
    #: device index per row: ("wattmeter", i) or ("pmu", i)
    row_device: Optional[list] = None


@dataclass
class DcStateEstimation:
    system: PowerSystem
    monitoring: object
    voltage: Angle
    method: DcSeMethod
    arrays: DcSeArrays
    device: torch.device
    power: Optional[object] = None
    kind: str = "state_estimation"
    signature: dict = field(default_factory=dict)

    def _refresh_arrays(self):
        rev = self.system.model.revision
        mrev = self.monitoring.revision
        sig = self.signature
        if (sig.get("dc_model") != rev.dc_model
                or sig.get("measurement") != mrev.measurement
                or sig.get("meas_values") != mrev.values
                or sig.get("slack") != rev.slack):
            self.arrays, self.method.row_device, self.method.inservice = \
                compile_dcse_arrays(self.system, self.monitoring,
                                    device=self.device)
            sig.update(dc_model=rev.dc_model, measurement=mrev.measurement,
                       meas_values=mrev.values, slack=rev.slack)


def _dcse_host(system: PowerSystem, monitoring) -> DcSeHost:
    """The rows of the JAX package's ``compile_dcse_arrays`` (its :91-130),
    with H as COO entries: wattmeters in order, then the bus PMUs."""
    model(system, "dc")
    n = system.bus.number
    dc = system.model.dc
    bus = system.bus
    watt, pmu = monitoring.wattmeter, monitoring.pmu
    nw = watt.number

    k = watt.layout.index.array[:nw].astype(np.int64)
    st = watt.active.status.array[:nw].astype(np.int64)
    is_bus = watt.layout.bus.array[:nw].astype(bool)
    z = watt.active.mean.array[:nw]
    mean = np.empty(nw)
    rows, cols, vals = [], [], []

    # injection rows: the nodal row of B times the status
    rb = np.flatnonzero(is_bus)
    kb = k[rb]
    mean[rb] = st[rb] * (z[rb] - dc.shift_power[kb]
                         - bus.shunt.conductance.array[:n][kb])
    nodal = dc.nodal.tocsr()
    lens = np.diff(nodal.indptr)[kb]
    pos = np.repeat(nodal.indptr[kb] - np.cumsum(lens) + lens, lens) \
        + np.arange(lens.sum())
    rows.append(np.repeat(rb, lens))
    cols.append(nodal.indices[pos].astype(np.int64))
    vals.append(np.repeat(st[rb], lens) * nodal.data[pos])

    # flow rows: +adm at the from-bus, -adm at the to-bus
    rf = np.flatnonzero(~is_bus)
    kf = k[rf]
    adm = np.where(watt.layout.from_.array[:nw][rf].astype(bool),
                   dc.admittance[kf], -dc.admittance[kf]) * st[rf]
    mean[rf] = st[rf] * (
        z[rf] + system.branch.parameter.shift_angle.array[kf] * adm)
    rows += [rf, rf]
    cols += [system.branch.layout.from_bus.array[kf].astype(np.int64),
             system.branch.layout.to_bus.array[kf].astype(np.int64)]
    vals += [adm, -adm]

    # PMU bus-angle rows, relative to the slack angle
    slack = int(bus.layout.slack)
    slack_angle = float(bus.voltage.angle[slack])
    npmu = pmu.number
    ip = np.flatnonzero(pmu.layout.bus.array[:npmu].astype(bool))
    st_p = pmu.angle.status.array[:npmu][ip].astype(np.int64)
    rp = nw + np.arange(len(ip))
    rows.append(rp)
    cols.append(pmu.layout.index.array[:npmu][ip].astype(np.int64))
    vals.append(st_p.astype(np.float64))

    m = nw + len(ip)
    return DcSeHost(
        rows=np.concatenate(rows), cols=np.concatenate(cols),
        vals=np.concatenate(vals), shape=(m, n),
        mean=np.concatenate(
            [mean, st_p * (pmu.angle.mean.array[:npmu][ip] - slack_angle)]),
        w=np.concatenate([1.0 / watt.active.variance.array[:nw],
                          1.0 / pmu.angle.variance.array[:npmu][ip]]),
        row_device=([("wattmeter", i) for i in range(nw)]
                    + [("pmu", int(i)) for i in ip]),
        inservice=int(st.sum() + st_p.sum()), slack=slack,
        slack_angle=slack_angle)


def compile_dcse_arrays(system: PowerSystem, monitoring, device=None):
    """``(DcSeArrays, row_device, inservice)`` on ``device`` (default
    ``config.device``): the host rows of ``_dcse_host`` with H scattered on
    the device."""
    # convert.py builds DcSeArrays from numpy and imports this module
    from ..convert import dcse_arrays_from_numpy

    dev = resolve_device(device)
    host = _dcse_host(system, monitoring)
    arr = dcse_arrays_from_numpy(
        h_dense=linalg.dense_from_coo(host.rows, host.cols, host.vals,
                                      host.shape, dev),
        mean=host.mean, w=host.w, slack=host.slack,
        slack_angle=host.slack_angle, device=dev)
    return arr, host.row_device, host.inservice


def _col_mask(arr: DcSeArrays) -> torch.Tensor:
    """1 on every bus but the slack."""
    mask = torch.ones(arr.h_dense.shape[1], dtype=torch.float64,
                      device=arr.h_dense.device)
    mask[arr.slack] = 0.0
    return mask


def _dcse_weighted(arr: DcSeArrays):
    """``W½Hm`` (H with the slack column masked, a new tensor) and
    ``W½z``."""
    sw = arr.w.sqrt()
    a = arr.h_dense * sw[:, None]
    a.mul_(_col_mask(arr))
    return a, sw * arr.mean


def _dcse_normal_equations(a: torch.Tensor, b: torch.Tensor, slack: int):
    """The gain ``aᵀa + e_s e_sᵀ`` (one matmul) and the right-hand side
    ``aᵀb`` for ``a = W½Hm``, ``b = W½z``."""
    gain = a.mT @ a
    gain[slack, slack] += 1.0
    return gain, a.mT @ b


def _dcse_solve(arr: DcSeArrays, kind: str) -> torch.Tensor:
    """Bus angles: LU of the normal equations, or QR of ``[W½Hm; e_s]``."""
    a, b = _dcse_weighted(arr)
    if kind == linalg.QR:
        e = torch.zeros((1, a.shape[1]), dtype=a.dtype, device=a.device)
        e[0, arr.slack] = 1.0
        theta = linalg.solve(linalg.factorize(torch.cat([a, e]), linalg.QR),
                             torch.cat([b, b.new_zeros(1)]))
    else:
        gain, rhs = _dcse_normal_equations(a, b, arr.slack)
        del a
        theta = linalg.solve(linalg.factorize(gain, linalg.LU), rhs)
    return theta * _col_mask(arr) + arr.slack_angle


def _dc_residual(arr: DcSeArrays, theta: torch.Tensor) -> torch.Tensor:
    """``r = z - H(θ - θ_slack)``: the PMU angle rows' means are relative
    to the slack angle, and the wattmeter rows do not see a uniform
    shift."""
    return arr.mean - arr.h_dense @ (theta - arr.slack_angle)


def dc_state_estimation(monitoring, factorization: str = linalg.LU,
                        device=None) -> DcStateEstimation:
    """Reference dcStateEstimation (dcStateEstimation.jl:44-66), on
    ``device`` (default ``config.device``)."""
    device = resolve_device(device)
    system = monitoring.system
    system.check_slack()
    model(system, "dc")
    arr, row_device, inservice = compile_dcse_arrays(system, monitoring,
                                                     device=device)
    rev = system.model.revision
    method = DcSeMethod("dc_wls", factorization)
    method.row_device = row_device
    method.inservice = inservice
    return DcStateEstimation(
        system=system, monitoring=monitoring,
        voltage=Angle(np.zeros(system.bus.number)),
        method=method, arrays=arr, device=device,
        signature={"dc_model": rev.dc_model,
                   "measurement": monitoring.revision.measurement,
                   "meas_values": monitoring.revision.values,
                   "slack": rev.slack},
    )


def dc_se_solve(analysis: DcStateEstimation, power: bool = False):
    """One DC WLS solve (reference solve! for DC state estimation)."""
    analysis._refresh_arrays()
    arr = analysis.arrays
    kind = linalg.QR if analysis.method.factorization == linalg.QR \
        else linalg.LU
    theta = _dcse_solve(arr, kind)
    analysis.voltage.angle = theta.cpu().numpy()
    method = analysis.method
    method.converged = True
    method.residual = _dc_residual(arr, theta).cpu().numpy()
    method.jacobian = arr.h_dense
    method.precision_diag = arr.w.cpu().numpy()
    method.mean = arr.mean.cpu().numpy()
    if power:
        from ..postprocessing.dc import power as dc_power
        dc_power(analysis)
    return analysis
