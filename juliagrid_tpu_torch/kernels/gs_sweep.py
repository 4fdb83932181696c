"""K4 ``gs_sweep``: a whole Gauss-Seidel solve in one launch.

One launch computes, for one state of n buses, what
``juliagrid_tpu/powerflow/gauss_seidel.py`` computes in ``_gs_solve``
(:167-187) with ``_gs_sweep`` (:97) and ``_gs_mismatch`` (:145): the
mismatch maxima (max|dP| over PQ and PV buses, max|dQ| over PQ buses) at the
input state, then, while they are not both under ``tol`` and fewer than
``max_sweeps`` sweeps are done, a sweep (the PQ pass, the PV pass and the PV
magnitude reprojection) and the maxima again. ``max_sweeps=0`` is the
mismatch alone; ``max_sweeps=k`` with ``tol=0`` exactly k sweeps. The CUDA
source, its mapping (the level schedule of ``GsArrays`` walked in one
thread-block cluster) and what bounds it are described in
``csrc/gs_sweep.cu``.

``gs_sweep`` dispatches on the device of its tensors: a CUDA tensor goes to
the kernel (and the call raises if the kernel does not build or launch, or
if the grid does not fit a cluster's shared memory), a CPU tensor to
``gs_sweep_ref``, the plain PyTorch transcription of the jnp code.
``gs_sweep.launches`` counts kernel launches.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from . import _build
from ._build import F64, I64, INT, PTR

#: warps of one block of K4 (``kWarps`` in csrc/gs_sweep.cu)
WARPS = 16
#: blocks of the largest cluster K4 launches (``kMaxCluster``)
MAX_CLUSTER = 16
#: bytes a bus takes in shared memory: its (re, im) pair
BUS_BYTES = 16


class GsSweep(NamedTuple):
    """K4 outputs."""

    vre: torch.Tensor   # f64[n] real part of the voltage
    vim: torch.Tensor   # f64[n] imaginary part
    info: torch.Tensor  # f64[4] max|dP|, max|dQ|, sweeps done, converged

    @property
    def mismatch(self) -> torch.Tensor:
        """f64[2] max|dP| (PQ and PV), max|dQ| (PQ) at the returned state."""
        return self.info[:2]


def _check_inputs(arr, vre, vim, max_sweeps):
    n = arr.bus_type.numel()
    for name, t in (("vre", vre), ("vim", vim)):
        if t.shape != (n,):
            raise ValueError(f"{name} must have shape [{n}], got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != arr.nb.device:
            raise ValueError(f"{name} is on {t.device}, the network on "
                             f"{arr.nb.device}")
    if n < 1:
        raise ValueError("empty grid")
    if max_sweeps < 0:
        raise ValueError(f"max_sweeps must be >= 0, got {max_sweeps}")


def gs_sweep(arr, vre, vim, max_sweeps: int = 1,
             tol: float = 0.0) -> GsSweep:
    """Gauss-Seidel from ``(vre, vim)`` on the network ``arr``
    (``GsArrays``): the mismatch, then sweeps and mismatches until both
    maxima are under ``tol`` or ``max_sweeps`` sweeps are done. Returns the
    state as fresh tensors and ``info``."""
    _check_inputs(arr, vre, vim, max_sweeps)
    if vre.device.type == "cpu":
        return gs_sweep_ref(arr, vre, vim, max_sweeps, tol)
    if vre.device.type != "cuda":
        raise ValueError(f"gs_sweep runs on cuda or cpu tensors, not "
                         f"{vre.device}")
    return _launch(arr, vre, vim, max_sweeps, tol)


gs_sweep.launches = 0


def cluster_layout(n: int, widest: int, levels: int, room: int,
                   cluster: int | None = None,
                   distributed: bool | None = None):
    """``(cluster, distributed)`` for a grid of ``n`` buses whose widest
    level has ``widest`` buses, on a device where a block takes ``room``
    bytes of shared memory. The voltage is replicated in every block while
    it fits one (with the ``levels + 1`` level offsets), else split over
    the cluster's blocks. The cluster has a warp for each bus of the widest
    level, up to ``MAX_CLUSTER`` blocks, and as many blocks as the split
    voltage needs. Raises above the cap: ``MAX_CLUSTER`` blocks full of
    voltage."""
    free = room - 4 * (levels + 1)
    if distributed is None:
        distributed = BUS_BYTES * n > free
    if cluster is None:
        cluster = min(MAX_CLUSTER, max(1, math.ceil(widest / WARPS)))
        if distributed:
            need = math.ceil(BUS_BYTES * n / max(free, 1))
            cluster = max(cluster, min(MAX_CLUSTER, need))
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"a K4 cluster has 1 to {MAX_CLUSTER} blocks, "
                         f"not {cluster}")
    held = math.ceil(n / cluster) if distributed else n
    if BUS_BYTES * held > free:
        cap = MAX_CLUSTER * (free // BUS_BYTES)
        raise ValueError(
            f"K4 holds the voltage in the shared memory of one cluster of "
            f"at most {MAX_CLUSTER} blocks ({room} bytes a block): at most "
            f"{cap} buses, this grid has {n}")
    return cluster, bool(distributed)


LIBRARY = _build.Library(
    "gs_sweep",
    gs_sweep_launch=(INT, [PTR] * 13 + [INT] * 9 + [F64] + [PTR] * 5
                     + [INT, PTR]),
    gs_sweep_room=(I64, [INT]))


@functools.lru_cache(maxsize=256)
def _layout(device: int, n: int, widest: int, levels: int,
            cluster: int | None, distributed: bool | None):
    """``cluster_layout`` on ``device``, whose room is queried once."""
    room = LIBRARY.load().gs_sweep_room(device)
    if room <= 0:
        raise RuntimeError(f"gs_sweep cannot query cuda:{device}")
    return cluster_layout(n, widest, levels, room, cluster, distributed)


def _launch(arr, vre, vim, max_sweeps, tol, cluster=None,
            distributed=None) -> GsSweep:
    """One K4 launch (``_build.Library.launch``). ``arr`` holds contiguous
    int32 and float64 tensors, as ``gs_arrays_from_numpy`` builds them; the
    layout is ``cluster_layout``'s unless ``cluster`` or ``distributed`` is
    given (any layout gives the same bits)."""
    n, width = arr.nb.shape
    lpq, lpv = arr.pq_ptr.numel() - 1, arr.pv_ptr.numel() - 1
    device = vre.device
    cluster, distributed = _layout(device.index, n, arr.widest, lpq + lpv,
                                   cluster, distributed)
    vre, vim = vre.contiguous(), vim.contiguous()
    vre_out, vim_out, info = torch.empty(
        2 * n + 4, dtype=torch.float64, device=device).split([n, n, 4])
    LIBRARY.launch(
        "gs_sweep_launch", device, arr.nb.data_ptr(), arr.yre.data_ptr(),
        arr.yim.data_ptr(), arr.dre.data_ptr(), arr.dim.data_ptr(),
        arr.bus_type.data_ptr(), arr.p_sched.data_ptr(),
        arr.q_sched.data_ptr(), arr.vg.data_ptr(), arr.pq_order.data_ptr(),
        arr.pq_ptr.data_ptr(), arr.pv_order.data_ptr(),
        arr.pv_ptr.data_ptr(), n, width, arr.pq_order.numel(),
        arr.pv_order.numel(), lpq, lpv, cluster, int(distributed),
        int(max_sweeps), float(tol), vre.data_ptr(), vim.data_ptr(),
        vre_out.data_ptr(), vim_out.data_ptr(), info.data_ptr(),
        device.index)
    gs_sweep.launches += 1
    return GsSweep(vre_out, vim_out, info)


def _cdiv(ar, ai, br, bi):
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _row_current(arr, i, vre, vim):
    """I_i = sum_j Y_ij V_j over the padded neighbour row."""
    nb = arr.nb[i]
    yr = arr.yre[i]
    yi = arr.yim[i]
    vr = vre[nb]
    vi = vim[nb]
    return torch.sum(yr * vr - yi * vi), torch.sum(yr * vi + yi * vr)


def _sweep_ref(arr, vre, vim):
    """One sweep of ``_gs_sweep`` (gauss_seidel.py:97-142), a Python loop
    over the ascending PQ and PV bus lists, in place on ``vre, vim``."""
    for i in arr.pq.tolist():
        # I = S*/conj(V) - sum Y V ;  V += I / Y_ii
        cr, ci = _cdiv(arr.p_sched[i], -arr.q_sched[i], vre[i], -vim[i])
        ire, iim = _row_current(arr, i, vre, vim)
        dr, di = _cdiv(cr - ire, ci - iim, arr.dre[i], arr.dim[i])
        vre[i] += dr
        vim[i] += di
    for i in arr.pv.tolist():
        ire, iim = _row_current(arr, i, vre, vim)
        # Q = Im(conj(V) I)
        q = vre[i] * iim - vim[i] * ire
        cr, ci = _cdiv(arr.p_sched[i], q, vre[i], -vim[i])
        dr, di = _cdiv(cr - ire, ci - iim, arr.dre[i], arr.dim[i])
        vre[i] += dr
        vim[i] += di
    # PV magnitude re-projection to the generator setpoint
    mag = torch.sqrt(vre**2 + vim**2)
    scale = torch.where(arr.bus_type == 2, arr.vg / mag, 1.0)
    return vre * scale, vim * scale


def _mismatch_ref(arr, vre, vim):
    """``_gs_mismatch`` (gauss_seidel.py:145-160): f64[2]."""
    vr = vre[arr.nb]
    vi = vim[arr.nb]
    ire = torch.sum(arr.yre * vr - arr.yim * vi, dim=1)
    iim = torch.sum(arr.yre * vi + arr.yim * vr, dim=1)
    p = vre * ire + vim * iim
    q = vim * ire - vre * iim
    is_pq = arr.bus_type == 1
    mp = torch.where(is_pq | (arr.bus_type == 2), p - arr.p_sched, 0.0)
    mq = torch.where(is_pq, q - arr.q_sched, 0.0)
    return torch.stack([mp.abs().amax(), mq.abs().amax()])


def gs_sweep_ref(arr, vre, vim, max_sweeps: int = 1,
                 tol: float = 0.0) -> GsSweep:
    """Plain PyTorch K4: a direct transcription of ``_gs_solve``'s loop
    over ``_gs_sweep`` and ``_gs_mismatch`` (gauss_seidel.py:80-187), each
    sweep a Python loop over the ascending PQ and PV bus lists with tensor
    operations per bus. The CPU path, and the check K4 is held to on the
    card."""
    vre, vim = vre.clone(), vim.clone()
    mis = _mismatch_ref(arr, vre, vim)
    it = 0
    while not bool((mis < tol).all()) and it < max_sweeps:
        vre, vim = _sweep_ref(arr, vre, vim)
        mis = _mismatch_ref(arr, vre, vim)
        it += 1
    converged = float(bool((mis < tol).all()))
    return GsSweep(vre, vim, torch.cat([mis, mis.new_tensor([it, converged])]))
