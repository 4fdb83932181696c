"""K4 ``gs_sweep``: one Gauss-Seidel sweep and its mismatch.

One launch computes, for one state of n buses, what
``juliagrid_tpu/powerflow/gauss_seidel.py`` computes in ``_gs_sweep`` (:97)
and ``_gs_mismatch`` (:145): with ``sweep=True`` the PQ pass, the PV pass
and the PV magnitude reprojection, in ascending bus order; always the
mismatch maxima (max|dP| over PQ and PV buses, max|dQ| over PQ buses) at the
resulting state. The CUDA source, its mapping and what bounds it are
described in ``csrc/gs_sweep.cu``.

``gs_sweep`` dispatches on the device of its tensors: a CUDA tensor goes to
the kernel (and the call raises if the kernel does not build or launch, or
if the grid does not fit its shared memory), a CPU tensor to
``gs_sweep_ref``, the plain PyTorch transcription of the jnp code.
``gs_sweep.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

#: the padded row width K4 takes (``GsArrays.nb.shape[1]``): its lanes hold
#: four entries each of a bus row
MAX_ROW = 128


class GsSweep(NamedTuple):
    """K4 outputs."""

    vre: torch.Tensor       # f64[n] real part of the voltage
    vim: torch.Tensor       # f64[n] imaginary part
    mismatch: torch.Tensor  # f64[2] max|dP| (PQ and PV), max|dQ| (PQ)


def _check_inputs(arr, vre, vim):
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


def gs_sweep(arr, vre, vim, sweep: bool = True) -> GsSweep:
    """With ``sweep``, one Gauss-Seidel iteration from ``(vre, vim)`` on the
    network ``arr`` (``GsArrays``); the state itself otherwise. Returns the
    new state as fresh tensors, and the mismatch maxima at it."""
    _check_inputs(arr, vre, vim)
    if vre.device.type == "cpu":
        return gs_sweep_ref(arr, vre, vim, sweep)
    if vre.device.type != "cuda":
        raise ValueError(f"gs_sweep runs on cuda or cpu tensors, not "
                         f"{vre.device}")
    return _launch(arr, vre, vim, sweep)


gs_sweep.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("gs_sweep")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gs_sweep_launch.argtypes = (
        [ptr] * 9 + [ptr] * 2 + [i32, i32, i32, i32, i32]
        + [ptr] * 5 + [i32, ptr])
    lib.gs_sweep_launch.restype = i32
    lib.gs_sweep_max_buses.argtypes = [i32]
    lib.gs_sweep_max_buses.restype = i32
    lib.gs_sweep_error_string.argtypes = [i32]
    lib.gs_sweep_error_string.restype = ctypes.c_char_p
    return lib


def _launch(arr, vre, vim, sweep: bool) -> GsSweep:
    for name in ("nb", "bus_type", "pq", "pv"):
        t = getattr(arr, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"GsArrays.{name} must be contiguous int32")
    for name in ("yre", "yim", "dre", "dim", "p_sched", "q_sched", "vg"):
        t = getattr(arr, name)
        if t.dtype != torch.float64 or not t.is_contiguous():
            raise TypeError(f"GsArrays.{name} must be contiguous float64")
    n, width = arr.nb.shape
    if width > MAX_ROW:
        raise ValueError(f"K4 takes bus rows of at most {MAX_ROW} Y-bus "
                         f"entries; this grid has {width}")
    lib = _library()
    device = vre.device
    max_buses = lib.gs_sweep_max_buses(device.index or 0)
    if n > max_buses:
        raise ValueError(
            f"K4 holds the voltage in shared memory: at most {max_buses} "
            f"buses on {torch.cuda.get_device_name(device)}, this grid has "
            f"{n}")
    vre, vim = vre.contiguous(), vim.contiguous()
    out = torch.empty((2, n), dtype=torch.float64, device=device)
    vre_out, vim_out = out.unbind(0)
    mismatch = torch.empty(2, dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.gs_sweep_launch(
            arr.nb.data_ptr(), arr.yre.data_ptr(), arr.yim.data_ptr(),
            arr.dre.data_ptr(), arr.dim.data_ptr(), arr.bus_type.data_ptr(),
            arr.p_sched.data_ptr(), arr.q_sched.data_ptr(),
            arr.vg.data_ptr(), arr.pq.data_ptr(), arr.pv.data_ptr(),
            n, width, arr.pq.numel(), arr.pv.numel(), int(sweep),
            vre.data_ptr(), vim.data_ptr(), vre_out.data_ptr(),
            vim_out.data_ptr(), mismatch.data_ptr(), device.index or 0,
            stream)
    if err != 0:
        raise RuntimeError("gs_sweep launch failed: "
                           + lib.gs_sweep_error_string(err).decode())
    gs_sweep.launches += 1
    return GsSweep(vre_out, vim_out, mismatch)


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


def gs_sweep_ref(arr, vre, vim, sweep: bool = True) -> GsSweep:
    """Plain PyTorch K4: a direct transcription of ``_gs_sweep`` and
    ``_gs_mismatch`` (gauss_seidel.py:80-160), a Python loop over the
    ascending PQ and PV bus lists with tensor operations per bus. The CPU
    path, and the check K4 is held to on the card."""
    vre, vim = vre.clone(), vim.clone()
    if sweep:
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
        vre, vim = vre * scale, vim * scale

    vr = vre[arr.nb]
    vi = vim[arr.nb]
    ire = torch.sum(arr.yre * vr - arr.yim * vi, dim=1)
    iim = torch.sum(arr.yre * vi + arr.yim * vr, dim=1)
    p = vre * ire + vim * iim
    q = vim * ire - vre * iim
    is_pq = arr.bus_type == 1
    mp = torch.where(is_pq | (arr.bus_type == 2), p - arr.p_sched, 0.0)
    mq = torch.where(is_pq, q - arr.q_sched, 0.0)
    return GsSweep(vre, vim, torch.stack([mp.abs().amax(), mq.abs().amax()]))
