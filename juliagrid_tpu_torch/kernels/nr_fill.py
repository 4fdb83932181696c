"""K1 ``nr_fill``: Newton-Raphson injections, mismatch and Jacobian fill.

One launch computes, for B >= 1 scenarios of one network, what
``juliagrid_tpu/powerflow/ac.py`` computes in ``_injections`` (:92),
``_mismatch`` (:111) and ``_nr_jacobian`` (:125): per-bus P and Q, the
masked mismatch, and optionally the dense masked 2n x 2n polar Jacobian.
The CUDA source, its mapping and what bounds it are described in
``csrc/nr_fill.cu``.

``nr_fill`` dispatches on the device of its tensors: a CUDA tensor goes to
the kernel (and the call raises if the kernel does not build or launch), a
CPU tensor to ``nr_fill_ref``, the plain PyTorch transcription of the same
jnp code. ``nr_fill.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import _build


class NrFill(NamedTuple):
    """K1 outputs; every tensor has the leading scenario axis B."""

    p: torch.Tensor    # f64[B, n] active injection
    q: torch.Tensor    # f64[B, n] reactive injection
    mp: torch.Tensor   # f64[B, n] p - p_sched, zero at the slack
    mq: torch.Tensor   # f64[B, n] q - q_sched, zero off PQ buses
    jac: Optional[torch.Tensor]  # f64[B, 2n, 2n] masked Jacobian, or None


def _check_inputs(arr, vm, va, p_sched, q_sched):
    n = arr.row_ptr.numel() - 1
    for name, t in (("vm", vm), ("va", va), ("p_sched", p_sched),
                    ("q_sched", q_sched)):
        if t.dim() != 2 or t.shape[1] != n or t.shape != vm.shape:
            raise ValueError(f"{name} must have shape [B, {n}] like vm, "
                             f"got {tuple(t.shape)}")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != arr.cols.device:
            raise ValueError(f"{name} is on {t.device}, the network on "
                             f"{arr.cols.device}")
    if vm.shape[0] < 1 or n < 1:
        raise ValueError(f"empty input of shape {tuple(vm.shape)}")


def nr_fill(arr, vm, va, p_sched, q_sched, jacobian: bool = False) -> NrFill:
    """Injections, masked mismatch and (``jacobian=True``) the masked
    Jacobian for the ``[B, n]`` states ``vm``/``va`` and schedules
    ``p_sched``/``q_sched`` on the network ``arr`` (``AcArrays``)."""
    _check_inputs(arr, vm, va, p_sched, q_sched)
    if vm.device.type == "cpu":
        return nr_fill_ref(arr, vm, va, p_sched, q_sched, jacobian)
    if vm.device.type != "cuda":
        raise ValueError(f"nr_fill runs on cuda or cpu tensors, not "
                         f"{vm.device}")
    return _launch(arr, vm, va, p_sched, q_sched, jacobian)


nr_fill.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("nr_fill")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nr_fill_launch.argtypes = (
        [ptr] * 6 + [i32] + [ptr] * 4 + [ptr] * 5 + [i32, i32, ptr])
    lib.nr_fill_launch.restype = i32
    lib.nr_fill_error_string.argtypes = [i32]
    lib.nr_fill_error_string.restype = ctypes.c_char_p
    return lib


def _launch(arr, vm, va, p_sched, q_sched, jacobian: bool) -> NrFill:
    for name in ("row_ptr", "cols", "diag", "bus_type"):
        t = getattr(arr, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"AcArrays.{name} must be contiguous int32")
    for name in ("yg", "yb"):
        t = getattr(arr, name)
        if t.dtype != torch.float64 or not t.is_contiguous():
            raise TypeError(f"AcArrays.{name} must be contiguous float64")
    vm, va, p_sched, q_sched = (t.contiguous()
                                for t in (vm, va, p_sched, q_sched))
    batch, n = vm.shape
    lib = _library()
    out = torch.empty((4, batch, n), dtype=torch.float64, device=vm.device)
    p, q, mp, mq = out.unbind(0)
    jac = (torch.empty((batch, 2 * n, 2 * n), dtype=torch.float64,
                       device=vm.device) if jacobian else None)
    with torch.cuda.device(vm.device):
        stream = torch.cuda.current_stream(vm.device).cuda_stream
        err = lib.nr_fill_launch(
            arr.row_ptr.data_ptr(), arr.cols.data_ptr(), arr.yg.data_ptr(),
            arr.yb.data_ptr(), arr.diag.data_ptr(), arr.bus_type.data_ptr(),
            int(arr.slack), vm.data_ptr(), va.data_ptr(),
            p_sched.data_ptr(), q_sched.data_ptr(), p.data_ptr(),
            q.data_ptr(), mp.data_ptr(), mq.data_ptr(),
            None if jac is None else jac.data_ptr(), n, batch, stream)
    if err != 0:
        raise RuntimeError("nr_fill launch failed: "
                           + lib.nr_fill_error_string(err).decode())
    nr_fill.launches += 1
    return NrFill(p, q, mp, mq, jac)


def nr_fill_ref(arr, vm, va, p_sched, q_sched,
                jacobian: bool = False) -> NrFill:
    """Plain PyTorch K1: a direct transcription of ac.py:92-162 with a
    leading scenario axis (gathers, ``index_add_`` segment sums, masked
    scatters). The CPU path, and the check K1 is held to on the card."""
    batch, n = vm.shape
    rows = arr.rows.long()
    cols = arr.cols.long()
    vi = vm[:, rows]
    vj = vm[:, cols]
    th = va[:, rows] - va[:, cols]
    sin_t = torch.sin(th)
    cos_t = torch.cos(th)
    gc_bs = arr.yg * cos_t + arr.yb * sin_t    # G cos + B sin
    gs_bc = arr.yg * sin_t - arr.yb * cos_t    # G sin - B cos
    vv = vi * vj
    zeros = torch.zeros((batch, n), dtype=vm.dtype, device=vm.device)
    p = zeros.index_add(1, rows, vv * gc_bs)
    q = zeros.index_add(1, rows, vv * gs_bc)
    i = torch.arange(n, device=vm.device)
    not_slack = i != arr.slack
    is_pq = arr.bus_type == 1
    mp = torch.where(not_slack, p - p_sched, 0.0)
    mq = torch.where(is_pq, q - q_sched, 0.0)
    if not jacobian:
        return NrFill(p, q, mp, mq, None)

    off = rows != cols
    h = torch.where(off, vv * gs_bc, 0.0)        # dP/dθj
    nn = torch.where(off, vi * gc_bs, 0.0)       # dP/dVj
    jj = torch.where(off, -vv * gc_bs, 0.0)      # dQ/dθj
    ll = torch.where(off, vi * gs_bc, 0.0)       # dQ/dVj

    n2 = 2 * n
    jac = torch.zeros((batch, n2 * n2), dtype=vm.dtype, device=vm.device)
    jac.index_add_(1, rows * n2 + cols, h)
    jac.index_add_(1, rows * n2 + n + cols, nn)
    jac.index_add_(1, (n + rows) * n2 + cols, jj)
    jac.index_add_(1, (n + rows) * n2 + n + cols, ll)

    diag = arr.diag.long()
    gii = arr.yg[diag]
    bii = arr.yb[diag]
    jac.index_add_(1, i * n2 + i, -q - bii * vm**2)
    jac.index_add_(1, i * n2 + n + i, p / vm + gii * vm)
    jac.index_add_(1, (n + i) * n2 + i, p - gii * vm**2)
    jac.index_add_(1, (n + i) * n2 + n + i, q / vm - bii * vm)
    jac = jac.view(batch, n2, n2)

    # slack-angle and non-PQ-magnitude rows/cols -> identity (ac.py:158-161)
    m = torch.cat([not_slack, is_pq]).to(vm.dtype)
    jac = m[:, None] * jac * m[None, :] + torch.diag(1.0 - m)
    return NrFill(p, q, mp, mq, jac)
