"""K1 ``nr_fill``: Newton-Raphson injections, mismatch and Jacobian fill.

One launch computes, for B >= 1 scenarios of one network, what
``juliagrid_tpu/powerflow/ac.py`` computes in ``_injections`` (:92),
``_mismatch`` (:111) and ``_nr_jacobian`` (:125): per-bus P and Q, the
masked mismatch, and optionally the dense polar Jacobian at the Newton
system's order N = npv + 2·npq (``AcArrays.pos`` gives each variable's row
and column, -1 for a fixed one; the JAX package's 2n x 2n masked layout is
``powerflow/ac.py::_masked_jacobian``). The CUDA source, its mapping and
what bounds it are described in ``csrc/nr_fill.cu``.

``nr_fill`` dispatches on the device of its tensors: a CUDA tensor goes to
the kernel (and the call raises if the kernel does not build or launch), a
CPU tensor to ``nr_fill_ref``, the plain PyTorch transcription of the same
jnp code. ``nr_fill.launches`` counts kernel launches.

``nr_fill_routed`` is K1's routed mode for the BBD Newton-Raphson
(``powerflow/newton_bbd.py``): one state, and instead of the dense Jacobian
one flat buffer of the interior, coupling and border blocks, written at the
offsets of an ``NrRoute`` that ``compile_nr_bbd`` builds and checks once on
the host. It dispatches the same way, to ``nr_fill_routed_ref`` on the CPU,
and counts its own launches in ``nr_fill_routed.launches``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from ._build import I64, INT, PTR


class NrFill(NamedTuple):
    """K1 outputs; every tensor has the leading scenario axis B."""

    p: torch.Tensor    # f64[B, n] active injection
    q: torch.Tensor    # f64[B, n] reactive injection
    mp: torch.Tensor   # f64[B, n] p - p_sched, zero at the slack
    mq: torch.Tensor   # f64[B, n] q - q_sched, zero off PQ buses
    jac: Optional[torch.Tensor]  # f64[B, N, N] Jacobian over the
                                 # unknowns (AcArrays.pos), or None


class NrRoute(NamedTuple):
    """Where K1's routed mode writes: ``off[q, k]`` is the flat-buffer
    offset of quadrant ``q`` (H, N, J, L) of Y entry ``k`` (-1: drop), and
    ``ones`` the positions set to 1.0 (masked and padded variables)."""

    off: torch.Tensor   # i64[4, nnz]
    ones: torch.Tensor  # i64[n_ones]
    size: int           # length of the flat buffer


class NrFillRouted(NamedTuple):
    """K1 routed outputs for one state."""

    p: torch.Tensor    # f64[n]
    q: torch.Tensor    # f64[n]
    mp: torch.Tensor   # f64[n] p - p_sched, zero at the slack
    mq: torch.Tensor   # f64[n] q - q_sched, zero off PQ buses
    buf: torch.Tensor  # f64[size] the routed, masked Jacobian blocks


def check_route(off: np.ndarray, ones: np.ndarray, size: int) -> None:
    """Raise unless every non-negative offset and every identity position
    lies in the buffer and no two of them are equal: the guarantee that
    gives each element of the routed buffer one writer."""
    dest = np.concatenate([off[off >= 0], ones])
    if dest.size and (dest.min() < 0 or dest.max() >= size):
        raise ValueError("routed offset outside the buffer")
    if np.unique(dest).size != dest.size:
        raise ValueError("two routed values share one buffer element")


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
    """Injections, masked mismatch and (``jacobian=True``) the Jacobian
    over the unknowns for the ``[B, n]`` states ``vm``/``va`` and schedules
    ``p_sched``/``q_sched`` on the network ``arr`` (``AcArrays``)."""
    _check_inputs(arr, vm, va, p_sched, q_sched)
    if vm.device.type == "cpu":
        return nr_fill_ref(arr, vm, va, p_sched, q_sched, jacobian)
    if vm.device.type != "cuda":
        raise ValueError(f"nr_fill runs on cuda or cpu tensors, not "
                         f"{vm.device}")
    return _launch(arr, vm, va, p_sched, q_sched, jacobian)


nr_fill.launches = 0


LIBRARY = _build.Library(
    "nr_fill",
    nr_fill_launch=(INT, [PTR] * 6 + [INT] + [PTR] * 10 + [INT] * 3 + [PTR]),
    nr_fill_routed_launch=(INT, [PTR] * 6 + [INT] + [PTR] * 9
                           + [I64, PTR, I64, PTR, I64, INT, PTR]))

_NET = dict(row_ptr=torch.int32, cols=torch.int32, yg=torch.float64,
            yb=torch.float64, diag=torch.int32, bus_type=torch.int32)
#: the network's tensors each mode reads, checked once a network (keyed by
#: its ``cols``): the mismatch alone (also fast decoupled's ``FnrArrays``),
#: with the Jacobian (and ``pos``), the routed mode (and the schedules)
_NETWORK = _build.Table("AcArrays", _NET)
_JACOBIAN_NETWORK = _build.Table("AcArrays", dict(_NET, pos=torch.int32))
_ROUTED_NETWORK = _build.Table("AcArrays", dict(
    _NET, p_sched=torch.float64, q_sched=torch.float64))


def _network(table: _build.Table, arr) -> _build.Entry:
    return table.get("cols", {name: getattr(arr, name)
                              for name in table.dtypes})


def _launch(arr, vm, va, p_sched, q_sched, jacobian: bool) -> NrFill:
    _network(_JACOBIAN_NETWORK if jacobian else _NETWORK, arr)
    if jacobian and arr.pos.numel() != 2 * vm.shape[1]:
        raise TypeError("AcArrays.pos must have 2n entries")
    order = arr.order if jacobian else 0
    vm, va, p_sched, q_sched = (t.contiguous()
                                for t in (vm, va, p_sched, q_sched))
    batch, n = vm.shape
    out = torch.empty((4, batch, n), dtype=torch.float64, device=vm.device)
    p, q, mp, mq = out.unbind(0)
    jac = (torch.empty((batch, order, order), dtype=torch.float64,
                       device=vm.device) if jacobian else None)
    LIBRARY.launch(
        "nr_fill_launch", vm.device, arr.row_ptr.data_ptr(),
        arr.cols.data_ptr(), arr.yg.data_ptr(), arr.yb.data_ptr(),
        arr.diag.data_ptr(), arr.bus_type.data_ptr(), int(arr.slack),
        vm.data_ptr(), va.data_ptr(), p_sched.data_ptr(), q_sched.data_ptr(),
        p.data_ptr(), q.data_ptr(), mp.data_ptr(), mq.data_ptr(),
        None if jac is None else jac.data_ptr(),
        arr.pos.data_ptr() if jacobian else None, order, n, batch)
    nr_fill.launches += 1
    return NrFill(p, q, mp, mq, jac)


def nr_fill_routed(arr, route: NrRoute, vm, va) -> NrFillRouted:
    """Injections, masked mismatch and the routed, masked Jacobian blocks
    at the state ``vm``/``va`` (``[n]`` each) of the network ``arr``
    (``AcArrays``)."""
    _check_inputs(arr, vm[None], va[None], arr.p_sched[None],
                  arr.q_sched[None])
    if route.off.shape != (4, arr.cols.numel()):
        raise ValueError(f"route.off must have shape [4, nnz], got "
                         f"{tuple(route.off.shape)}")
    if vm.device.type == "cpu":
        return nr_fill_routed_ref(arr, route, vm, va)
    if vm.device.type != "cuda":
        raise ValueError(f"nr_fill_routed runs on cuda or cpu tensors, not "
                         f"{vm.device}")
    return _launch_routed(arr, route, vm, va)


nr_fill_routed.launches = 0


def _launch_routed(arr, route: NrRoute, vm, va) -> NrFillRouted:
    _network(_ROUTED_NETWORK, arr)
    for name, t in (("off", route.off), ("ones", route.ones)):
        if t.dtype != torch.int64 or not t.is_contiguous() \
                or t.device != vm.device:
            raise TypeError(f"NrRoute.{name} must be contiguous int64 on "
                            f"{vm.device}")
    vm, va = vm.contiguous(), va.contiguous()
    n = vm.shape[0]
    out = torch.empty((4, n), dtype=torch.float64, device=vm.device)
    p, q, mp, mq = out.unbind(0)
    buf = torch.empty(route.size, dtype=torch.float64, device=vm.device)
    LIBRARY.launch(
        "nr_fill_routed_launch", vm.device, arr.row_ptr.data_ptr(),
        arr.cols.data_ptr(), arr.yg.data_ptr(), arr.yb.data_ptr(),
        arr.diag.data_ptr(), arr.bus_type.data_ptr(), int(arr.slack),
        vm.data_ptr(), va.data_ptr(), arr.p_sched.data_ptr(),
        arr.q_sched.data_ptr(), p.data_ptr(), q.data_ptr(), mp.data_ptr(),
        mq.data_ptr(), route.off.data_ptr(), route.off.shape[1],
        route.ones.data_ptr(), route.ones.numel(), buf.data_ptr(),
        route.size, n)
    nr_fill_routed.launches += 1
    return NrFillRouted(p, q, mp, mq, buf)


def nr_fill_routed_ref(arr, route: NrRoute, vm, va) -> NrFillRouted:
    """Plain PyTorch routed K1: ``_quadrant_values`` of newton_bbd.py
    (the JAX package's :253), its values put at the route's offsets, and
    1.0 at the identity positions. The CPU path, and the check the routed
    kernel is held to on the card."""
    # newton_bbd.py imports this module for nr_fill_routed
    from ..powerflow.newton_bbd import _quadrant_values

    res = nr_fill_ref(arr, vm[None], va[None], arr.p_sched[None],
                      arr.q_sched[None])
    vals = _quadrant_values(arr, vm, va, res.p[0], res.q[0])
    off = route.off.reshape(-1)
    keep = off >= 0
    buf = torch.zeros(route.size, dtype=vm.dtype, device=vm.device)
    buf[off[keep]] = vals[keep]
    buf[route.ones] = 1.0
    return NrFillRouted(res.p[0], res.q[0], res.mp[0], res.mq[0], buf)


def nr_fill_ref(arr, vm, va, p_sched, q_sched,
                jacobian: bool = False) -> NrFill:
    """Plain PyTorch K1: a direct transcription of ac.py:92-162 with a
    leading scenario axis (gathers, ``index_add_`` segment sums, scatters at
    the unknowns' rows and columns ``arr.pos``, so the Jacobian is
    ``[B, N, N]``). The CPU path, and the check K1 is held to on the
    card."""
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

    # the four partials of each off-diagonal entry (ac.py:137-148) and of
    # each bus's diagonal (ac.py:150-156), at their row and column of the
    # Newton system; a fixed variable's row or column is left out
    pos = arr.pos.long()
    pa, pm = pos[:n], pos[n:]
    diag = arr.diag.long()
    gii = arr.yg[diag]
    bii = arr.yb[diag]
    off = rows != cols
    order = arr.order
    jac = torch.zeros((batch, order * order), dtype=vm.dtype,
                      device=vm.device)
    for r, c, vals, sel in (
            (pa[rows], pa[cols], vv * gs_bc, off),       # dP/dθj
            (pa[rows], pm[cols], vi * gc_bs, off),       # dP/dVj
            (pm[rows], pa[cols], -vv * gc_bs, off),      # dQ/dθj
            (pm[rows], pm[cols], vi * gs_bc, off),       # dQ/dVj
            (pa, pa, -q - bii * vm**2, True),
            (pa, pm, p / vm + gii * vm, True),
            (pm, pa, p - gii * vm**2, True),
            (pm, pm, q / vm - bii * vm, True)):
        keep = (r >= 0) & (c >= 0) & sel
        jac.index_add_(1, (r * order + c)[keep], vals[:, keep])
    return NrFill(p, q, mp, mq, jac.view(batch, order, order))
