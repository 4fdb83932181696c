"""K5 ``schur_gather``: the border system of a BBD Schur-complement solve.

One launch computes what the JAX package's padded scatter-adds compute in
``powerflow/newton_bbd.py`` (:340-348), ``ops/bbd.py::bbd_solve_local``
(:302-308) and ``estimation/acse_bbd.py`` (:331-336): every block's
``[L, L]`` Schur contribution and ``L``-long right-hand-side part summed
into the ``[nb, nb]`` border matrix and the ``[nb]`` border right-hand side
through the block's local-to-global border map ``bsel`` (pad slots hold the
sentinel ``nb``), on top of a base (the masked border block, or zero) and
times a sign. The CUDA source, its mapping and what bounds it are described
in ``csrc/schur_gather.cu``.

The kernel gathers through per-border-slot lists (``SchurRoute``) that
``schur_route`` builds once on the host from ``bsel``: for each border
slot, the blocks that reach it and its local slot in each, in ascending
block order. ``schur_gather`` dispatches on the device of its tensors: a
CUDA tensor goes to the kernel (and the call raises if the kernel does not
build or launch), a CPU tensor to ``schur_gather_ref``, the JAX package's
padded scatter-add written with ``index_put_(..., accumulate=True)``.
``schur_gather.launches`` counts kernel launches. ``schur_gather_lists``
walks the lists in plain PyTorch in the kernel's order, so that it gives
the kernel's bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ._build import F64, INT, PTR


class SchurRoute(NamedTuple):
    """K5's per-border-slot lists (int32) and the map they were built
    from (the kernel reads both)."""

    slot_ptr: torch.Tensor  # i32[nb + 1] list offsets
    slot_blk: torch.Tensor  # i32[S] block of each entry, ascending in a list
    slot_loc: torch.Tensor  # i32[S] the border slot's local slot there
    bsel: torch.Tensor      # i64[k, L] local slot -> border slot (pad nb)
    nb: int                 # border size
    by_rows: bool           # which of K5's two kernels serves the route


def schur_route_host(bsel, nb: int) -> dict:
    """Numpy lists of ``SchurRoute`` from the ``[k, L]`` map ``bsel``: for
    every border slot, the ``(block, local slot)`` pairs that reach it in
    ascending block order. Pad slots (``bsel == nb``) are left out. Raises
    if a flat index into the border or the contributions would not fit
    int32, or if a block names one border slot twice.

    ``by_rows`` picks the kernel: the row kernel, which streams each
    block's contribution rows, where the real contributions (each block's
    real slots squared) are at least as many as the border's elements (the
    estimators' borders); else the merge kernel (see
    csrc/schur_gather.cu)."""
    bsel = np.asarray(bsel, dtype=np.int64)
    k, width = bsel.shape
    if nb * nb >= 2**31 or k * width * width >= 2**31:
        raise ValueError(f"border {nb} or contributions {k}x{width}^2 too "
                         "large for K5's int32 tables")
    valid = (bsel >= 0) & (bsel < nb)
    b_idx, l_idx = np.nonzero(valid)        # block-major: blocks ascending
    glob = bsel[b_idx, l_idx]
    if len(np.unique(b_idx * nb + glob)) != len(glob):
        raise ValueError("a block names one border slot twice")
    order = np.argsort(glob, kind="stable")
    ptr = np.searchsorted(glob[order], np.arange(nb + 1))
    real = valid.sum(axis=1)
    return dict(slot_ptr=ptr.astype(np.int32),
                slot_blk=b_idx[order].astype(np.int32),
                slot_loc=l_idx[order].astype(np.int32), bsel=bsel,
                by_rows=bool((real * real).sum() >= nb * nb))


def schur_route(bsel, nb: int, device) -> SchurRoute:
    """``SchurRoute`` on ``device`` from the numpy map ``bsel``."""
    host = schur_route_host(bsel, nb)
    return SchurRoute(nb=int(nb), by_rows=host.pop("by_rows"), **{
        name: torch.tensor(a, device=device) for name, a in host.items()})


def _check_inputs(route: SchurRoute, contrib, parts, a_bb, r_bb):
    k, width = route.bsel.shape
    nb = route.nb
    for name, t, shape in (("contrib", contrib, (k, width, width)),
                           ("parts", parts, (k, width)),
                           ("a_bb", a_bb, (nb, nb)), ("r_bb", r_bb, (nb,))):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if t.device != route.bsel.device:
            raise ValueError(f"{name} is on {t.device}, the route on "
                             f"{route.bsel.device}")
    if nb < 1:
        raise ValueError("empty border")


def schur_gather(route: SchurRoute, contrib, parts, a_bb=None, r_bb=None,
                 scale: float = 1.0):
    """``(schur [nb, nb], rhs [nb])``: ``a_bb + scale * Σ contrib`` and
    ``r_bb + scale * Σ parts`` over the blocks, through ``route``
    (``a_bb``/``r_bb`` None: zero)."""
    _check_inputs(route, contrib, parts, a_bb, r_bb)
    if contrib.device.type == "cpu":
        return schur_gather_ref(route, contrib, parts, a_bb, r_bb, scale)
    if contrib.device.type != "cuda":
        raise ValueError(f"schur_gather runs on cuda or cpu tensors, not "
                         f"{contrib.device}")
    return _launch(route, contrib, parts, a_bb, r_bb, scale)


schur_gather.launches = 0


LIBRARY = _build.Library(
    "schur_gather", schur_gather_launch=(INT, [PTR] * 5 + [F64] + [PTR] * 3))
#: ``SchurTables`` of csrc/schur_gather.cu, one a route (keyed by its
#: ``slot_ptr``)
_Tables = _build.Struct(
    "SchurTables", dict(slot_ptr=torch.int32, slot_blk=torch.int32,
                        slot_loc=torch.int32, bsel=torch.int64),
    ("nb", "k", "width", "by_rows"))


def _tables(route: SchurRoute) -> _build.Entry:
    k, width = route.bsel.shape
    return _Tables.get("slot_ptr", {name: getattr(route, name)
                                   for name in _Tables.dtypes},
                      nb=route.nb, k=k, width=width, by_rows=route.by_rows)


def _launch(route: SchurRoute, contrib, parts, a_bb, r_bb, scale: float):
    contrib, parts = contrib.contiguous(), parts.contiguous()
    a_bb = None if a_bb is None else a_bb.contiguous()
    r_bb = None if r_bb is None else r_bb.contiguous()
    nb = route.nb
    out = torch.empty(nb * nb + nb, dtype=torch.float64,
                      device=contrib.device)
    schur, rhs = out[:nb * nb].view(nb, nb), out[nb * nb:]
    LIBRARY.launch(
        "schur_gather_launch", contrib.device, _tables(route).address,
        contrib.data_ptr(), parts.data_ptr(),
        None if a_bb is None else a_bb.data_ptr(),
        None if r_bb is None else r_bb.data_ptr(), scale, schur.data_ptr(),
        rhs.data_ptr())
    schur_gather.launches += 1
    return schur, rhs


def schur_gather_ref(route: SchurRoute, contrib, parts, a_bb=None,
                     r_bb=None, scale: float = 1.0):
    """Plain PyTorch K5: the JAX package's padded scatter-add into a
    ``(nb + 1)^2`` buffer with ``index_put_(..., accumulate=True)``, then
    the base added. The CPU path, and the check K5 is held to on the
    card."""
    nb = route.nb
    bsel = route.bsel
    width = bsel.shape[1]
    s_pad = contrib.new_zeros((nb + 1, nb + 1))
    s_pad.index_put_((bsel[:, :, None].expand(-1, -1, width),
                      bsel[:, None, :].expand(-1, width, -1)), contrib,
                     accumulate=True)
    r_pad = parts.new_zeros(nb + 1)
    r_pad.index_put_((bsel,), parts, accumulate=True)
    schur = scale * s_pad[:nb, :nb]
    rhs = scale * r_pad[:nb]
    return (schur if a_bb is None else a_bb + schur,
            rhs if r_bb is None else r_bb + rhs)


def schur_gather_lists(route: SchurRoute, contrib, parts, a_bb=None,
                       r_bb=None, scale: float = 1.0):
    """K5's function computed as the kernel computes it, in plain PyTorch:
    element (i, j) sums ``contrib[b, l_i, l_j]`` over the blocks on both
    slots' lists in ascending block order, starting from 0.0, then adds
    ``scale *`` the sum to the base; elements no block reaches keep the
    base (or zero). Gives the kernel's bits, so the card's check can hold
    it to them."""
    nb = route.nb
    k, width = route.bsel.shape
    ptr = route.slot_ptr.long()
    blk, loc = route.slot_blk.long(), route.slot_loc.long()
    # the lists padded to their longest, and each block's local slot of
    # each border slot (-1: not on its border)
    count = ptr[1:] - ptr[:-1]
    longest = int(count.max()) if nb else 0
    pos = torch.arange(longest, device=ptr.device)
    on = pos[None, :] < count[:, None]
    at = (ptr[:-1, None] + pos[None, :]).clamp(max=max(len(blk) - 1, 0))
    local = torch.full((k + 1, nb), -1, dtype=torch.long, device=ptr.device)
    slot = torch.repeat_interleave(torch.arange(nb, device=ptr.device), count)
    local[blk, slot] = loc
    acc = contrib.new_zeros((nb, nb))
    hit = torch.zeros((nb, nb), dtype=torch.bool, device=ptr.device)
    acc_r = parts.new_zeros(nb)
    for p in range(longest):
        # entry p of each row's list, against the columns' local slots in
        # the same block: ascending blocks, as the kernel's merge
        b_i = torch.where(on[:, p], blk[at[:, p]], k)
        l_i = loc[at[:, p]]
        l_j = local[b_i]                                   # [nb, nb]
        both = on[:, p, None] & (l_j >= 0)
        val = contrib[b_i.clamp(max=k - 1)[:, None], l_i[:, None],
                      l_j.clamp(min=0)]
        acc = torch.where(both, acc + val, acc)
        hit |= both
        # the right-hand side walks each slot's own list
        acc_r = torch.where(on[:, p], acc_r + parts[b_i.clamp(max=k - 1),
                                                    l_i], acc_r)
    base_s = a_bb if a_bb is not None else contrib.new_zeros((nb, nb))
    base_r = r_bb if r_bb is not None else parts.new_zeros(nb)
    schur = torch.where(hit, base_s + scale * acc, base_s)
    rhs = torch.where(count > 0, base_r + scale * acc_r, base_r)
    return schur, rhs
