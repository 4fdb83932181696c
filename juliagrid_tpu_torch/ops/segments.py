"""Sums over index groups in a fixed order.

``index_add`` sums with atomics on the card, in an order that changes from
run to run, so one input could give an interior point two trajectories.
``segment_sum(src, index, size)[..., j]`` instead adds the entries
``src[..., p]`` with ``index[p] == j`` for ascending ``p``, from 0.0, one
addition at a time: each group's entries are gathered into the row of a
padded table (host-built from the index, once, and kept while the index
tensor lives; a short row is padded with a zero), and the table's columns
are added one after another. So the sum has the sequential sum's bits on
the card and on the CPU, and, made of gathers and additions only, it goes
through every ``torch.func`` transform (``grad``, ``vjp``, ``jvp``,
``vmap`` and their compositions: the interior point's Jacobians and
Hessians of user extensions). A group's width is the index's most
repeated value, so the additions are few for bus sums over a Y-bus or a
generator list. A sum that no forward-mode transform sees and whose
groups are wide (the BBD KKT's residual: rows of tens of entries) takes
``forward_ad=False``: one ``torch.segment_reduce`` over the entries sorted
by group, whose kernel walks a group in one thread on the card and in one
loop on the CPU, so it too gives the sequential sum's bits.

The gathers' own gradients (``t[..., idx]``) need nothing of the kind: on
the card PyTorch sums them with a sort by index that keeps the order of
the entries (``index_put_`` with ``accumulate=True``), which
``scripts/opf_repeat.py`` holds to the same bits run after run.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary


def segment_table(index, size: int) -> np.ndarray:
    """``[size, width]`` positions in ``src`` of each group's entries in
    ascending order, ``len(index)`` (the zero appended to ``src``) where a
    group is shorter than the widest."""
    index = np.asarray(index, dtype=np.int64).reshape(-1)
    if index.size and (index.min() < 0 or index.max() >= size):
        raise ValueError(f"an index lies outside [0, {size})")
    order = np.argsort(index, kind="stable")
    lengths = np.bincount(index, minlength=size)
    width = int(lengths.max()) if index.size else 0
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    rank = np.arange(index.size) - np.repeat(starts, lengths)
    table = np.full((size, width), index.size, dtype=np.int64)
    table[index[order], rank] = order
    return table


#: for each index tensor, by target count: its host copy and what has been
#: built from it (the positions sorted stably by group and each group's
#: length; the table)
_GROUPS = WeakIdKeyDictionary()


def _groups(index: torch.Tensor, size: int, what: str) -> torch.Tensor:
    per_size = _GROUPS.get(index)
    if per_size is None:
        per_size = {}
        _GROUPS[index] = per_size
    built = per_size.get(size)
    if built is None:
        # outside any torch.func transform: a host copy of a plain tensor
        with torch._C._DisableFuncTorch():
            built = {"host": index.detach().cpu().numpy().reshape(-1)}
        per_size[size] = built
    if what not in built:
        host = built["host"]
        made = {"table": lambda: segment_table(host, size),
                "order": lambda: np.argsort(host, kind="stable"),
                "lengths": lambda: np.bincount(host, minlength=size)}[what]()
        built[what] = torch.as_tensor(made, device=index.device)
    return built[what]


def segment_sum(src: torch.Tensor, index: torch.Tensor, size: int,
                forward_ad: bool = True) -> torch.Tensor:
    """``zeros(..., size).index_add(-1, index, src)`` with every group
    summed in ascending position, one addition at a time: the same bits on
    every run, on the card and on the CPU. ``forward_ad=False``: one
    kernel, for a sum no forward-mode transform sees."""
    lead = src.shape[:-1]
    if not forward_ad:
        order = _groups(index, size, "order")
        lengths = _groups(index, size, "lengths")
        if not src.shape[-1] or not size:
            return src.new_zeros(*lead, size)
        # two dimensions at least: one-dimensional data takes another
        # kernel on the card (a block-wide tree per group)
        flat = src.index_select(-1, order).reshape(-1, src.shape[-1])
        return torch.segment_reduce(
            flat, "sum", lengths=lengths.expand(flat.shape[0], size), axis=1,
            unsafe=True).reshape(*lead, size)
    table = _groups(index, size, "table")
    if not table.shape[1]:
        return src.new_zeros(*lead, size)
    padded = torch.cat([src, src.new_zeros(*lead, 1)], -1)[..., table]
    out = padded[..., 0] + 0.0
    for c in range(1, table.shape[1]):
        out = out + padded[..., c]
    return out
