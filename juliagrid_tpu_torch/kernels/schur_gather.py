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

The kernel gathers from a CSR of sources per destination (``SchurRoute``)
that ``schur_route`` builds once on the host from ``bsel``. ``schur_gather``
dispatches on the device of its tensors: a CUDA tensor goes to the kernel
(and the call raises if the kernel does not build or launch), a CPU tensor
to ``schur_gather_ref``, the JAX package's padded scatter-add written with
``index_put_(..., accumulate=True)``. ``schur_gather.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build


class SchurRoute(NamedTuple):
    """K5's gather tables (int32) and the map they were built from."""

    mat_dst: torch.Tensor  # i32[dm] flat destinations in [nb, nb], ascending
    mat_ptr: torch.Tensor  # i32[dm + 1] CSR offsets into mat_src
    mat_src: torch.Tensor  # i32[sm] flat sources in [k, L, L]
    rhs_dst: torch.Tensor  # i32[dr] destinations in [nb], ascending
    rhs_ptr: torch.Tensor  # i32[dr + 1]
    rhs_src: torch.Tensor  # i32[sr] flat sources in [k, L]
    bsel: torch.Tensor     # i64[k, L] local slot -> border slot (pad nb)
    nb: int                # border size


def _csr(dst: np.ndarray, src: np.ndarray):
    """Sources grouped by destination, keeping their given (block) order
    inside a group: ``(dst_unique, ptr, src)`` as int32."""
    order = np.argsort(dst, kind="stable")
    dst, src = dst[order], src[order]
    uniq, start = np.unique(dst, return_index=True)
    ptr = np.append(start, len(dst))
    return (uniq.astype(np.int32), ptr.astype(np.int32),
            src.astype(np.int32))


def schur_route_host(bsel, nb: int) -> dict:
    """Numpy tables of ``SchurRoute`` from the ``[k, L]`` map ``bsel``:
    for every border position any block reaches, its sources in ascending
    block order. Pad slots (``bsel == nb``) are left out. Raises if a flat
    index would not fit int32."""
    bsel = np.asarray(bsel, dtype=np.int64)
    k, width = bsel.shape
    if nb * nb >= 2**31 or k * width * width >= 2**31:
        raise ValueError(f"border {nb} or contributions {k}x{width}^2 too "
                         "large for K5's int32 tables")
    valid = (bsel >= 0) & (bsel < nb)
    b_idx, l_idx = np.nonzero(valid)        # block-major: blocks ascending
    rhs = _csr(bsel[b_idx, l_idx], b_idx * width + l_idx)
    dsts, srcs = [], []
    for b in range(k):
        slots = np.flatnonzero(valid[b])
        glob = bsel[b, slots]
        dsts.append((glob[:, None] * nb + glob[None, :]).ravel())
        srcs.append(((b * width + slots[:, None]) * width
                     + slots[None, :]).ravel())
    mat = _csr(np.concatenate(dsts), np.concatenate(srcs))
    return dict(mat_dst=mat[0], mat_ptr=mat[1], mat_src=mat[2],
                rhs_dst=rhs[0], rhs_ptr=rhs[1], rhs_src=rhs[2], bsel=bsel)


def schur_route(bsel, nb: int, device) -> SchurRoute:
    """``SchurRoute`` on ``device`` from the numpy map ``bsel``."""
    host = schur_route_host(bsel, nb)
    return SchurRoute(nb=int(nb), **{
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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("schur_gather")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.schur_gather_launch.argtypes = (
        [ptr] * 3 + [i32] + [ptr] * 3 + [i32] + [ptr] * 4
        + [ctypes.c_double, ptr, ptr, i32, ptr])
    lib.schur_gather_launch.restype = i32
    lib.schur_gather_error_string.argtypes = [i32]
    lib.schur_gather_error_string.restype = ctypes.c_char_p
    return lib


def _launch(route: SchurRoute, contrib, parts, a_bb, r_bb, scale: float):
    for name in ("mat_dst", "mat_ptr", "mat_src", "rhs_dst", "rhs_ptr",
                 "rhs_src"):
        t = getattr(route, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"SchurRoute.{name} must be contiguous int32")
    contrib, parts = contrib.contiguous(), parts.contiguous()
    a_bb = None if a_bb is None else a_bb.contiguous()
    r_bb = None if r_bb is None else r_bb.contiguous()
    nb = route.nb
    dev = contrib.device
    schur = torch.empty((nb, nb), dtype=torch.float64, device=dev)
    rhs = torch.empty(nb, dtype=torch.float64, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.schur_gather_launch(
            route.mat_dst.data_ptr(), route.mat_ptr.data_ptr(),
            route.mat_src.data_ptr(), route.mat_dst.numel(),
            route.rhs_dst.data_ptr(), route.rhs_ptr.data_ptr(),
            route.rhs_src.data_ptr(), route.rhs_dst.numel(),
            contrib.data_ptr(), parts.data_ptr(),
            None if a_bb is None else a_bb.data_ptr(),
            None if r_bb is None else r_bb.data_ptr(), float(scale),
            schur.data_ptr(), rhs.data_ptr(), nb, stream)
    if err != 0:
        raise RuntimeError("schur_gather launch failed: "
                           + lib.schur_gather_error_string(err).decode())
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
