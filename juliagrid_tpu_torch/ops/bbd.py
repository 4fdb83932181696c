"""Bordered-block-diagonal (BBD) partitioning and Schur-complement solves.

Port of ``juliagrid_tpu/ops/bbd.py``. A large sparse matrix is permuted to
bordered block-diagonal form:

    [ A_11          B_1 ] [x_1]   [r_1]
    [       ...     ...  ] [...] = [...]
    [            A_kk B_k ] [x_k]   [r_k]
    [ C_1   ...  C_k  D  ] [x_b]   [r_b]

The interior blocks factor independently in f64
(``linalg.batched_lu_solve2``: on the card one cuSOLVER getrf per block, the
blocks on streams of their own), the border Schur complement
S = D - Σ_k C_k A_kk⁻¹ B_k is reduced over the blocks, the (small) border
system is solved, and the back-substitution is again one batched product.
The write-back of the interior solutions to their buses is one indexed
scatter. Everything is f64: the JAX package's f32 factors with
refinement sweeps are TPU-only and not ported.

On the locality-compressed layout (``BbdLocalArrays``: each block keeps
only the border columns it touches) the border system is assembled by K5
(``kernels/schur_gather.py``). The partitioners run on the host:
``bbd_partition`` (BFS region growing, a copy of the JAX package's) here,
``partition.nd_partition`` (spectral nested dissection) beside it.

Over a ``block`` mesh of ranks (``parallel/mesh.py``), ``bbd_solve_sharded``
and ``bbd_solve_local_sharded`` give each rank one interior block: it
factors its block and forms its Schur contribution, one all-reduce (sum)
builds the border system on every rank, each rank solves it, and a second
all-reduce assembles the whole solution from the ranks' back-substitutions
(where the JAX package has ``psum`` over a ``shard_map``).

Not ported here: ``bbd_solve_f64``/``bbd_solve_local_f64``, the JAX
package's f64 unpivoted LDLᵀ endgame for its f32 factors (the AC OPF's BBD
KKT, ``opf/kkt_bbd.py``, factors with ``bbd_solve_local``'s pivoted f64 LU
throughout).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
import torch

from ..config import resolve_device
from ..kernels.schur_gather import SchurRoute, schur_gather
from ..utils.profiling import mark
from . import linalg


def bbd_partition(adjacency: sp.spmatrix, n_blocks: int):
    """Partition buses into blocks + border via BFS region growing.

    Returns (block_of_bus array with -1 for border buses, border list).
    A bus whose neighbors span multiple regions is promoted to the border.
    """
    n = adjacency.shape[0]
    adj = adjacency.tocsr()
    target = (n + n_blocks - 1) // n_blocks

    region = np.full(n, -2, dtype=np.int64)  # -2 unassigned
    seeds = np.linspace(0, n - 1, n_blocks).astype(np.int64)
    frontiers = []
    for b, s in enumerate(seeds):
        while region[s] != -2:
            s = (s + 1) % n
        region[s] = b
        frontiers.append([int(s)])

    sizes = [1] * n_blocks
    active = True
    while active:
        active = False
        for b in range(n_blocks):
            if sizes[b] >= target or not frontiers[b]:
                continue
            new_frontier = []
            for u in frontiers[b]:
                for v in adj.indices[adj.indptr[u]:adj.indptr[u + 1]]:
                    if region[v] == -2 and sizes[b] < target:
                        region[v] = b
                        sizes[b] += 1
                        new_frontier.append(int(v))
            frontiers[b] = new_frontier
            active = active or bool(new_frontier)

    # any unassigned stragglers join the smallest region
    for u in np.flatnonzero(region == -2):
        b = int(np.argmin(sizes))
        region[u] = b
        sizes[b] += 1

    # border: buses adjacent to a different region
    border = []
    for u in range(n):
        for v in adj.indices[adj.indptr[u]:adj.indptr[u + 1]]:
            if region[v] != region[u]:
                border.append(u)
                break
    border = np.asarray(sorted(set(border)), dtype=np.int64)
    block_of = region.copy()
    block_of[border] = -1
    return block_of, border


class BbdArrays(NamedTuple):
    a_ii: torch.Tensor           # (k, ni, ni) interior blocks (identity pad)
    a_ib: torch.Tensor           # (k, ni, m) interior-border coupling
    a_bi: torch.Tensor           # (k, m, ni)
    a_bb: torch.Tensor           # (m, m) border block
    interior_idx: torch.Tensor   # i64 (k, ni) bus of each padded slot
    interior_mask: torch.Tensor  # (k, ni) 1 for real slots
    border_idx: torch.Tensor     # i64 (m,)


def build_bbd_arrays(a, block_of: np.ndarray, border: np.ndarray,
                     device=None) -> BbdArrays:
    """The BBD snapshot of a host matrix on ``device`` (default
    ``config.device``): scipy sparse (the scale path, block extraction in
    O(nnz), no dense n x n intermediate) or a dense ndarray. The blocks are
    cut on the host and uploaded once."""
    dev = resolve_device(device)
    k = int(block_of.max()) + 1
    m = len(border)
    groups = [np.flatnonzero(block_of == b) for b in range(k)]
    ni = max(len(g) for g in groups)

    if sp.issparse(a):
        a_csr = a.tocsr()
        sub = lambda r, c: a_csr[r][:, c].toarray()  # noqa: E731
    else:
        sub = lambda r, c: np.asarray(a)[np.ix_(r, c)]  # noqa: E731

    a_ii = np.zeros((k, ni, ni))
    a_ib = np.zeros((k, ni, m))
    a_bi = np.zeros((k, m, ni))
    idx = np.zeros((k, ni), dtype=np.int64)
    mask = np.zeros((k, ni))
    for b, g in enumerate(groups):
        s = len(g)
        a_ii[b, :s, :s] = sub(g, g)
        a_ii[b, s:, s:] = np.eye(ni - s)
        a_ib[b, :s, :] = sub(g, border)
        a_bi[b, :, :s] = sub(border, g)
        idx[b, :s] = g
        mask[b, :s] = 1.0
    a_bb = sub(border, border)
    up = lambda x: torch.tensor(x, device=dev)  # noqa: E731
    return BbdArrays(a_ii=up(a_ii), a_ib=up(a_ib), a_bi=up(a_bi),
                     a_bb=up(a_bb), interior_idx=up(idx),
                     interior_mask=up(mask),
                     border_idx=up(np.asarray(border, dtype=np.int64)))


def _gather(rhs, interior_idx, interior_mask, border_idx):
    """The right-hand side in block layout: ``(r_i [k, ni], r_b [m])``."""
    return rhs[interior_idx] * interior_mask, rhs[border_idx]


def _write_back(n, x_i, x_b, interior_idx, interior_mask, border_idx):
    """The solution in bus order from its block layout: the border set,
    then every interior slot in one indexed scatter (a padded slot adds
    0.0 to bus ``interior_idx``, which leaves it exact)."""
    x = x_b.new_zeros(n)
    x[border_idx] = x_b
    return x.index_put_((interior_idx.reshape(-1),),
                        (x_i * interior_mask).reshape(-1), accumulate=True)


def _vec(a, x):
    """Batched matrix-vector product ``a @ x`` over a leading block axis."""
    return (a @ x[..., None])[..., 0]


def bbd_solve(arr: BbdArrays, rhs):
    """Solve A x = rhs through the Schur complement (blocks batched)."""
    r_i, r_b = _gather(rhs, arr.interior_idx, arr.interior_mask,
                       arr.border_idx)
    y, z = linalg.batched_lu_solve2(arr.a_ii, r_i, arr.a_ib)
    schur = arr.a_bb - (arr.a_bi @ z).sum(0)
    rhs_b = r_b - _vec(arr.a_bi, y).sum(0)
    x_b = linalg.solve(linalg.factorize(schur, linalg.LU), rhs_b)
    x_i = y - z @ x_b
    return _write_back(rhs.shape[0], x_i, x_b, arr.interior_idx,
                       arr.interior_mask, arr.border_idx)


def bbd_matvec(arr: BbdArrays, x):
    """A @ x through the block structure (no dense n x n assembly)."""
    x_i, x_b = _gather(x, arr.interior_idx, arr.interior_mask,
                       arr.border_idx)
    ax_i = _vec(arr.a_ii, x_i) + arr.a_ib @ x_b
    ax_b = arr.a_bb @ x_b + _vec(arr.a_bi, x_i).sum(0)
    return _write_back(x.shape[0], ax_i, ax_b, arr.interior_idx,
                       arr.interior_mask, arr.border_idx)


class BbdLocalArrays(NamedTuple):
    """BBD snapshot with LOCALITY-COMPRESSED border couplings: each block
    stores only the border columns it touches (mbl local slots, bsel mapping
    them to global border slots, padded with mb). ``route`` is K5's gather
    of the per-block Schur contributions (``schur_route(bsel, mb)``)."""

    a_ii: torch.Tensor   # (k, ni, ni)
    a_ib: torch.Tensor   # (k, ni, mbl) local coupling
    a_bi: torch.Tensor   # (k, mbl, ni)
    a_bb: torch.Tensor   # (mb, mb)
    bsel: torch.Tensor   # i64 (k, mbl) local slot -> global border slot
    bmask: torch.Tensor  # (k, mbl) 1 for real slots
    interior_idx: torch.Tensor
    interior_mask: torch.Tensor
    border_idx: torch.Tensor
    route: SchurRoute


def local_border(x_b, bsel, bmask):
    """The border vector in each block's local slots (``[k, mbl]``; pad
    slots 0)."""
    return torch.cat([x_b, x_b.new_zeros(1)])[bsel] * bmask


def bbd_solve_local(arr: BbdLocalArrays, rhs, check: bool = True):
    """Schur solve on the locality-compressed layout: the border system is
    assembled by K5 from the per-block contributions. A singular interior
    block or border system raises; with ``check`` off it does not, and the
    solution comes out inf or NaN instead (the interior point's KKT, whose
    loop escalates δ on a non-finite step). Its stages are marked for
    ``utils.profiling.device_stages``."""
    r_i, r_b = _gather(rhs, arr.interior_idx, arr.interior_mask,
                       arr.border_idx)
    y, z = linalg.batched_lu_solve2(arr.a_ii, r_i, arr.a_ib, check)
    mark("Schur products")
    contrib, parts = arr.a_bi @ z, _vec(arr.a_bi, y)
    mark("K5")
    schur, rhs_b = schur_gather(arr.route, contrib, parts, arr.a_bb, r_b,
                                scale=-1.0)
    mark("border LU")
    x_b = linalg.solve(linalg.factorize(schur, linalg.LU, check=check),
                       rhs_b)
    mark("back-sub")
    x_i = y - _vec(z, local_border(x_b, arr.bsel, arr.bmask))
    return _write_back(rhs.shape[0], x_i, x_b, arr.interior_idx,
                       arr.interior_mask, arr.border_idx)


def _block_rank(mesh, k: int, axis: str) -> int:
    """This rank's block: the block count must equal the axis size."""
    if mesh.shape.get(axis) != k:
        raise ValueError(f"{k} blocks must equal the size of mesh axis "
                         f"{axis!r} ({mesh.shape})")
    return mesh.rank


def _assemble_sharded(mesh, n, x_i, x_b, interior_idx, interior_mask,
                      border_idx):
    """The whole solution on every rank from this rank's interior block
    ``x_i [1, ni]`` and the replicated border ``x_b``: the interiors summed
    into zeros by one all-reduce (each bus gets its owner's value plus
    zeros, so exact), then the border set."""
    x = x_b.new_zeros(n)
    x.index_put_((interior_idx.reshape(-1),),
                 (x_i * interior_mask).reshape(-1), accumulate=True)
    mesh.all_reduce(x)
    mark("back-sub")
    x[border_idx] = x_b
    return x


def bbd_solve_sharded(mesh, arr: BbdArrays, rhs, axis: str = "block"):
    """``bbd_solve`` with the interior blocks over the ranks of ``mesh``:
    called by every rank with the whole ``arr`` and ``rhs``, block r on
    rank r (the block count must equal the axis size). Rank r factors its
    block and forms ``a_bi @ z`` and ``a_bi @ y`` at the border's width;
    one all-reduce (sum) gives every rank the Schur complement and the
    border right-hand side, each rank solves the border system, and the
    back-substitutions are assembled by a second all-reduce. Returns the
    whole solution on every rank."""
    r = _block_rank(mesh, arr.a_ii.shape[0], axis)
    blk = slice(r, r + 1)
    idx, msk = arr.interior_idx[blk], arr.interior_mask[blk]
    y, z = linalg.batched_lu_solve2(arr.a_ii[blk], rhs[idx] * msk,
                                    arr.a_ib[blk])
    mark("Schur products")
    m = arr.a_bb.shape[0]
    part = torch.cat([(arr.a_bi[blk] @ z)[0].reshape(-1),
                      _vec(arr.a_bi[blk], y)[0]])
    mesh.all_reduce(part)
    mark("border LU")
    schur = arr.a_bb - part[:m * m].view(m, m)
    rhs_b = rhs[arr.border_idx] - part[m * m:]
    x_b = linalg.solve(linalg.factorize(schur, linalg.LU), rhs_b)
    mark("back-sub")
    x_i = y - z @ x_b
    return _assemble_sharded(mesh, rhs.shape[0], x_i, x_b, idx, msk,
                             arr.border_idx)


def bbd_solve_local_sharded(mesh, arr: BbdLocalArrays, rhs,
                            check: bool = True, axis: str = "block"):
    """``bbd_solve_local`` with the interior blocks over the ranks of
    ``mesh``: ``arr`` holds this rank's one block (``a_ii``, ``a_ib``,
    ``a_bi``, ``bsel``, ``bmask``, ``interior_idx`` and ``interior_mask``
    with a leading 1, block r on rank r of the axis, whose size is the
    block count), the replicated ``a_bb`` and ``border_idx``, and as its
    ``route`` K5's route of the one block (``schur_route(bsel[r:r + 1],
    mb)``). Rank r factors its block, K5 gathers the block's contributions
    into a zero border, one all-reduce (sum) adds the ranks' borders, and
    ``a_bb`` and ``r_b`` are added once, after it; then the border solve,
    this block's back-substitution and the solution's all-reduce, as
    ``bbd_solve_sharded``. ``check`` as in ``bbd_solve_local``."""
    if axis not in mesh.shape or arr.a_ii.shape[0] != 1:
        raise ValueError(f"bbd_solve_local_sharded takes one block a rank "
                         f"of mesh axis {axis!r} ({mesh.shape}), got "
                         f"{arr.a_ii.shape[0]}")
    idx, msk = arr.interior_idx, arr.interior_mask
    r_b = rhs[arr.border_idx]
    y, z = linalg.batched_lu_solve2(arr.a_ii, rhs[idx] * msk, arr.a_ib,
                                    check)
    mark("Schur products")
    contrib, parts = arr.a_bi @ z, _vec(arr.a_bi, y)
    mark("K5")
    schur, rhs_part = schur_gather(arr.route, contrib, parts, scale=-1.0)
    mb = schur.shape[0]
    part = mesh.all_reduce(torch.cat([schur.reshape(-1), rhs_part]))
    mark("border LU")
    schur = arr.a_bb + part[:mb * mb].view(mb, mb)
    x_b = linalg.solve(linalg.factorize(schur, linalg.LU, check=check),
                       r_b + part[mb * mb:])
    mark("back-sub")
    x_i = y - _vec(z, local_border(x_b, arr.bsel, arr.bmask))
    return _assemble_sharded(mesh, rhs.shape[0], x_i, x_b, idx, msk,
                             arr.border_idx)


class BbdFactors(NamedTuple):
    """Precomputed BBD factorization: per-block f64 LU factors, the
    interior-solved coupling Z = A_ii⁻¹ B, and the factored Schur
    complement. Amortizes across iterations for constant matrices
    (fast-decoupled B'/B'')."""

    lu: torch.Tensor
    piv: torch.Tensor
    z: torch.Tensor
    a_bi: torch.Tensor
    schur: linalg.DenseFactor
    interior_idx: torch.Tensor
    interior_mask: torch.Tensor
    border_idx: torch.Tensor


def bbd_precompute(arr: BbdArrays) -> BbdFactors:
    lu, piv = linalg.lu_factor_blocks(arr.a_ii)
    z = torch.linalg.lu_solve(lu, piv, arr.a_ib)
    schur = arr.a_bb - (arr.a_bi @ z).sum(0)
    return BbdFactors(
        lu=lu, piv=piv, z=z, a_bi=arr.a_bi,
        schur=linalg.factorize(schur, linalg.LU),
        interior_idx=arr.interior_idx, interior_mask=arr.interior_mask,
        border_idx=arr.border_idx)


def bbd_presolved_solve(f: BbdFactors, rhs):
    """Solve with precomputed factors: triangular solves + one reduction."""
    r_i, r_b = _gather(rhs, f.interior_idx, f.interior_mask, f.border_idx)
    y = torch.linalg.lu_solve(f.lu, f.piv, r_i[..., None])[..., 0]
    rhs_b = r_b - _vec(f.a_bi, y).sum(0)
    x_b = linalg.solve(f.schur, rhs_b)
    x_i = y - f.z @ x_b
    return _write_back(rhs.shape[0], x_i, x_b, f.interior_idx,
                       f.interior_mask, f.border_idx)
