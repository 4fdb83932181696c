"""Dense f64 linear algebra — the port's factorization substrate.

Replaces the reference's sparse direct solvers (KLU/UMFPACK/CHOLMOD/SPQR,
backend/utility.jl:470-587) with direct float64 solves through
``torch.linalg`` (cuSOLVER on the card, LAPACK on the CPU). The H100 has
native f64, so there is no f32 factor and no refinement sweep.

The ``kind`` tags (LU / KLU / QR / LL / LDLt) mirror the reference's
factorization menu; KLU aliases LU and LDLt aliases LL (Cholesky).
``factorize``/``solve`` take a leading batch dimension as well: a fleet of
scenario Jacobians factors in one batched call, and ``batched_lu_solve2``
factors the BBD interior blocks once for two solves. ``pw_lsq_solve`` is the
Peters-Wilkinson least-squares solve of the state estimator's PW tag.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import mark

# Public factorization tags (API parity with the reference exports).
LU = "LU"
KLU = "KLU"
QR = "QR"
LL = "LL"
LDLT = "LDLt"
PW = "PW"  # Peters-Wilkinson tall LU + L-normal equations


class DenseFactor(NamedTuple):
    """Factorization of a dense (batch of) matrix."""

    kind: str      # "LU", "QR", or "LL"
    data: tuple    # factor tensors


def dense_from_coo(rows, cols, vals, shape, device) -> torch.Tensor:
    """The dense f64 matrix of numpy COO entries, assembled on ``device``;
    ``shape`` is ``n`` for ``[n, n]`` or a pair ``(m, n)``. Entries at one
    position add up, as in ``np.add.at`` (on a CUDA device in another
    order, so such sums may differ in the last bit)."""
    m, n = shape if isinstance(shape, tuple) else (shape, shape)
    a = torch.zeros((m, n), dtype=torch.float64, device=device)
    flat = np.asarray(rows, dtype=np.int64) * n + np.asarray(cols)
    a.view(-1).index_add_(
        0, torch.as_tensor(flat, device=device),
        torch.as_tensor(np.asarray(vals, dtype=np.float64), device=device))
    return a


def mask_identity(a: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """``diag(m) a diag(m) + diag(1 - m)`` for the 0/1 mask ``m`` of
    ``active``, in place: inactive rows and columns become identity."""
    m = active.to(a.dtype)
    a.mul_(m[:, None]).mul_(m[None, :])
    a.diagonal().add_(1.0 - m)
    return a


def factorize(a: torch.Tensor, kind: str = LU,
              check: bool = True) -> DenseFactor:
    """Factorize ``a`` (``[..., n, n]``) in f64.

    Mirrors reference ``factorization``; the dense path has no symbolic
    phase, so ``factorization!`` (numeric-only refresh) also lands here.
    An LU raises on a singular matrix unless ``check`` is off: then a
    singular member of a batch factors as it comes out (a zero pivot), its
    solves give inf or NaN, and the others are untouched.
    """
    kind = {KLU: LU, LDLT: LL}.get(kind, kind)
    if kind == LU:
        if not check:
            return DenseFactor(LU, tuple(torch.linalg.lu_factor_ex(a)[:2]))
        return DenseFactor(LU, tuple(torch.linalg.lu_factor(a)))
    if kind == QR:
        return DenseFactor(QR, tuple(torch.linalg.qr(a)))
    if kind == LL:
        return DenseFactor(LL, (torch.linalg.cholesky(a),))
    raise ValueError(f"unknown factorization kind {kind}")


def solve(factor: DenseFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` for a right-hand side ``b`` of shape ``[..., n]``."""
    return solve_columns(factor, b.unsqueeze(-1)).squeeze(-1)


def solve_columns(factor: DenseFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A X = B`` for the columns of ``b`` (``[..., n, k]``) in one
    call — k right-hand sides against one factorization."""
    if factor.kind == LU:
        lu, piv = factor.data
        return torch.linalg.lu_solve(lu, piv, b)
    if factor.kind == QR:
        q, r = factor.data
        return torch.linalg.solve_triangular(r, q.mT @ b, upper=True)
    if factor.kind == LL:
        (c,) = factor.data
        return torch.cholesky_solve(b, c)
    raise ValueError(f"unknown factorization kind {factor.kind}")


def lu_factor_blocks(a: torch.Tensor, check: bool = True):
    """f64 LU factors and pivots of each block of ``a`` (``[k, n, n]``);
    raises ``torch.linalg.LinAlgError`` naming the first singular block.
    With ``check`` off it does not look: a singular block factors as it
    comes out (a zero pivot), its solves give inf or NaN, the other blocks
    are untouched, and the call reads nothing back (the interior point's
    step, where a singular KKT must come back non-finite).

    On the CPU one batched call. On the card one cuSOLVER getrf per block,
    each on a stream of its own: a getrf of a few thousand rows is bound by
    its column-by-column latency, not by the card's rate, so the blocks'
    factorizations overlap; PyTorch's batched call goes to MAGMA's batched
    getrf, which is slower at these sizes (PERF.md, section 5). Either way
    one readback of the factorizations' ``info`` follows when ``check`` is
    on."""
    if a.device.type != "cuda":
        lu, piv, info = torch.linalg.lu_factor_ex(a)
    else:
        lu = torch.empty_like(a)
        piv = torch.empty(a.shape[:-1], dtype=torch.int32, device=a.device)
        info = torch.empty(a.shape[:-2], dtype=torch.int32, device=a.device)
        main = torch.cuda.current_stream(a.device)
        streams = [torch.cuda.Stream(a.device) for _ in range(a.shape[0])]
        for blk, lu_b, piv_b, info_b, side in zip(a, lu, piv, info, streams):
            side.wait_stream(main)
            with torch.cuda.stream(side):
                torch.linalg.lu_factor_ex(blk, out=(lu_b, piv_b, info_b))
        for side in streams:
            main.wait_stream(side)
    if not check:
        return lu, piv
    singular = torch.nonzero(info).flatten().tolist()
    if singular:
        raise torch.linalg.LinAlgError(
            f"lu_factor_blocks: block {singular[0]} is singular (U's "
            f"diagonal element {int(info[singular[0]])} is zero)")
    return lu, piv


def batched_lu_solve2(a: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor,
                      check: bool = True):
    """One f64 LU of each block of ``a`` (``[k, n, n]``) and two solves
    against it: ``r1`` (``[k, n]`` or ``[k, n, m1]``) and ``r2``
    (``[k, n, m2]``). The BBD interior step; the JAX package's VMEM switch
    and its f32 factor with refinement sweeps are TPU-only and not ported.
    ``check`` as in ``lu_factor_blocks``."""
    mark("interior LU")
    lu, piv = lu_factor_blocks(a, check)
    mark("interior solves")
    vec = r1.dim() == a.dim() - 1
    y1 = torch.linalg.lu_solve(lu, piv, r1.unsqueeze(-1) if vec else r1)
    return (y1.squeeze(-1) if vec else y1), torch.linalg.lu_solve(lu, piv, r2)


def pw_lsq_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Peters-Wilkinson least squares: min ||A x - b|| via tall LU, in f64.

    Factor P A = L U (rectangular partial-pivoted LU, m x k with m >= k):
    L is unit lower trapezoidal with |L_ij| <= 1, so cond(LᵀL) stays O(1)
    even when extreme measurement weights make cond(AᵀA) overflow the
    normal equations — the reference's PW method
    (acStateEstimation.jl:933-971). Solve (LᵀL) y = Lᵀ P b (Cholesky),
    then U x = y. The factors are f64, so no refinement follows."""
    m, k = a.shape
    lu, pivots = torch.linalg.lu_factor(a)
    # LAPACK pivots: row i was swapped with row pivots[i] - 1, in order
    perm = np.arange(m)
    for i, p in enumerate(pivots.cpu().numpy() - 1):
        perm[i], perm[p] = perm[p], perm[i]
    low = torch.tril(lu, -1) + torch.eye(m, k, dtype=a.dtype, device=a.device)
    up = torch.triu(lu[:k, :])
    chol = torch.linalg.cholesky(low.mT @ low)
    rhs = low.mT @ b[torch.as_tensor(perm, device=a.device)]
    y = torch.cholesky_solve(rhs[:, None], chol)
    return torch.linalg.solve_triangular(up, y, upper=True)[:, 0]
