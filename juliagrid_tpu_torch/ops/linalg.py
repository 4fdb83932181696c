"""Dense f64 linear algebra — the port's factorization substrate.

Replaces the reference's sparse direct solvers (KLU/UMFPACK/CHOLMOD/SPQR,
backend/utility.jl:470-587) with direct float64 solves through
``torch.linalg`` (cuSOLVER on the card, LAPACK on the CPU). The H100 has
native f64, so there is no f32 factor and no refinement sweep.

The ``kind`` tags (LU / KLU / QR / LL / LDLt) mirror the reference's
factorization menu; KLU aliases LU and LDLt aliases LL (Cholesky).
``factorize``/``solve`` take a leading batch dimension as well: a fleet of
scenario Jacobians factors in one batched call. ``pw_lsq_solve`` is the
Peters-Wilkinson least-squares solve of the state estimator's PW tag.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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


def factorize(a: torch.Tensor, kind: str = LU) -> DenseFactor:
    """Factorize ``a`` (``[..., n, n]``) in f64.

    Mirrors reference ``factorization``; the dense path has no symbolic
    phase, so ``factorization!`` (numeric-only refresh) also lands here.
    """
    kind = {KLU: LU, LDLT: LL}.get(kind, kind)
    if kind == LU:
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
