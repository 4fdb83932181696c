"""Dense f64 linear algebra — the port's factorization substrate.

Replaces the reference's sparse direct solvers (KLU/UMFPACK/CHOLMOD/SPQR,
backend/utility.jl:470-587) with direct float64 solves through
``torch.linalg`` (cuSOLVER on the card, LAPACK on the CPU). The H100 has
native f64, so there is no f32 factor and no refinement sweep.

The ``kind`` tags (LU / KLU / QR / LL / LDLt) mirror the reference's
factorization menu; KLU aliases LU and LDLt aliases LL (Cholesky). Every
function takes a leading batch dimension as well: a fleet of scenario
Jacobians factors in one batched call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Public factorization tags (API parity with the reference exports).
LU = "LU"
KLU = "KLU"
QR = "QR"
LL = "LL"
LDLT = "LDLt"


class DenseFactor(NamedTuple):
    """Factorization of a dense (batch of) matrix."""

    kind: str      # "LU", "QR", or "LL"
    data: tuple    # factor tensors


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
    rhs = b.unsqueeze(-1)
    if factor.kind == LU:
        lu, piv = factor.data
        x = torch.linalg.lu_solve(lu, piv, rhs)
    elif factor.kind == QR:
        q, r = factor.data
        x = torch.linalg.solve_triangular(r, q.mT @ rhs, upper=True)
    elif factor.kind == LL:
        (c,) = factor.data
        x = torch.cholesky_solve(rhs, c)
    else:
        raise ValueError(f"unknown factorization kind {factor.kind}")
    return x.squeeze(-1)
