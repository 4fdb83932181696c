"""Compute substrate: dense f64 linear algebra, the BBD Schur solves
(``bbd``) and the host partitioners (``partition``)."""

from . import linalg
from .linalg import KLU, LDLT, LL, LU, PW, QR
