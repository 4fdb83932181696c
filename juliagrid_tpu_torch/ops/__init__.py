"""Compute substrate: dense f64 linear algebra."""

from . import linalg
from .linalg import KLU, LDLT, LL, LU, PW, QR
