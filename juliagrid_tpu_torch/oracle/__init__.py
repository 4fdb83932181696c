"""Independent sparse CPU oracle for the Newton-Raphson power flow."""

from .sparse_ref import oracle_nr, oracle_ybus  # noqa: F401
