"""Independent sparse CPU oracle for the Newton-Raphson power flow and the
Gauss-Newton WLS state estimation."""

from .sparse_ref import oracle_nr, oracle_wls_se, oracle_ybus  # noqa: F401
