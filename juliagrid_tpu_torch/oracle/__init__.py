"""Independent sparse CPU oracle for the Newton-Raphson, fast decoupled and
DC power flows and the Gauss-Newton WLS state estimation."""

from .sparse_ref import (oracle_dc, oracle_fdpf, oracle_nr,  # noqa: F401
                         oracle_wls_se, oracle_ybus)
