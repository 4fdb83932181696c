"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version. Sources are built with nvcc at first use (``_build``).

K2 ``fleet_solve`` (the fleets' dense f64 LU and Cholesky solves) is
exported here; the other kernel modules are imported by their own names."""

from . import fleet_solve

__all__ = ["fleet_solve"]
