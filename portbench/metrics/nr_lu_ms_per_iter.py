"""Device ms a single Newton-Raphson solve spends in the library's dense
factorization and solve kernels, per Newton step: the order-N Jacobian's
getrf and getrs above K2's cap, by the kernel name rule of
``dense_solve_ms_per_iter`` (cuSOLVER, cuBLAS, MAGMA; PyTorch's own
kernels not counted), over the steps the calls took."""

from portbench.metrics.dense_solve_ms_per_iter import library
from portbench.roofline import kernel_time


def read(run):
    if run.trace is None:
        return None
    count, seconds = kernel_time(run, library)
    steps = sum(c.lockstep + run.shape["extra_solves"] for c in run.calls)
    if count == 0 or steps == 0:
        return None
    return 1e3 * seconds / steps
