"""K2's Cholesky mode (``kernels.fleet_solve``) against its roofline.

Counted by the work the inputs need: one launch solves B gain systems of
the estimator's N states (the angles but the slack's, the magnitudes),
whatever order the program pads them to. It reads each gain's lower
triangle (N(N+1)/2 doubles) and b, and writes x and an int32 info; a
dense Cholesky with its two triangular solves is N³/3 + 2N² f64
operations a system."""

from portbench.roofline import share


def count(b, order):
    nbytes = b * (4 * order * (order + 1) + 16 * order + 4)
    return nbytes, b * (order ** 3 / 3.0 + 2.0 * order * order)


def read(run):
    return share(run, lambda k: "fleet_solve_kernel<true" in k,
                 count(run.batch, run.shape["states"]))
