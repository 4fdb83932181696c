"""K2's LU mode (``kernels.fleet_solve``) against its roofline.

Counted by the work the inputs need: one launch solves B Newton systems
of the power flow's N unknowns (the angles at PV and PQ buses, the
magnitudes at PQ buses), whatever order the program pads them to. It
reads each A (N² doubles) and b, and writes x and an int32 info; a dense
LU with its two triangular solves is 2N³/3 + 2N² f64 operations a
system."""

from portbench.roofline import share


def count(b, order):
    nbytes = b * (8 * order * order + 16 * order + 4)
    return nbytes, b * (2.0 * order ** 3 / 3 + 2.0 * order * order)


def read(run):
    return share(run, lambda k: "fleet_solve_kernel<false" in k,
                 count(run.batch, run.shape["order"]))
