"""K1 (``kernels.nr_fill``, dense mode) against its roofline.

Counted by the work the inputs need, as every kernel is: the power flow's
N unknowns (the angles at PV and PQ buses, the magnitudes at PQ buses)
and the structural entries of the Jacobian over them, J of them. One
launch for B scenarios of n buses on a Y bus of nnz structural entries
reads the Y bus once (a complex value and a column index an entry, n + 1
row pointers, n bus types) and each scenario's vm and va and its P and Q
schedules at the N equations, and writes each scenario's N mismatches and
J Jacobian entries (the matrix's zeros are not the inputs' work: a memset
writes them, or nothing); 22 f64 operations a Y entry and scenario."""

from portbench.roofline import share


def count(b, n, nnz, order, jac_entries):
    nbytes = 20 * nnz + 8 * n + 4 + b * (16 * n + 16 * order
                                         + 8 * jac_entries)
    return nbytes, 22.0 * nnz * b


def read(run):
    s = run.shape
    return share(run, lambda k: "nr_fill_kernel" in k,
                 count(run.batch, s["n"], s["nnz"], s["order"],
                       s["jac_entries"]))
