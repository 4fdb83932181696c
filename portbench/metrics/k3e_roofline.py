"""K3's entry mode (``kernels.se_fill``) against its roofline.

Counted by the work the inputs need: H's structural entries over the
estimator's states (the slack's angle column is held, not solved). One
launch for B scenarios of n buses and m measurement rows reads the Y bus
once (a complex value and a column index an entry, n + 1 row pointers),
each row's 8-byte description and each branch-end row's five coefficients
(the pi model's four and the shift), and each scenario's vm, va and
means; it writes each scenario's h, residuals and H's E structural
entries over the states; 120 f64 operations a row and scenario."""

from portbench.roofline import share


def count(b, n, nnz, branches, rows, entries):
    nbytes = 20 * nnz + 4 * (n + 1) + 8 * rows + 40 * 4 * branches + \
        b * (16 * n + 24 * rows + 8 * entries)
    return nbytes, 120.0 * rows * b


def read(run):
    s = run.shape
    return share(run, lambda k: "se_entries_minor_kernel" in k
                 or "se_values_kernel" in k,
                 count(run.batch, s["n"], s["nnz"], s["branches"],
                       s["rows"], s["entries"]))
