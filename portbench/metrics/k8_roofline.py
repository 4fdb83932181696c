"""K8 (``kernels.gain_fill``) against its roofline.

Counted by the work the inputs need: the gain G = HᵀWH is symmetric and
as sparse as H's pattern makes it, so its need is its structural entries
on and below the diagonal (L of them, over the estimator's N states), and
HᵀWr. The rest of a dense G is zeros and mirror images, which the
program may write but the inputs do not ask for (as K1's zeros). One
launch for B scenarios reads H's E structural entries and the m
residuals of each scenario, the m weights and H's pattern (a column index
an entry, m + 1 row pointers) once, and writes each G's L entries and
its rhs of N; 3 f64 operations a product of two of a row's entries (the
pairs on and below the diagonal, P of them), w·r once a row and 2 an
entry for the rhs."""

from portbench.roofline import share


def count(b, order, rows, entries, gain_lower, pairs):
    nbytes = 8 * rows + 4 * entries + 4 * (rows + 1) + \
        b * (8 * entries + 8 * rows + 8 * gain_lower + 8 * order)
    return nbytes, b * (3.0 * pairs + rows + 2.0 * entries)


def read(run):
    s = run.shape
    return share(run, lambda k: "gain_fleet_kernel" in k
                 or "gain_fill_kernel" in k,
                 count(run.batch, s["states"], s["rows"], s["entries"],
                       s["gain_lower"], s["pairs"]))
