"""Device ms a fleet-wide linear solve spends in the library's dense
factorization and solve kernels (cuSOLVER, cuBLAS, MAGMA through
``torch.linalg``), by kernel name, per lockstep solve: an NR step, or a
GN increment (a call makes one more increment than its largest count).
PyTorch's own kernels around the calls (copies, ``triu_tril``, pivots'
unpacking) are not counted."""

from portbench.roofline import kernel_time

#: stems of BLAS, LAPACK and MAGMA kernels' names (lower case)
LIBRARY = ("getrf", "getf2", "getrs", "potrf", "potrs", "trsm", "trsv",
           "gemm", "gemv", "syrk", "herk", "laswp", "amax", "swap", "dger",
           "dscal", "pivinfo", "ipiv", "computecolumn", "offsetpointer",
           "magma", "cublas", "cusolver", "trtri")


def library(name: str) -> bool:
    low = name.lower()
    return "at::native" not in low and any(s in low for s in LIBRARY)


def read(run):
    if run.trace is None:
        return None
    count, seconds = kernel_time(run, library)
    if count == 0:
        return None
    extra = run.shape["extra_solves"]
    solves = sum(c.lockstep + extra for c in run.calls)
    return 1e3 * seconds / solves
