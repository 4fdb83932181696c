"""Selected sparse inverse (Takahashi) for residual-covariance diagonals.

The largest-normalized-residual test needs diag(H G⁻¹ Hᵀ). The dense path
(baddata._projection_diag) computes G⁻¹Hᵀ with a batched solve — O(n² m),
fine to a few thousand buses. At ACTIVSg scale the reference switches to a
selected inverse on the sparse factor (badData.jl:536-911: elimination
tree, symbolic factorization, Takahashi recurrences on the CHOLMOD/LU
factors). This is the host-side equivalent on a scipy sparse Cholesky-like
factorization.

Takahashi recurrence on A = L D Lᵀ: with Z = A⁻¹,

    Z[j, j]  = 1/d_j - Σ_{k>j, L[k,j]≠0} L[k, j] Z[k, j]
    Z[i, j]  = - Σ_{k>j, L[k,j]≠0} L[k, j] Z[max(i,k), min(i,k)]   (i > j)

evaluated in reverse column order over the pattern of L — only entries on
the factor's pattern are needed to obtain every Z entry on that pattern,
including the full diagonal.

The implementation is vectorized: Z lives in a flat array aligned with
L's CSC storage; the symmetric lookups Z[max, min] resolve through one
``searchsorted`` against the globally sorted (col·n + row) key array
(CSC order makes it sorted by construction), so each column's update is
a small dense matvec instead of Python dict recurrences — the round-1
dict version was O(minutes) at >10k states, this runs in seconds.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def ldl_factor(a: sp.spmatrix):
    """LDLᵀ factorization via scipy's unpivoted-friendly splu.

    The matrix is Jacobi-equilibrated first (unit diagonal) — without it
    the unpivoted factorization loses digits on >10k-state gain matrices
    with 1e4-spread weights and the recurrences blow up locally.

    Returns (L unit-lower csc, d diagonal, perm, dinv) with
    L D Lᵀ = As[ix(iperm, iperm)], As = Dinv A Dinv, Dinv = diag(dinv),
    iperm the inverse of ``perm`` — i.e. the permuted position of original
    index u is ``perm[u]``. Consumers must undo the scaling:
    A⁻¹ = Dinv Zs Dinv.
    """
    a = sp.csc_matrix(a)
    dinv = 1.0 / np.sqrt(np.maximum(a.diagonal(), 1e-300))
    a_s = (sp.diags(dinv) @ a @ sp.diags(dinv)).tocsc()
    lu = sp.linalg.splu(a_s, permc_spec="MMD_AT_PLUS_A",
                        options={"SymmetricMode": True},
                        diag_pivot_thresh=0.0)
    # for SPD A with symmetric mode, row and column permutations agree and
    # U = D Lᵀ. scipy's convention: L U = A[ix(iperm, iperm)] with iperm
    # the inverse of perm_c — permuted position of original index u is
    # perm_c[u].
    l = sp.csc_matrix(lu.L)
    u = sp.csc_matrix(lu.U)
    d = u.diagonal()
    perm = lu.perm_c
    return l, d, perm, dinv, lu


class _SelectedInverse:
    """Z = A⁻¹ on the pattern of L, with vectorized symmetric lookups."""

    def __init__(self, lc: sp.csc_matrix, d: np.ndarray):
        lc = lc.copy()
        lc.sort_indices()  # searchsorted + diag-first both require it
        n = lc.shape[0]
        indptr, indices, data = lc.indptr, lc.indices, lc.data
        self.n = n
        self.indptr = indptr
        self.indices = indices
        nnz = len(indices)
        # global sorted key per stored entry: col * n + row (CSC order)
        cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        self.keys = cols * n + indices.astype(np.int64)
        self.z = np.zeros(nnz + 1)  # +1: sentinel slot for missing pairs

        z = self.z
        for j in range(n - 1, -1, -1):
            lo, hi = indptr[j], indptr[j + 1]
            rows_j = indices[lo + 1:hi].astype(np.int64)
            vals_j = data[lo + 1:hi]
            if len(rows_j):
                # Zsub[t, s] = Z[max(k_t, i_s), min(k_t, i_s)]
                p = self.lookup(rows_j[:, None], rows_j[None, :])
                zsub = z[p]
                z_off = -(vals_j @ zsub)
                z[lo + 1:hi] = z_off
                z[lo] = 1.0 / d[j] - vals_j @ z_off
            else:
                z[lo] = 1.0 / d[j]

    def lookup(self, i, k):
        """Flat positions of Z[max(i,k), min(i,k)]; sentinel if absent."""
        col = np.minimum(i, k).astype(np.int64)
        row = np.maximum(i, k).astype(np.int64)
        key = col * self.n + row
        p = np.searchsorted(self.keys, key)
        p_safe = np.minimum(p, len(self.keys) - 1)
        return np.where(self.keys[p_safe] == key, p_safe, len(self.keys))

    def diagonal(self):
        return self.z[self.indptr[:-1]]


def takahashi_diag(a: sp.spmatrix) -> np.ndarray:
    """diag(A⁻¹) for sparse SPD A via the Takahashi selected inverse."""
    l, d, perm, dinv, _ = ldl_factor(a)
    sel = _SelectedInverse(l.tocsc(), d)
    # permuted position of original index u is perm[u]; undo equilibration
    return sel.diagonal()[perm] * dinv * dinv


def projection_diag_sparse(h: sp.spmatrix, w: np.ndarray,
                           mask_cols=None) -> np.ndarray:
    """c = diag(H G⁻¹ Hᵀ) with G = HᵀWH, using the selected inverse.

    Needs Z entries of G⁻¹ on the sparsity of HᵀH — which the factor
    pattern covers (fill-in only adds entries). For each measurement row
    h_r: c_r = Σ_{i,j∈supp(h_r)} h_ri h_rj Z[i, j], evaluated as one
    vectorized gather over all row pairs.
    """
    h = sp.csr_matrix(h)
    n = h.shape[1]
    g = (h.T.multiply(w) @ h).tocsc()
    if mask_cols is not None:
        m = np.ones(n)
        m[np.asarray(mask_cols)] = 0.0
        g = sp.diags(m) @ g @ sp.diags(m) + sp.diags(1.0 - m)
        h = h @ sp.diags(m)

    l, d, perm, dinv, lu = ldl_factor(g)
    sel = _SelectedInverse(l.tocsc(), d)

    # quadratic form per measurement row, all pairs flattened; the
    # equilibration folds into the row vectors: c_r = (D⁻¹h_r)ᵀ Zs (D⁻¹h_r)
    hp = (h @ sp.diags(dinv)).tocsr()
    nrows = hp.shape[0]
    lens = np.diff(hp.indptr)
    pc = perm[hp.indices]
    vals = hp.data
    # build pair index arrays: for row r with span [s, e), pairs are the
    # cartesian product of its entries
    pair_i, pair_k, pair_row = [], [], []
    for r in np.flatnonzero(lens):
        s, e = hp.indptr[r], hp.indptr[r + 1]
        idx = np.arange(s, e)
        ii, kk = np.meshgrid(idx, idx, indexing="ij")
        pair_i.append(ii.ravel())
        pair_k.append(kk.ravel())
        pair_row.append(np.full(ii.size, r, dtype=np.int64))
    if not pair_i:
        return np.zeros(nrows)
    pair_i = np.concatenate(pair_i)
    pair_k = np.concatenate(pair_k)
    pair_row = np.concatenate(pair_row)
    zvals = sel.z[sel.lookup(pc[pair_i], pc[pair_k])]
    contrib = vals[pair_i] * vals[pair_k] * zvals
    out = np.zeros(nrows)
    np.add.at(out, pair_row, contrib)

    # Leverage sanity check: w_r c_r ∈ [0, 1] exactly. On >10k-state gain
    # matrices with 1e4-spread weights the quadratic form cancels
    # catastrophically on a handful of high-leverage rows (Z entries reach
    # ~1/d_min while c_r is tiny); violating rows are re-solved exactly
    # against the already-computed factorization.
    lev = out * np.asarray(w)
    bad = np.flatnonzero((lev < -1e-9) | (lev > 1.0 + 1e-9))
    if len(bad):
        rhs = hp[bad].toarray().T  # (n, nbad), already D⁻¹-scaled
        x = lu.solve(rhs)          # splu applies its perms internally
        out[bad] = np.einsum("ij,ij->j", rhs, x)
    return out
