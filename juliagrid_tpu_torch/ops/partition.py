"""Graph partitioning for the BBD substrate: recursive spectral bisection
with one-sided vertex separators.

A host copy of ``juliagrid_tpu/ops/partition.py`` (numpy/scipy only), kept
verbatim so that on one host both packages cut a grid into the same
blocks, border for border.

The BFS region-growing partitioner (ops/bbd.py `bbd_partition`) promotes
BOTH endpoints of every cross edge to the border; power networks have small
separators (near-planar, O(sqrt n)), which this module finds:

  1. recursive bisection: Fiedler-vector split at the median (shift-invert
     ``eigsh`` from a seeded start vector), with a BFS level-set fallback
     if the eigensolve fails;
  2. a minimum vertex separator of the cut edges via König's theorem
     (max bipartite matching -> min vertex cover), so each cut edge costs
     at most one border bus, not two;
  3. recursion on the separated halves until `n_blocks` parts; the border
     is the union of separators across levels.

The reference delegates ordering/partitioning to AMD/KLU inside
SuiteSparse (backend/utility.jl:470-562); here the partition feeds
block-parallel dense factorizations instead of a serial sparse
elimination tree.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _fiedler_order(adj: sp.csr_matrix, nodes: np.ndarray,
                   rng: np.random.Generator):
    """Order `nodes` by the Fiedler vector of their induced subgraph
    (spectral), falling back to BFS levels from a pseudo-peripheral node."""
    sub = adj[nodes][:, nodes].tocsr()
    ns = len(nodes)
    pattern = sp.csr_matrix(
        (np.ones(sub.nnz), sub.indices, sub.indptr), shape=sub.shape)
    deg = np.asarray(pattern.sum(axis=1)).ravel()
    lap = sp.diags(deg) - pattern
    try:
        from scipy.sparse.linalg import eigsh
        # shift-invert around a small negative sigma: robust Fiedler at
        # 10k+ nodes where LOBPCG stalls on power-grid spectra
        vals, vecs = eigsh(lap.astype(np.float64), k=2, sigma=-1e-2,
                           which="LM", tol=1e-8, maxiter=200,
                           v0=rng.standard_normal(ns))
        fiedler = vecs[:, np.argsort(vals)[1]]
        if not np.all(np.isfinite(fiedler)) or np.ptp(fiedler) < 1e-12:
            raise RuntimeError
        return np.argsort(fiedler, kind="stable")
    except Exception:
        # BFS level-set fallback from a pseudo-peripheral vertex
        start = 0
        for _ in range(2):
            level = np.full(ns, -1, dtype=np.int64)
            level[start] = 0
            frontier = [start]
            order = [start]
            while frontier:
                nxt = []
                for u in frontier:
                    for v in sub.indices[sub.indptr[u]:sub.indptr[u + 1]]:
                        if level[v] < 0:
                            level[v] = level[u] + 1
                            nxt.append(int(v))
                            order.append(int(v))
                frontier = nxt
            # restart from the farthest vertex (pseudo-peripheral)
            start = order[-1]
        # unreached vertices (disconnected) go last
        unreached = [u for u in range(ns) if level[u] < 0]
        return np.asarray(order + unreached, dtype=np.int64)


def _separate(adj: sp.csr_matrix, left: np.ndarray, right: np.ndarray):
    """Minimum vertex separator of the cut edges: König's theorem on the
    bipartite cut graph (max matching -> min vertex cover), so each cut
    edge costs at most one border bus and the separator is optimal for
    the given bisection."""
    from scipy.sparse.csgraph import maximum_bipartite_matching

    pos_l = {int(u): i for i, u in enumerate(left)}
    pos_r = {int(v): i for i, v in enumerate(right)}
    in_right = np.zeros(adj.shape[0], dtype=bool)
    in_right[right] = True

    cut_r, cut_c = [], []
    for u in left:
        for v in adj.indices[adj.indptr[u]:adj.indptr[u + 1]]:
            if in_right[v]:
                cut_r.append(pos_l[int(u)])
                cut_c.append(pos_r[int(v)])
    if not cut_r:
        return left, right, np.zeros(0, dtype=np.int64)

    bip = sp.csr_matrix((np.ones(len(cut_r)), (cut_r, cut_c)),
                        shape=(len(left), len(right)))
    match_of_r = maximum_bipartite_matching(bip, perm_type="row")
    match_of_l = np.full(len(left), -1, dtype=np.int64)
    for j, i in enumerate(match_of_r):
        if i >= 0:
            match_of_l[i] = j

    # König alternating BFS from unmatched left vertices
    bip_csr = bip
    vis_l = match_of_l < 0
    vis_r = np.zeros(len(right), dtype=bool)
    frontier = list(np.flatnonzero(vis_l))
    while frontier:
        nxt = []
        for i in frontier:
            for j in bip_csr.indices[bip_csr.indptr[i]:bip_csr.indptr[i + 1]]:
                if not vis_r[j]:
                    vis_r[j] = True
                    i2 = match_of_r[j]
                    if i2 >= 0 and not vis_l[i2]:
                        vis_l[i2] = True
                        nxt.append(int(i2))
        frontier = nxt
    # min cover = (L not reached) ∪ (R reached)
    sep = np.concatenate([left[~vis_l & (match_of_l >= 0)], right[vis_r]])
    sep_arr = np.asarray(sorted(set(sep.tolist())), dtype=np.int64)
    keep = np.ones(adj.shape[0], dtype=bool)
    keep[sep_arr] = False
    return left[keep[left]], right[keep[right]], sep_arr


def nd_partition(adjacency: sp.spmatrix, n_blocks: int, seed: int = 7):
    """Partition into `n_blocks` interiors + border via recursive spectral
    bisection with one-sided vertex separators.

    Returns (block_of, border): block_of[u] in [0, n_blocks) for interior
    buses, -1 for border buses. No adjacency edge joins two different
    interiors (the BBD routing invariant).
    """
    adj = sp.csr_matrix(adjacency)
    adj = adj + adj.T  # symmetrize pattern
    adj.setdiag(0)
    adj.eliminate_zeros()
    n = adj.shape[0]
    rng = np.random.default_rng(seed)

    parts = [np.arange(n, dtype=np.int64)]
    seps: list = []
    while len(parts) < n_blocks:
        # split the largest part
        parts.sort(key=len, reverse=True)
        nodes = parts.pop(0)
        if len(nodes) <= 1:
            parts.append(nodes)
            break
        order = _fiedler_order(adj, nodes, rng)
        half = len(nodes) // 2
        left = nodes[order[:half]]
        right = nodes[order[half:]]
        left, right, sep = _separate(adj, left, right)
        seps.append(sep)
        parts.extend([left, right])

    block_of = np.full(n, -1, dtype=np.int64)
    for b, nodes in enumerate(parts):
        block_of[nodes] = b
    border = (np.asarray(sorted(set(np.concatenate(seps)))) if seps
              else np.zeros(0, dtype=np.int64))

    # safety: verify the invariant, promoting violators (shouldn't happen)
    for u in range(n):
        bu = block_of[u]
        if bu < 0:
            continue
        for v in adj.indices[adj.indptr[u]:adj.indptr[u + 1]]:
            if block_of[v] >= 0 and block_of[v] != bu:
                block_of[u] = -1
                border = np.union1d(border, [u])
                break
    return block_of, border
