"""Structured (BBD/Schur) KKT of the AC OPF interior point, on PyTorch.

Port of ``juliagrid_tpu/opf/kkt_bbd.py``. The interior point's condensed
augmented system

    [ W + J_Iᵀ Σ J_I + δI   J_Eᵀ  ] [ dx ]   [ rhs_x ]
    [ J_E                  -δc I  ] [ v  ] = [ rhs_e ]

is a dense (n_x + m_E)² matrix in ``opf/ipm.py``'s step: 15.5 GB in f64 at
10,000 buses. Every entry of it is local to the network: θ and V couple
along Y-bus entries, Pg/Qg and the epigraph helpers sit at their
generator's bus, a balance row's dual couples to its bus's neighbours, and
the flow and angle rows' J_IᵀΣJ_I fill-in rides branch edges. So the KKT
inherits the network's bordered-block-diagonal form, and the Schur solve of
the BBD power flow (``ops/bbd.py``) carries it:

  1. on the host, once per model structure: every KKT contribution as a
     static COO position (the cost diagonals, the 15 balance-Hessian
     stencils of each Y-bus entry, each flow row's 4x4 blocks, the
     Σ-weighted products of each inequality row, J_E and its transpose,
     the two diagonals), the owner bus of each augmented index, the bus
     graph partitioned by ``ops/partition.nd_partition`` (bit for bit the
     JAX package's), and each COO entry routed to an interior block, a
     locality-compressed border strip or the border block;
  2. on the device, at every step: K7 (``kernels/kkt_fill.py``) computes
     the COO values from their closed forms, Jacobi-equilibrates them and
     fills the padded blocks; the blocks go through ``bbd_solve_local``
     (one f64 LU per interior block, K5 for the border system, one border
     LU). No (m, n_x) or (n_x, n_x) matrix is formed.

The JAX package's f32 factorizations with refinement and its f64 LDLᵀ
endgame (``solve_f64``, ``bbd_solve_local_f64``) are TPU precision
machinery: the port factors in f64 with partial pivoting throughout, so
``solve`` is its one solve. The device-mesh mode (``mesh=``) is ROADMAP
item 15 and not ported.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch
from torch.func import grad, vmap

from ..kernels.kkt_fill import (check_route, je_groups, kkt_fill,
                                kkt_fill_table, kkt_fill_table_tensors)
from ..kernels.opf_fill import _flow_args, flow_row_value
from ..kernels.schur_gather import schur_route
from ..ops.bbd import BbdLocalArrays, bbd_solve_local
from ..ops.partition import nd_partition
from ..ops.segments import segment_sum
from ..utils.profiling import mark


class AcKktBbd:
    """Structured KKT of one ``_AcSpec`` constraint layout.

    Built on the host once per model structure (cached on the analysis by
    ``acopf.solve``); a numeric live edit keeps it, since the values are
    read from the spec's current tensors at every call. Implements the
    ``NlpProblem.kkt`` protocol: ``solve(x, y_s, z_s, sigma, delta, rhs_x,
    rhs_e, pk)`` and ``row_maxes(x)``, ``pk`` holding the interior point's
    objective scale ``sf`` and its row scales ``ge``/``gi`` (None: 1)."""

    def __init__(self, spec, n_blocks: int):
        t0 = time.perf_counter()
        self.spec = spec
        n, g = spec.n, spec.g
        self.n_x, self.m_e, self.m_i = spec.n_x, spec.m_e, spec.m_i
        n_aug = spec.n_x + spec.m_e
        self.n_aug = n_aug

        # ---- owner bus of every augmented index -------------------------
        owner = np.full(n_aug, -1, dtype=np.int64)
        gen_bus = np.asarray(spec.gen_bus)
        owner[:n] = np.arange(n)                      # theta
        owner[n:2 * n] = np.arange(n)                 # V
        owner[2 * n:2 * n + g] = gen_bus              # Pg
        owner[2 * n + g:2 * n + 2 * g] = gen_bus      # Qg
        off = 2 * n + 2 * g
        if spec.n_hp:
            owner[off:off + spec.n_hp] = gen_bus[np.asarray(spec.pw_gens_p)]
        off += spec.n_hp
        if spec.n_hq:
            owner[off:off + spec.n_hq] = gen_bus[np.asarray(spec.pw_gens_q)]
        # equality rows (emission order of _AcSpec.eq)
        nx = spec.n_x
        owner[nx:nx + n] = np.arange(n)               # P balance
        owner[nx + n:nx + 2 * n] = np.arange(n)       # Q balance
        owner[nx + 2 * n] = spec.slack                # slack angle row
        r = nx + 2 * n + 1
        k_off = len(spec.gen_off)
        if k_off:
            owner[r:r + k_off] = gen_bus[spec.gen_off]      # off Pg rows
            r += k_off
            owner[r:r + k_off] = gen_bus[spec.gen_off]      # off Qg rows
            r += k_off
        for idx, bus_of in ((spec.fixv_i, lambda i: i),
                            (spec.fixp_i, lambda i: gen_bus[i]),
                            (spec.fixq_i, lambda i: gen_bus[i])):
            if len(idx):
                owner[r:r + len(idx)] = bus_of(np.asarray(idx))
                r += len(idx)
        assert r == n_aug and (owner >= 0).all()
        self.owner = owner

        # ---- partition the bus graph, assign aug slots ------------------
        block_of, border = nd_partition(spec_pattern(spec, n), n_blocks)
        self.k = n_blocks
        self.block_of, self.border = block_of, border
        aug_blk = block_of[owner]                    # -1 for border buses
        groups = [np.flatnonzero(aug_blk == b) for b in range(n_blocks)]
        bdr = np.flatnonzero(aug_blk < 0)
        ni = max((len(gr) for gr in groups), default=1)
        mb = len(bdr)
        self.ni, self.mb = ni, mb
        aug_slot = np.zeros(n_aug, dtype=np.int64)
        for b, gr in enumerate(groups):
            aug_slot[gr] = np.arange(len(gr))
        aug_slot[bdr] = np.arange(mb)
        interior_idx = np.zeros((n_blocks, ni), dtype=np.int64)
        interior_mask = np.zeros((n_blocks, ni))
        for b, gr in enumerate(groups):
            interior_idx[b, :len(gr)] = gr
            interior_mask[b, :len(gr)] = 1.0
        self.interior_idx_np, self.border_idx_np = interior_idx, bdr
        # the identity tail on the padded interior diagonal slots
        self.pad = np.nonzero(interior_mask == 0.0)

        # ---- static COO structure (the emission order of _values) -------
        named = self._group_seq_static()
        rows = np.concatenate([np.asarray(r_, dtype=np.int64)
                               for _, r_, _ in named])
        cols = np.concatenate([np.asarray(c_, dtype=np.int64)
                               for _, _, c_ in named])
        self.rows, self.cols = rows, cols
        self.n_entries = len(rows)
        # the first COO position of each named group run
        self.bases, pos = {}, 0
        for name, r_, _ in named:
            self.bases.setdefault(name, pos)
            pos += len(r_)
        self.unit_pos = self._unit_positions(named)

        # entries whose owners sit in two different interiors can only be
        # structurally-zero Y positions (out-of-service branches kept in
        # the stored pattern): forced to 0.0 and sent to border (0, 0)
        br_ = aug_blk[rows]
        bc_ = aug_blk[cols]
        cross = (br_ >= 0) & (bc_ >= 0) & (br_ != bc_)
        self.cross = np.flatnonzero(cross)
        fam = np.where(cross, 3,
                       np.where((br_ >= 0) & (bc_ >= 0), 0,
                                np.where(br_ >= 0, 1,
                                         np.where(bc_ >= 0, 2, 3))))
        s_ii, s_ib, s_bi, s_bb = (np.flatnonzero(fam == f) for f in range(4))
        blk = np.where(aug_blk >= 0, aug_blk, 0)
        self.ii = (s_ii, blk[rows[s_ii]], aug_slot[rows[s_ii]],
                   aug_slot[cols[s_ii]])
        # ---- locality-compressed border couplings ----------------------
        # each block keeps only the border slots on its own frontier
        ib_blk = blk[rows[s_ib]].astype(np.int64)
        ib_col = aug_slot[cols[s_ib]].astype(np.int64)
        bi_blk = blk[cols[s_bi]].astype(np.int64)
        bi_row = aug_slot[rows[s_bi]].astype(np.int64)
        pairs = np.unique(np.concatenate([
            np.stack([ib_blk, ib_col], axis=1),
            np.stack([bi_blk, bi_row], axis=1)]), axis=0) \
            if len(ib_blk) + len(bi_blk) else np.zeros((0, 2), np.int64)
        counts = np.bincount(pairs[:, 0], minlength=n_blocks) \
            if len(pairs) else np.zeros(n_blocks, dtype=np.int64)
        mbl = max(int(counts.max()) if len(pairs) else 1, 1)
        self.mbl = mbl
        loc_of = np.zeros((n_blocks, max(mb, 1)), dtype=np.int64)
        bsel = np.full((n_blocks, mbl), mb, dtype=np.int64)
        bmask = np.zeros((n_blocks, mbl))
        for b in range(n_blocks):
            qs = pairs[pairs[:, 0] == b, 1] if len(pairs) \
                else np.zeros(0, np.int64)
            loc_of[b, qs] = np.arange(len(qs))
            bsel[b, :len(qs)] = qs
            bmask[b, :len(qs)] = 1.0
        self.bsel, self.bmask = bsel, bmask
        self.ib = (s_ib, ib_blk, aug_slot[rows[s_ib]], loc_of[ib_blk, ib_col])
        self.bi = (s_bi, bi_blk, loc_of[bi_blk, bi_row], aug_slot[cols[s_bi]])
        bb_r = np.where(cross[s_bb], 0, aug_slot[rows[s_bb]])
        bb_c = np.where(cross[s_bb], 0, aug_slot[cols[s_bb]])
        self.bb = (s_bb, bb_r, bb_c)

        # ---- K7's tables and the solve's index tensors, on the device ----
        dev = spec.device
        self.device = dev
        host = kkt_fill_table(self)
        check_route(host, self)
        self.table = kkt_fill_table_tensors(host, self, dev)
        self._rows = torch.as_tensor(rows, device=dev)
        self._cols = torch.as_tensor(cols, device=dev)
        self._interior_idx = torch.as_tensor(interior_idx, device=dev)
        self._interior_mask = torch.as_tensor(interior_mask, device=dev)
        self._border_idx = torch.as_tensor(bdr, device=dev)
        self._bsel = torch.as_tensor(bsel, device=dev)
        self._bmask = torch.as_tensor(bmask, device=dev)
        self.route = schur_route(bsel, mb, dev)
        #: seconds of this host build (partition, routing, K7's tables)
        self.build_s = time.perf_counter() - t0

    # ------------------------------------------------------------------
    # COO structure: (name, rows, cols) per group, concatenated. The
    # emission order here and in kernels/kkt_fill.py must match: both walk
    # the same group sequence guarded by the same length tests.
    # ------------------------------------------------------------------

    def _group_seq_static(self):
        spec = self.spec
        n, g, nx = spec.n, spec.g, spec.n_x
        re = np.asarray(spec.rows, dtype=np.int64)
        ce = np.asarray(spec.cols, dtype=np.int64)
        ar = np.arange(n)
        out = []

        # --- W: polynomial cost diagonals
        for (kind, deg), idx in zip(spec.poly_keys, spec.poly_idx):
            if deg < 2:
                continue
            col0 = 2 * n if kind == "p" else 2 * n + g
            out.append(("cost", col0 + idx, col0 + idx))

        # --- W: balance Hessian stencils (15 groups, length nnz)
        ti, tj = re, ce
        vic, vjc = n + re, n + ce
        for pos in ((ti, ti), (tj, tj), (ti, tj), (tj, ti),
                    (ti, vic), (vic, ti), (ti, vjc), (vjc, ti),
                    (tj, vic), (vic, tj), (tj, vjc), (vjc, tj),
                    (vic, vjc), (vjc, vic), (vic, vic)):
            out.append(("stencil",) + pos)

        # --- W: flow-row Hessian 4x4 blocks
        if len(spec.fl_k):
            fb, tb = spec.fl_fb, spec.fl_tb
            i4 = np.stack([fb, tb, n + fb, n + tb], axis=1)
            for a in range(4):
                for b in range(4):
                    out.append(("flow_h", i4[:, a], i4[:, b]))

        # --- W: J_Iᵀ Σ J_I products
        bc = spec.ji_bound_cols
        if len(bc):
            out.append(("bound", bc, bc))
        if len(spec.cc_i):
            cp = 2 * n + spec.cc_i
            cq = 2 * n + g + spec.cc_i
            for pos in ((cp, cp), (cp, cq), (cq, cp), (cq, cq)):
                out.append(("cc",) + pos)
        if len(spec.fl_k):
            for name, mask in (("flow_lo", spec.fl_has_lo),
                               ("flow_hi", spec.fl_has_hi)):
                if not mask.any():
                    continue
                i4m = i4[mask]
                for a in range(4):
                    for b in range(4):
                        out.append((name, i4m[:, a], i4m[:, b]))
        if len(spec.an_f):
            for pos in ((spec.an_f, spec.an_f), (spec.an_f, spec.an_t),
                        (spec.an_t, spec.an_f), (spec.an_t, spec.an_t)):
                out.append(("angle",) + pos)
        for name, cuts, pq0, h0 in (
                ("pwp", spec.pwp, 2 * n, 2 * n + 2 * g),
                ("pwq", spec.pwq, 2 * n + g, 2 * n + 2 * g + spec.n_hp)):
            gi, hpos = cuts[0], cuts[1]
            if len(gi):
                cp = pq0 + gi
                ch = h0 + hpos
                for pos in ((cp, cp), (cp, ch), (ch, cp), (ch, ch)):
                    out.append((name,) + pos)

        # --- W: delta regularization diagonal (closes the W section)
        out.append(("delta", np.arange(nx), np.arange(nx)))
        self.n_w = sum(len(r_) for _, r_, _ in out)

        # --- J_E groups (emitted at (nx+row, col), then the transpose)
        def _both(name, row, col):
            out.append((name, nx + row, col))
            out.append((name, col, nx + row))

        _both("je_p_theta", re, ce)          # P rows, theta cols (off-diag)
        _both("je_p_v", re, n + ce)          # P rows, V cols
        _both("je_p_theta_d", ar, ar)        # P diag theta
        _both("je_p_v_d", ar, n + ar)        # P diag V
        _both("je_q_theta", n + re, ce)      # Q rows, theta
        _both("je_q_v", n + re, n + ce)      # Q rows, V
        _both("je_q_theta_d", n + ar, ar)
        _both("je_q_v_d", n + ar, n + ar)
        gb = np.asarray(spec.gen_bus, dtype=np.int64)
        _both("je_pg", gb, 2 * n + np.arange(g))           # gen P columns
        _both("je_qg", n + gb, 2 * n + g + np.arange(g))   # gen Q columns
        _both("je_unit", np.asarray([2 * n]), np.asarray([spec.slack]))
        r = 2 * n + 1
        k_off = len(spec.gen_off)
        if k_off:
            _both("je_unit", r + np.arange(k_off), 2 * n + spec.gen_off)
            r += k_off
            _both("je_unit", r + np.arange(k_off),
                  2 * n + g + spec.gen_off)
            r += k_off
        for idx, col0 in ((spec.fixv_i, n), (spec.fixp_i, 2 * n),
                          (spec.fixq_i, 2 * n + g)):
            if len(idx):
                _both("je_unit", r + np.arange(len(idx)),
                      col0 + np.asarray(idx))
                r += len(idx)

        # --- equality diagonal regularization (-delta_c)
        out.append(("eq_diag", nx + np.arange(spec.m_e),
                    nx + np.arange(spec.m_e)))
        return out

    def _unit_positions(self, named):
        """``[2, m_E - 2n]``: the COO positions of each unit row of J_E
        (the slack, out-of-service and fixed rows, rows 2n..) and of its
        transpose."""
        nx, n = self.n_x, self.spec.n
        out = np.zeros((2, self.m_e - 2 * n), dtype=np.int64)
        pos = 0
        for i, (name, r_, c_) in enumerate(named):
            if name == "je_unit" and r_[0] >= nx:       # a block group
                rows_e = np.asarray(r_) - nx - 2 * n
                out[0, rows_e] = pos + np.arange(len(r_))
                out[1, rows_e] = pos + len(r_) + np.arange(len(r_))
            pos += len(r_)
        return out

    # ------------------------------------------------------------------
    # NlpProblem.kkt protocol
    # ------------------------------------------------------------------

    def _assemble(self, x, y_s, z_s, sigma, delta, pk):
        """K7 (its plain version on the CPU): the COO values, the
        equilibration ``d`` and the padded, equilibrated blocks
        (``BbdLocalArrays``, with K5's route) at one iterate."""
        mark("K7")
        fill = kkt_fill(self.table, self.spec.arrays, x, y_s, z_s, sigma,
                        delta, pk["sf"], pk.get("ge"), pk.get("gi"))
        arr = BbdLocalArrays(
            a_ii=fill.a_ii, a_ib=fill.a_ib, a_bi=fill.a_bi, a_bb=fill.a_bb,
            bsel=self._bsel, bmask=self._bmask,
            interior_idx=self._interior_idx,
            interior_mask=self._interior_mask, border_idx=self._border_idx,
            route=self.route)
        return fill.vals, fill.d, arr

    def _finish(self, vals, rhs, sol):
        """Unscaled residual check + curvature from the solved direction."""
        mark("residual")
        ax = segment_sum(vals * sol[self._cols], self._rows, rhs.numel(),
                         forward_ad=False)
        lin_res = (ax - rhs).abs().max() / (1.0 + rhs.abs().max())
        nw = self.n_w
        curv = (vals[:nw] * sol[self._rows[:nw]]
                * sol[self._cols[:nw]]).sum()
        return sol[:self.n_x], sol[self.n_x:], lin_res, curv

    def solve(self, x, y_s, z_s, sigma, delta, rhs_x, rhs_e, pk):
        """Solve the augmented system; returns (dx, v, lin_res, curv) with
        the dense step's conventions (v = -dy). A singular interior block
        or border system gives a non-finite solution (no raise), so that
        the interior point escalates δ."""
        vals, d, arr = self._assemble(x, y_s, z_s, sigma, delta, pk)
        rhs = torch.cat([rhs_x, rhs_e])
        sol = d * bbd_solve_local(arr, rhs * d, check=False)
        return self._finish(vals, rhs, sol)

    def row_maxes(self, x):
        """Per-row max|J| of the raw equality and inequality Jacobians at
        ``x`` from the same closed forms (no dense (m, n_x) matrix), for
        the gradient-based scaling; the inequality rows floored at 1.0 as
        the JAX package floors them. Plain PyTorch: it runs once a
        solve."""
        spec, arr = self.spec, self.spec.arrays
        rme = x.new_ones(spec.m_e)  # unit rows (slack/off/fix/gen cols)
        for rows, vals in je_groups(arr, x, spec.n):
            rme = rme.scatter_reduce(0, rows, vals.abs(), "amax")
        if not spec.m_i:
            return rme, x.new_zeros(0)
        rmi = x.new_ones(spec.m_i)

        def put(group, val):
            start, count = spec.ji_rows[group]
            if count:
                rmi[start:start + count] = val

        if len(spec.cc_i):
            put("cc", torch.maximum(arr.cc_aq.abs(), arr.cc_ap.abs()))
        if len(spec.fl_k):
            gz = vmap(grad(flow_row_value))(*_flow_args(arr, x))
            gmax = gz.abs().amax(dim=1)
            put("fl_lo", gmax[arr.fl_lo_sel])
            put("fl_hi", gmax[arr.fl_hi_sel])
        put("pwp", arr.pwp_slope.abs())
        put("pwq", arr.pwq_slope.abs())
        # floor at 1.0 everywhere: the gradient-based scale
        # min(1, 100/max) is unchanged for any true max in [floor, 100]
        return rme, rmi.clamp(min=1.0)


def spec_pattern(spec, n):
    """Bus-graph pattern (CSR, ones) from the spec's stored Y entries."""
    r = np.asarray(spec.rows)
    c = np.asarray(spec.cols)
    pat = sp.csr_matrix((np.ones(len(r)), (r, c)), shape=(n, n))
    pat.sum_duplicates()
    pat.data[:] = 1.0
    return pat
