"""AC optimal power flow on the in-house interior point, on PyTorch tensors.

Port of ``juliagrid_tpu/opf/acopf.py`` (model parity with JuliaGrid
src/optimalPowerFlow/acOptimalPowerFlow.jl): variables V (bounded), θ
(slack fixed), Pg/Qg (capability boxes, out-of-service fixed at 0),
piecewise epigraph helpers for both power kinds (:436-484); nonlinear bus
balance from the Y-bus pattern (:517-567); trapezoidal P-Q capability-curve
cuts (:570-627); flow limits with the reference's type dispatch — 1 active
power, 2/3 apparent (3 squared), 4/5 current magnitude (5 squared), with
limit clamping and skip rules (checkLimit, :695-703); angle-difference
constraints (:495-514); objective = full polynomial costs plus piecewise
affine/epigraph terms, for active and reactive costs.

The spec keeps the JAX package's host lists (``v_lo``, ``p_hi``,
``curve_cuts``, ``flows``, ``angles``, ``pw_cuts_p``, ``poly_terms``, ...)
and its emission order, so ``ineq_tags`` and the dual harvest line up.
``_finalize`` turns the lists into index and coefficient tensors
(``AcOpfArrays``, built by ``convert.acopf_arrays_from_numpy``), and the
problem functions are gathers, a Horner loop and one sum over the Y-bus
rows each for P and Q, on ``x`` of shape ``[..., n_x]`` (the line search
probes every step length in one batch). The sums over an index run in a
fixed order (``ops/segments.py``), so one input gives the interior point
one trajectory on the card. Admittances stay real pairs (``yg``/``yb``,
the flow rows' ``fl_y``) as in the JAX package: the hand kernel reads them
so, and the two packages then round alike.

The constraint Jacobians and the Lagrangian's Hessian come from K6
(``kernels/opf_fill.py``): one launch fills J_E and J_I, one the Hessian; on
the CPU its plain version, the torch transcription of the JAX package's
``jac_eq``/``jac_ineq``/``hess``. The Jacobian pair of one point is kept, so
``jac_eq(x)`` and ``jac_ineq(x)`` at the same ``x`` cost one launch.

From ``_KKT_BBD_AUTO`` buses (or with ``solve(kkt_blocks=k)``) the interior
point's KKT is the structured BBD KKT of ``opf/kkt_bbd.py`` instead: K7
(``kernels/kkt_fill.py``) fills its blocks, and no dense Jacobian or
Hessian is formed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.opf_fill import OpfFillTable, opf_fill
from ..ops.segments import segment_sum
from ..postprocessing.results import AcPower, Cartesian
from ..powerflow.ac import Polar
from ..system.model import model
from ..system.types import PowerSystem
from .dcopf import OpfMethod
from .ipm import NlpProblem, solve_nlp

# buses from which the KKT goes to the structured BBD solve (opf/kkt_bbd.py),
# as in the JAX package: at 10,000 buses the dense (n_x + m_E)² f64 KKT is
# 15.5 GB, and the step holds three of them
_KKT_BBD_AUTO = 4000


class AcOpfArrays(NamedTuple):
    """Device tensors of an AC OPF spec (``convert.acopf_arrays_from_numpy``).
    Index tensors hold positions in the group they gather from (bus,
    generator, flow row), as the JAX package's spec does."""

    rows: torch.Tensor      # i64[nnz] Y-bus entries, by row then column
    cols: torch.Tensor
    yg: torch.Tensor        # f64[nnz] their conductance and susceptance
    yb: torch.Tensor
    pd: torch.Tensor        # f64[n] demand
    qd: torch.Tensor
    gen_bus: torch.Tensor   # i64[g]
    gen_on: torch.Tensor    # bool[g]
    off_idx: torch.Tensor   # i64 out-of-service generators (Pg = Qg = 0)
    fixv_i: torch.Tensor    # fixed magnitudes and outputs (equality rows)
    fixv_b: torch.Tensor
    fixp_i: torch.Tensor
    fixp_b: torch.Tensor
    fixq_i: torch.Tensor
    fixq_b: torch.Tensor
    vlo_i: torch.Tensor     # simple bounds
    vlo_b: torch.Tensor
    vhi_i: torch.Tensor
    vhi_b: torch.Tensor
    plo_i: torch.Tensor
    plo_b: torch.Tensor
    phi_i: torch.Tensor
    phi_b: torch.Tensor
    qlo_i: torch.Tensor
    qlo_b: torch.Tensor
    qhi_i: torch.Tensor
    qhi_b: torch.Tensor
    cc_i: torch.Tensor      # capability-curve cuts
    cc_aq: torch.Tensor
    cc_ap: torch.Tensor
    cc_b: torch.Tensor
    fl_fb: torch.Tensor     # i64[F] flow rows: from and to bus,
    fl_tb: torch.Tensor
    fl_from: torch.Tensor   # bool[F] the row's end,
    fl_cls: torch.Tensor    # i64[F] its class 1-5,
    fl_y: torch.Tensor      # f64[4, F] gf, bf, gt, bt of its end,
    fl_lo: torch.Tensor     # f64[F] limits (squared where the class is)
    fl_hi: torch.Tensor
    fl_lo_sel: torch.Tensor  # i64 rows with a lower limit, with an upper
    fl_hi_sel: torch.Tensor
    an_f: torch.Tensor      # angle-difference limits
    an_t: torch.Tensor
    an_lo: torch.Tensor
    an_hi: torch.Tensor
    pwp_gi: torch.Tensor    # piecewise epigraph cuts, active then reactive
    pwp_hpos: torch.Tensor
    pwp_slope: torch.Tensor
    pwp_icept: torch.Tensor
    pwq_gi: torch.Tensor
    pwq_hpos: torch.Tensor
    pwq_slope: torch.Tensor
    pwq_icept: torch.Tensor
    poly: tuple             # ((x columns i64[k], coefficients f64[k, d+1]))
    fill: OpfFillTable      # K6's tables
    obj_const: float
    slack_angle: float
    n: int
    g: int
    n_hp: int
    n_hq: int
    n_x: int
    m_e: int
    m_i: int
    slack: int


@dataclass
class AcOptimalPowerFlow:
    system: PowerSystem
    voltage: Polar
    power: AcPower
    method: OpfMethod
    device: torch.device = None
    current: Optional[object] = None
    kind: str = "optimal_power_flow"
    _spec: Optional[object] = None
    _x0: Optional[np.ndarray] = None
    signature: dict = None

    def _refresh_spec(self):
        """Rebuild when the system moved past the captured revision
        (reference acOptimalPowerFlow.jl:275-283)."""
        rev = self.system.model.revision
        key = (rev.ac_model, rev.ac_pattern, rev.ac_optimization,
               rev.injection, rev.slack, rev.type)
        if self.signature != {"key": key}:
            model(self.system, "ac")
            old = self._spec
            self._spec = _AcSpec(self.system, self.device)
            if old is not None and old.n_x != self._spec.n_x:
                self._x0 = None
            if self._x0 is None:
                set_initial_point(self)
            else:
                # warm restart after a model edit: the carried iterate is a
                # previous optimum on its active bounds; push it strictly
                # inside (Ipopt's warm_start_bound_push) and re-seat the
                # epigraph helpers for the (possibly changed) cost curves
                self._x0 = np.array(self._x0)
                self._spec.push_inside(self._x0)
                if self._spec.n_hp or self._spec.n_hq:
                    self._spec.init_helpers(self._x0)
            self.signature = {"key": key}


class _AcSpec:
    """Host problem structure (the JAX package's lists) and its device
    tensors (``arrays``)."""

    def __init__(self, system: PowerSystem, device=None):
        model(system, "ac")
        self.device = resolve_device(device)
        n = system.bus.number
        g = system.generator.number
        bus = system.bus
        gen = system.generator
        self.n, self.g = n, g
        self.slack = bus.layout.slack
        self.slack_angle = float(bus.voltage.angle[self.slack])

        coo = system.model.ac.nodal.tocoo()
        order = np.lexsort((coo.col, coo.row))
        self.rows = coo.row[order].astype(np.int64)
        self.cols = coo.col[order].astype(np.int64)
        self.yg = np.asarray(coo.data[order].real)
        self.yb = np.asarray(coo.data[order].imag)

        self.pd = np.asarray(bus.demand.active.array[:n]).copy()
        self.qd = np.asarray(bus.demand.reactive.array[:n]).copy()
        self.gen_bus = gen.layout.bus.array[:g].astype(np.int64)
        self.gen_on = gen.layout.status.array[:g] == 1

        # ---- objective ---------------------------------------------------
        self.poly_terms = []       # (kind 'p'|'q', gen idx, coeff array)
        self.pw_cuts_p = []        # (gen, helper pos, slope, intercept)
        self.pw_cuts_q = []
        self.pw_gens_p = []
        self.pw_gens_q = []
        self.obj_const = 0.0

        for kind, cost, pw_gens, pw_cuts in (
                ("p", gen.cost.active, self.pw_gens_p, self.pw_cuts_p),
                ("q", gen.cost.reactive, self.pw_gens_q, self.pw_cuts_q)):
            for i in range(g):
                if not self.gen_on[i]:
                    continue
                cmodel = int(cost.model[i]) if i < len(cost.model) else 0
                if cmodel == 2 and i in cost.polynomial:
                    self.poly_terms.append(
                        (kind, i,
                         np.asarray(cost.polynomial[i], dtype=float)))
                elif cmodel == 1 and i in cost.piecewise:
                    pts = np.asarray(cost.piecewise[i])
                    if len(pts) == 2:
                        slope = ((pts[1, 1] - pts[0, 1])
                                 / (pts[1, 0] - pts[0, 0]))
                        icept = pts[0, 1] - pts[0, 0] * slope
                        self.poly_terms.append(
                            (kind, i, np.asarray([slope, icept])))
                    elif len(pts) > 2:
                        hpos = len(pw_gens)
                        pw_gens.append(i)
                        for k in range(1, len(pts)):
                            slope = ((pts[k, 1] - pts[k - 1, 1])
                                     / (pts[k, 0] - pts[k - 1, 0]))
                            if not np.isfinite(slope):
                                raise ValueError(
                                    "piecewise cost has infinite slope")
                            pw_cuts.append(
                                (i, hpos, slope,
                                 slope * pts[k - 1, 0] - pts[k - 1, 1]))
                    else:
                        raise ValueError(
                            "piecewise cost requires at least two points")

        self.n_hp = len(self.pw_gens_p)
        self.n_hq = len(self.pw_gens_q)
        self.n_x = 2 * n + 2 * g + self.n_hp + self.n_hq

        # ---- simple bounds and fixed values ------------------------------
        vmin = bus.voltage.min_magnitude.array[:n]
        vmax = bus.voltage.max_magnitude.array[:n]
        self.fix_v = [(i, float(vmin[i])) for i in range(n)
                      if np.isfinite(vmin[i]) and vmin[i] == vmax[i]]
        fixed_v = {i for i, _ in self.fix_v}
        self.v_lo = [(i, float(vmin[i])) for i in range(n)
                     if np.isfinite(vmin[i]) and i not in fixed_v]
        self.v_hi = [(i, float(vmax[i])) for i in range(n)
                     if np.isfinite(vmax[i]) and i not in fixed_v]

        cap = gen.capability
        self.p_lo, self.p_hi, self.q_lo, self.q_hi = [], [], [], []
        # lo == hi boxes are fixed outputs: equality rows, not two opposing
        # inequalities whose slacks could never both stay positive
        self.fix_p, self.fix_q = [], []
        for i in range(g):
            if not self.gen_on[i]:
                continue
            for lo_store, hi_store, fix_store, lo, hi in (
                    (self.p_lo, self.p_hi, self.fix_p,
                     cap.min_active[i], cap.max_active[i]),
                    (self.q_lo, self.q_hi, self.fix_q,
                     cap.min_reactive[i], cap.max_reactive[i])):
                if np.isfinite(lo) and lo == hi:
                    fix_store.append((i, float(lo)))
                    continue
                if np.isfinite(lo):
                    lo_store.append((i, float(lo)))
                if np.isfinite(hi):
                    hi_store.append((i, float(hi)))

        # capability-curve cuts (reference capabilityCurve, :570-627)
        self.curve_cuts = []
        self.curve_tags = []
        for i in range(g):
            if not self.gen_on[i]:
                continue
            low, up = cap.low_active[i], cap.up_active[i]
            if (low == 0.0 and up == 0.0) or low == up:
                continue
            if low >= up or cap.max_low_reactive[i] <= \
                    cap.min_low_reactive[i] or cap.max_up_reactive[i] <= \
                    cap.min_up_reactive[i]:
                raise ValueError("Capability curve is not correctly defined.")
            diff_p_inv = 1.0 / (up - low)
            min_low_p = cap.min_active[i] - low
            max_low_p = cap.max_active[i] - low

            diff_q = cap.max_up_reactive[i] - cap.max_low_reactive[i]
            max_q_min_p = cap.max_low_reactive[i] + min_low_p * diff_q \
                * diff_p_inv
            max_q_max_p = cap.max_low_reactive[i] + max_low_p * diff_q \
                * diff_p_inv
            if max_q_min_p < cap.max_reactive[i] \
                    or max_q_max_p < cap.max_reactive[i]:
                dq = cap.max_low_reactive[i] - cap.max_up_reactive[i]
                dp = up - low
                b = dq * low + dp * cap.max_low_reactive[i]
                scale = 1.0 / np.sqrt(dq**2 + dp**2)
                self.curve_cuts.append((i, scale * dq, scale * dp, scale * b))
                self.curve_tags.append((i, "capability_upper"))

            diff_q = cap.min_up_reactive[i] - cap.min_low_reactive[i]
            min_q_min_p = cap.min_low_reactive[i] + min_low_p * diff_q \
                * diff_p_inv
            min_q_max_p = cap.min_low_reactive[i] + max_low_p * diff_q \
                * diff_p_inv
            if min_q_min_p > cap.min_reactive[i] \
                    or min_q_max_p > cap.min_reactive[i]:
                dq = cap.min_up_reactive[i] - cap.min_low_reactive[i]
                dp = low - up
                b = dq * low + dp * cap.min_low_reactive[i]
                scale = 1.0 / np.sqrt(dq**2 + dp**2)
                self.curve_cuts.append((i, scale * dq, scale * dp, scale * b))
                self.curve_tags.append((i, "capability_lower"))

        # flow constraints (from/to, type dispatch)
        m = system.branch.number
        br = system.branch
        ac = system.model.ac
        self.flows = []
        for k in range(m):
            if br.layout.status[k] != 1:
                continue
            ftype = int(br.flow.type[k]) if len(br.flow.type) else 3
            sq = 2 if ftype in (3, 5) else 1
            for side, lo, hi in (
                    ("from", br.flow.min_from_bus[k], br.flow.max_from_bus[k]),
                    ("to", br.flow.min_to_bus[k], br.flow.max_to_bus[k])):
                lo, hi = float(lo), float(hi)
                if ftype != 1:
                    lo, hi = max(lo, 0.0), max(hi, 0.0)
                if (lo == 0.0 and hi == 0.0) or (np.isinf(lo)
                                                 and np.isinf(hi)):
                    continue
                fb, tb = int(br.layout.from_bus[k]), int(br.layout.to_bus[k])
                self.flows.append((k, side, ftype, fb, tb, lo ** sq,
                                   hi ** sq))

        self.angles = []
        two_pi = 2 * np.pi
        for k in range(m):
            if br.layout.status[k] != 1:
                continue
            lo = float(br.voltage.min_diff_angle[k]) if len(
                br.voltage.min_diff_angle) else -two_pi
            hi = float(br.voltage.max_diff_angle[k]) if len(
                br.voltage.max_diff_angle) else two_pi
            meaningful = ((np.isfinite(lo) and lo not in (0.0, -two_pi))
                          or (np.isfinite(hi) and hi not in (0.0, two_pi)))
            if meaningful:
                self.angles.append(
                    (int(br.layout.from_bus[k]), int(br.layout.to_bus[k]),
                     lo, hi, k))

        # branch two-port parameters of the flow expressions
        self.br_yff = ac.nodal_from_from
        self.br_yft = ac.nodal_from_to
        self.br_ytf = ac.nodal_to_from
        self.br_ytt = ac.nodal_to_to

        self.arrays = None
        self._finalize()

    def _finalize(self):
        """Re-derive the vectorized constraint arrays, the tag list and the
        device tensors from the bookkeeping lists. Called at build time and
        after live edits (opf/edit.py): O(constraints) numpy work, no
        system scan."""
        from ..convert import acopf_arrays_from_numpy

        def _pairs(lst):
            idx = np.asarray([i for i, _ in lst], dtype=np.int64)
            val = np.asarray([b for _, b in lst], dtype=np.float64)
            return idx, val

        self.vlo_i, self.vlo_b = _pairs(self.v_lo)
        self.vhi_i, self.vhi_b = _pairs(self.v_hi)
        self.fixv_i, self.fixv_b = _pairs(self.fix_v)
        self.fixp_i, self.fixp_b = _pairs(self.fix_p)
        self.fixq_i, self.fixq_b = _pairs(self.fix_q)
        self.plo_i, self.plo_b = _pairs(self.p_lo)
        self.phi_i, self.phi_b = _pairs(self.p_hi)
        self.qlo_i, self.qlo_b = _pairs(self.q_lo)
        self.qhi_i, self.qhi_b = _pairs(self.q_hi)
        cc = self.curve_cuts
        self.cc_i = np.asarray([c[0] for c in cc], dtype=np.int64)
        self.cc_aq = np.asarray([c[1] for c in cc], dtype=np.float64)
        self.cc_ap = np.asarray([c[2] for c in cc], dtype=np.float64)
        self.cc_b = np.asarray([c[3] for c in cc], dtype=np.float64)

        fl = self.flows
        self.fl_k = np.asarray([f[0] for f in fl], dtype=np.int64)
        self.fl_from = np.asarray([f[1] == "from" for f in fl], dtype=bool)
        self.fl_fb = np.asarray([f[3] for f in fl], dtype=np.int64)
        self.fl_tb = np.asarray([f[4] for f in fl], dtype=np.int64)
        self.fl_cls = np.asarray([f[2] for f in fl], dtype=np.int64)
        fl_lo = np.asarray([f[5] for f in fl], dtype=np.float64)
        fl_hi = np.asarray([f[6] for f in fl], dtype=np.float64)
        self.fl_has_lo = np.asarray(
            [np.isfinite(f[5]) and not (f[2] != 1 and f[5] == 0.0)
             for f in fl], dtype=bool)
        self.fl_has_hi = np.isfinite(fl_hi)
        self.fl_lo = np.where(self.fl_has_lo, fl_lo, 0.0)
        self.fl_hi = np.where(self.fl_has_hi, fl_hi, 0.0)

        an = self.angles
        self.an_f = np.asarray([a[0] for a in an], dtype=np.int64)
        self.an_t = np.asarray([a[1] for a in an], dtype=np.int64)
        self.an_lo = np.asarray([a[2] for a in an], dtype=np.float64)
        self.an_hi = np.asarray([a[3] for a in an], dtype=np.float64)

        def _cuts(cuts):
            gi = np.asarray([c[0] for c in cuts], dtype=np.int64)
            hpos = np.asarray([c[1] for c in cuts], dtype=np.int64)
            slope = np.asarray([c[2] for c in cuts], dtype=np.float64)
            icept = np.asarray([c[3] for c in cuts], dtype=np.float64)
            return gi, hpos, slope, icept

        self.pwp = _cuts(self.pw_cuts_p)
        self.pwq = _cuts(self.pw_cuts_q)

        # polynomial objective grouped by (kind, degree) for one Horner loop
        groups = {}
        for kind, i, coeffs in self.poly_terms:
            key = (kind, len(coeffs) - 1)
            groups.setdefault(key, ([], []))
            groups[key][0].append(i)
            groups[key][1].append(coeffs)
        self.poly_keys = list(groups.keys())
        self.poly_idx = [np.asarray(groups[k][0], dtype=np.int64)
                         for k in self.poly_keys]
        self.poly_co = [np.asarray(groups[k][1], dtype=np.float64)
                        for k in self.poly_keys]

        # the tag list in the emission order of ineq()
        tags = []
        tags += [("voltage_min", int(i)) for i in self.vlo_i]
        tags += [("voltage_max", int(i)) for i in self.vhi_i]
        tags += [("active_min", int(i)) for i in self.plo_i]
        tags += [("active_max", int(i)) for i in self.phi_i]
        tags += [("reactive_min", int(i)) for i in self.qlo_i]
        tags += [("reactive_max", int(i)) for i in self.qhi_i]
        tags += [(t, int(i)) for (i, t) in self.curve_tags]
        for k, f, has in zip(self.fl_k, self.fl_from, self.fl_has_lo):
            if has:
                tags.append((f"flow_{'from' if f else 'to'}_min", int(k)))
        for k, f, has in zip(self.fl_k, self.fl_from, self.fl_has_hi):
            if has:
                tags.append((f"flow_{'from' if f else 'to'}_max", int(k)))
        tags += [("angle_min", a[4]) for a in an]
        tags += [("angle_max", a[4]) for a in an]
        tags += [("piecewise_active", int(gi)) for gi in self.pwp[0]]
        tags += [("piecewise_reactive", int(gi)) for gi in self.pwq[0]]
        self.ineq_tags = tags

        n, g = self.n, self.g
        self.gen_off = np.flatnonzero(~self.gen_on)
        self.m_e = (2 * n + 1 + 2 * len(self.gen_off) + len(self.fixv_i)
                    + len(self.fixp_i) + len(self.fixq_i))
        # the rows of J_I of each constraint group, in the emission order of
        # ineq(), as (first row, count), and the simple bounds' columns: the
        # structured KKT (opf/kkt_bbd.py) indexes the duals and Σ by them
        self.ji_bound_cols = np.concatenate([
            np.asarray(cols, dtype=np.int64) for cols in (
                n + self.vlo_i, n + self.vhi_i, 2 * n + self.plo_i,
                2 * n + self.phi_i, 2 * n + g + self.qlo_i,
                2 * n + g + self.qhi_i)])
        r = 0
        self.ji_rows = {}
        for name, k in (("bound", len(self.ji_bound_cols)),
                        ("cc", len(self.cc_i)),
                        ("fl_lo", int(self.fl_has_lo.sum())),
                        ("fl_hi", int(self.fl_has_hi.sum())),
                        ("an_lo", len(self.an_f)), ("an_hi", len(self.an_f)),
                        ("pwp", len(self.pwp[0])),
                        ("pwq", len(self.pwq[0]))):
            self.ji_rows[name] = (r, k)
            r += k
        assert r == len(tags)
        self.m_i = r
        self.arrays = acopf_arrays_from_numpy(self, self.device)
        self._jac_cache = None

    def push_inside(self, x0):
        """Project the start strictly inside the simple-bound constraints
        (Ipopt's push_x0 / bound_push kappa_1 = 0.01): MATPOWER starts
        routinely sit outside their own boxes, which pins the IPM slacks at
        the boundary."""
        n, g = self.n, self.g
        kappa = 0.01

        def _clip(vec, lo_pairs, hi_pairs):
            lo = np.full(vec.shape, -np.inf)
            hi = np.full(vec.shape, np.inf)
            for i, b in lo_pairs:
                lo[i] = b
            for i, b in hi_pairs:
                hi[i] = b
            pl = np.where(np.isfinite(lo),
                          kappa * np.maximum(1.0, np.abs(lo)), 0.0)
            pu = np.where(np.isfinite(hi),
                          kappa * np.maximum(1.0, np.abs(hi)), 0.0)
            both = np.isfinite(lo) & np.isfinite(hi)
            width = np.where(both, hi - lo, np.inf)
            pl = np.minimum(pl, kappa * width)
            pu = np.minimum(pu, kappa * width)
            lo_eff = np.where(np.isfinite(lo), lo + pl, -np.inf)
            hi_eff = np.where(np.isfinite(hi), hi - pu, np.inf)
            return np.clip(vec, np.minimum(lo_eff, hi_eff),
                           np.maximum(lo_eff, hi_eff))

        x0[n:2 * n] = _clip(x0[n:2 * n], self.v_lo, self.v_hi)
        x0[2 * n:2 * n + g] = _clip(x0[2 * n:2 * n + g],
                                    self.p_lo, self.p_hi)
        x0[2 * n + g:2 * n + 2 * g] = _clip(
            x0[2 * n + g:2 * n + 2 * g], self.q_lo, self.q_hi)
        # fixed outputs/voltages start exactly at their fixed value
        for i, b in self.fix_v:
            x0[n + i] = b
        for i, b in self.fix_p:
            x0[2 * n + i] = b
        for i, b in self.fix_q:
            x0[2 * n + g + i] = b

    def init_helpers(self, x0):
        """Set the piecewise epigraph helpers to the piecewise cost at the
        starting outputs, so every epigraph cut holds at the start."""
        n, g = self.n, self.g
        for cuts, n_h, off, pq0 in (
                (self.pwp, self.n_hp, 2 * n + 2 * g,
                 x0[2 * n:2 * n + g]),
                (self.pwq, self.n_hq, 2 * n + 2 * g + self.n_hp,
                 x0[2 * n + g:2 * n + 2 * g])):
            gi, hpos, slope, icept = cuts
            if not len(gi):
                continue
            h = np.full(n_h, -np.inf)
            np.maximum.at(h, hpos, slope * pq0[gi] - icept)
            x0[off:off + n_h] = np.where(np.isfinite(h), h + 1e-3, 1.0)

    def start(self, system):
        """The starting point: the system's voltages and outputs, pushed
        inside the boxes, helpers on their cuts."""
        n, g = self.n, self.g
        x0 = np.zeros(self.n_x)
        x0[:n] = system.bus.voltage.angle.array[:n]
        x0[n:2 * n] = system.bus.voltage.magnitude.array[:n]
        x0[2 * n:2 * n + g] = system.generator.output.active.array[:g]
        x0[2 * n + g:2 * n + 2 * g] = \
            system.generator.output.reactive.array[:g]
        self.push_inside(x0)
        if self.n_hp or self.n_hq:
            self.init_helpers(x0)
        return x0

    # ---- NLP functions (x: [..., n_x]) ------------------------------------

    def objective(self, x):
        return acopf_objective(self.arrays, x)

    def eq(self, x):
        return acopf_eq(self.arrays, x)

    def ineq(self, x):
        return acopf_ineq(self.arrays, x)

    def _jacobians(self, x):
        """(J_E, J_I) at one point from one K6 launch, kept for the next
        call at the same ``x`` (the interior point asks for J_E and then
        J_I at one iterate)."""
        hit = self._jac_cache
        if hit is None or hit[0] is not x or hit[1] != x._version:
            fill = opf_fill(self.arrays, x)
            hit = (x, x._version, fill.jac_eq, fill.jac_ineq)
            self._jac_cache = hit
        return hit[2], hit[3]

    def jac_eq(self, x):
        return self._jacobians(x)[0]

    def jac_ineq(self, x):
        return self._jacobians(x)[1]

    def hess(self, x, y, z):
        return opf_fill(self.arrays, x, y, z).hess


def _injections(arr: AcOpfArrays, theta, v):
    vi = v[..., arr.rows]
    vj = v[..., arr.cols]
    th = theta[..., arr.rows] - theta[..., arr.cols]
    t1 = vi * vj * (arr.yg * torch.cos(th) + arr.yb * torch.sin(th))
    t2 = vi * vj * (arr.yg * torch.sin(th) - arr.yb * torch.cos(th))
    return segment_sum(torch.stack([t1, t2], -2), arr.rows, arr.n).unbind(-2)


def acopf_objective(arr: AcOpfArrays, x):
    n, g = arr.n, arr.g
    val = x.new_full(x.shape[:-1], arr.obj_const)
    for cols, co in arr.poly:
        pq = x[..., cols]
        acc = torch.zeros_like(pq)
        for j in range(co.shape[1]):  # Horner over the group's degree
            acc = acc * pq + co[:, j]
        val = val + acc.sum(-1)
    if arr.n_hp + arr.n_hq:
        val = val + x[..., 2 * n + 2 * g:].sum(-1)
    return val


def acopf_eq(arr: AcOpfArrays, x):
    """Balance rows (P then Q), the slack angle, Pg = Qg = 0 of the
    out-of-service generators, then the fixed magnitudes and outputs."""
    n, g = arr.n, arr.g
    theta, v = x[..., :n], x[..., n:2 * n]
    pg, qg = x[..., 2 * n:2 * n + g], x[..., 2 * n + g:2 * n + 2 * g]
    p_inj, q_inj = _injections(arr, theta, v)
    sup_p, sup_q = segment_sum(
        torch.where(arr.gen_on, torch.stack([pg, qg], -2), 0.0), arr.gen_bus,
        n).unbind(-2)
    out = [sup_p - p_inj - arr.pd, sup_q - q_inj - arr.qd,
           (theta[..., arr.slack] - arr.slack_angle)[..., None],
           pg[..., arr.off_idx], qg[..., arr.off_idx],
           v[..., arr.fixv_i] - arr.fixv_b, pg[..., arr.fixp_i] - arr.fixp_b,
           qg[..., arr.fixq_i] - arr.fixq_b]
    return torch.cat(out, -1)


def flow_values(arr: AcOpfArrays, theta, v):
    """The value of every flow row (``fl_*``) at the voltages: P, |S|,
    |S|², |I| or |I|² of its end by class, in real arithmetic."""
    fb, tb = arr.fl_fb, arr.fl_tb
    vfr = v[..., fb] * torch.cos(theta[..., fb])
    vfi = v[..., fb] * torch.sin(theta[..., fb])
    vtr = v[..., tb] * torch.cos(theta[..., tb])
    vti = v[..., tb] * torch.sin(theta[..., tb])
    gf, bf, gt, bt = arr.fl_y
    ire = gf * vfr - bf * vfi + gt * vtr - bt * vti
    iim = gf * vfi + bf * vfr + gt * vti + bt * vtr
    vr = torch.where(arr.fl_from, vfr, vtr)
    vi = torch.where(arr.fl_from, vfi, vti)
    pp = vr * ire + vi * iim        # Re(v conj(i))
    qq = vi * ire - vr * iim        # Im(v conj(i))
    s2 = pp * pp + qq * qq
    i2 = ire * ire + iim * iim
    floor = s2.new_tensor(1e-24)
    # the √ rows' value is exact; their gradient is 0 below the floor
    sqrt_s = torch.sqrt(torch.maximum(s2, floor))
    sqrt_i = torch.sqrt(torch.maximum(i2, floor))
    cls = arr.fl_cls
    return torch.where(cls == 1, pp, torch.where(
        cls == 2, sqrt_s, torch.where(
            cls == 3, s2, torch.where(cls == 4, sqrt_i, i2))))


def acopf_ineq(arr: AcOpfArrays, x):
    """Every inequality row (>= 0) in ``ineq_tags`` order."""
    n, g = arr.n, arr.g
    theta, v = x[..., :n], x[..., n:2 * n]
    pg, qg = x[..., 2 * n:2 * n + g], x[..., 2 * n + g:2 * n + 2 * g]
    out = [v[..., arr.vlo_i] - arr.vlo_b, arr.vhi_b - v[..., arr.vhi_i],
           pg[..., arr.plo_i] - arr.plo_b, arr.phi_b - pg[..., arr.phi_i],
           qg[..., arr.qlo_i] - arr.qlo_b, arr.qhi_b - qg[..., arr.qhi_i],
           arr.cc_b - arr.cc_aq * pg[..., arr.cc_i]
           - arr.cc_ap * qg[..., arr.cc_i]]
    if arr.fl_fb.numel():
        val = flow_values(arr, theta, v)
        out.append((val - arr.fl_lo)[..., arr.fl_lo_sel])
        out.append((arr.fl_hi - val)[..., arr.fl_hi_sel])
    diff = theta[..., arr.an_f] - theta[..., arr.an_t]
    out += [diff - arr.an_lo, arr.an_hi - diff]
    h0 = 2 * n + 2 * g
    for gi, hpos, slope, icept, pq, h in (
            (arr.pwp_gi, arr.pwp_hpos, arr.pwp_slope, arr.pwp_icept, pg,
             x[..., h0:h0 + arr.n_hp]),
            (arr.pwq_gi, arr.pwq_hpos, arr.pwq_slope, arr.pwq_icept, qg,
             x[..., h0 + arr.n_hp:])):
        out.append(icept - slope * pq[..., gi] + h[..., hpos])
    return torch.cat(out, -1)


def ac_optimal_power_flow(system: PowerSystem,
                          device=None) -> AcOptimalPowerFlow:
    """Reference acOptimalPowerFlow (acOptimalPowerFlow.jl:44-250) on
    ``device`` (default ``config.device``); the optimizer is the in-house
    interior point."""
    device = resolve_device(device)
    system.check_slack()
    model(system, "ac")
    spec = _AcSpec(system, device)
    n, g = spec.n, spec.g
    power = AcPower(generator=Cartesian(
        active=system.generator.output.active.array[:g].copy(),
        reactive=system.generator.output.reactive.array[:g].copy()))
    analysis = AcOptimalPowerFlow(
        system=system,
        voltage=Polar(system.bus.voltage.magnitude.array[:n].copy(),
                      system.bus.voltage.angle.array[:n].copy()),
        power=power,
        method=OpfMethod("ac_optimal_power_flow"),
        device=device,
    )
    analysis._spec = spec
    analysis._x0 = spec.start(system)
    return analysis


def solve(analysis: AcOptimalPowerFlow, max_iter: int = 300,
          tolerance: float = 1e-8, verbose: int = 0,
          max_seconds=None, kkt_blocks=None,
          kkt_mesh=None) -> AcOptimalPowerFlow:
    """Reference solve! — runs the interior point and harvests primal and
    duals. ``kkt_blocks``: the number of interior blocks of the structured
    BBD KKT (``opf/kkt_bbd.py``); ``None`` picks the JAX package's rule,
    the dense f64 KKT below ``_KKT_BBD_AUTO`` buses and ``max(8, n // 512)``
    blocks from there; ``0`` forces the dense KKT. ``kkt_mesh``: a
    ``parallel/mesh.py`` mesh with a ``block`` axis of ``kkt_blocks``
    ranks, each of which calls ``solve`` on the same analysis; the
    structured KKT's interior blocks then factor one a rank with the Schur
    reduction an all-reduce (``AcKktBbd(mesh=)``), and every rank ends at
    the same bits. Like the JAX package's, the mesh serves the structured
    KKT only (a dense KKT runs whole on each rank). A wall-clock budget
    would stop the ranks at different iterations, so ``max_seconds`` and
    ``kkt_mesh`` do not go together."""
    analysis._refresh_spec()
    spec = analysis._spec
    if kkt_mesh is not None and max_seconds is not None:
        raise ValueError("max_seconds cannot bound a solve over a mesh: "
                         "each rank's clock would stop it at another "
                         "iteration")
    # dual carry and the structured KKT are valid only against the same
    # constraint layout (two structural edits can keep the counts and
    # permute the rows)
    layout = (spec.n, tuple(spec.ineq_tags),
              tuple(i for i, _ in spec.fix_v),
              tuple(i for i, _ in spec.fix_p),
              tuple(i for i, _ in spec.fix_q))
    if kkt_blocks is None:
        kkt_blocks = max(8, spec.n // 512) if spec.n >= _KKT_BBD_AUTO else 0
    kkt = None
    if kkt_blocks:
        # keyed by the spec (held, not its id), the layout, the cost terms'
        # structure, the block count and the mesh: a numeric live edit
        # patches the spec in place and reuses the routed structure; a
        # structural edit changes the layout (or rebuilds the spec) and
        # re-routes
        costs = tuple((key, tuple(np.asarray(idx).tolist()))
                      for key, idx in zip(spec.poly_keys, spec.poly_idx))
        cache_key = (layout, costs, kkt_blocks, kkt_mesh)
        cache = getattr(analysis, "_kkt_cache", None)
        if cache is not None and cache[0] is spec and cache[1] == cache_key:
            kkt = cache[2]
        else:
            from .kkt_bbd import AcKktBbd
            kkt = AcKktBbd(spec, kkt_blocks, mesh=kkt_mesh)
            analysis._kkt_cache = (spec, cache_key, kkt)
    has_ineq = spec.m_i > 0
    problem = NlpProblem(objective=spec.objective, eq=spec.eq,
                         ineq=spec.ineq if has_ineq else None,
                         jac_eq=spec.jac_eq,
                         jac_ineq=spec.jac_ineq if has_ineq else None,
                         hess=spec.hess,
                         push_inside=spec.push_inside, kkt=kkt)
    warm = None
    prev = analysis.method.result
    if getattr(analysis, "_carry_duals", False) and prev is not None \
            and getattr(analysis.method, "_warm_layout", None) == layout:
        warm = (prev.y, prev.z, prev.s)
    analysis._carry_duals = False
    res = solve_nlp(problem, analysis._x0, max_iter=max_iter, tol=tolerance,
                    verbose=verbose, warm_duals=warm,
                    max_seconds=max_seconds, device=analysis.device)
    spec._jac_cache = None
    analysis.method._warm_layout = layout
    analysis.method.result = res
    analysis.method.iteration = res.iterations
    analysis.method.converged = res.converged
    analysis.method.objective = res.objective

    n, g = spec.n, spec.g
    analysis.voltage.angle = res.x[:n]
    analysis.voltage.magnitude = res.x[n:2 * n]
    pg = res.x[2 * n:2 * n + g].copy()
    qg = res.x[2 * n + g:2 * n + 2 * g].copy()
    pg[~spec.gen_on] = 0.0
    qg[~spec.gen_on] = 0.0
    analysis.power.generator = Cartesian(active=pg, reactive=qg)
    analysis._x0 = res.x
    analysis.method.dual = {
        "balance_active": res.y[:n],
        "balance_reactive": res.y[n:2 * n],
        "ineq": res.z,
        "ineq_tags": spec.ineq_tags,
    }
    return analysis


def set_initial_point(analysis: AcOptimalPowerFlow, source=None):
    """Reference setInitialPoint! — the start from the system, or from
    another analysis' voltages (and generator outputs, where it has
    them)."""
    spec = analysis._spec
    n, g = spec.n, spec.g
    if source is None:
        analysis._x0 = spec.start(analysis.system)
        return
    x0 = np.asarray(analysis._x0).copy()
    x0[:n] = source.voltage.angle[:n]
    if hasattr(source.voltage, "magnitude"):
        x0[n:2 * n] = source.voltage.magnitude[:n]
    if getattr(source, "power", None) is not None and \
            len(getattr(source.power.generator, "active", [])) == g:
        x0[2 * n:2 * n + g] = source.power.generator.active
        if len(getattr(source.power.generator, "reactive", [])) == g:
            x0[2 * n + g:2 * n + 2 * g] = source.power.generator.reactive
    spec.push_inside(x0)
    if spec.n_hp or spec.n_hq:
        spec.init_helpers(x0)
    analysis._x0 = x0
