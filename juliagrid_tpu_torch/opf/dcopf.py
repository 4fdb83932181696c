"""DC optimal power flow on the in-house interior point, on PyTorch tensors.

Port of ``juliagrid_tpu/opf/dcopf.py`` (model parity with JuliaGrid
src/optimalPowerFlow/dcOptimalPowerFlow.jl): variables θ (all buses, slack
fixed) and Pg (all generators, out-of-service fixed at 0) plus epigraph
helpers for piecewise costs (>2 points); balance equalities with rhs =
demand + shunt conductance + shift power; capability boxes; flow limits
only when a bound is nonzero and finite; angle-difference limits when
meaningful; polynomial costs (last-3 quadratic truncation), 2-point
piecewise as affine, >2-point piecewise as epigraph cuts.

The spec keeps the JAX package's host lists (``cap_lo``, ``cap_hi``,
``fix_p``, ``flows``, ``angles``, ``pw_cuts``), in the same order, so the
inequality tags and the dual harvest line up. The JAX package emits its
rows one Python scalar at a time; here ``_finalize`` turns the lists into
index and coefficient tensors (``convert.dcopf_arrays_from_numpy``), so the
problem functions are a few gathers, one fixed-order sum of the outputs by
bus (``ops/segments.py``) and one matvec with the dense B, which is
scattered on the device from the DC nodal matrix. Every problem function takes ``x`` of shape ``[..., n_x]``. The
constraints are linear and the objective quadratic, so their Jacobians and
the Lagrangian's Hessian are scattered straight from the same tensors
(``dcopf_jac_eq``, ``dcopf_jac_ineq``, ``dcopf_hess``: the entries
``torch.func`` gives, without pushing n_x tangents through B each
iteration).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..postprocessing.results import Cartesian, DcPower
from ..powerflow.dc import Angle
from ..system.model import model
from ..ops.segments import segment_sum
from ..system.types import PowerSystem
from .ipm import IpmResult, NlpProblem, solve_nlp


class DcOpfArrays(NamedTuple):
    """Device tensors of a DC OPF spec. Inequality row r is
    ``a[r] * (x[i1[r]] - b[r] * x[i2[r]] - off[r]) + c0[r] + e[r] *
    x[i3[r]]``, which gives each family's row with the JAX package's
    arithmetic."""

    b_dense: torch.Tensor   # f64[n, n] DC nodal matrix B
    rhs: torch.Tensor       # f64[n] demand + shunt conductance + shift
    gen_bus: torch.Tensor   # i64[g]
    gen_on: torch.Tensor    # bool[g]
    off_idx: torch.Tensor   # i64 out-of-service generators (Pg = 0 rows)
    fix_idx: torch.Tensor   # i64 fixed-output generators
    fix_val: torch.Tensor   # f64 their outputs
    quad: torch.Tensor      # f64[g] objective coefficients
    lin: torch.Tensor       # f64[g]
    const: float
    i1: torch.Tensor        # i64[mI] inequality row gathers
    i2: torch.Tensor
    i3: torch.Tensor
    a: torch.Tensor         # f64[mI] inequality row coefficients
    b: torch.Tensor
    off: torch.Tensor
    c0: torch.Tensor
    e: torch.Tensor
    n: int
    g: int
    n_h: int
    slack: int
    slack_angle: float


@dataclass
class OpfMethod:
    name: str
    result: Optional[IpmResult] = None
    iteration: int = 0
    converged: bool = False
    objective: float = 0.0
    dual: dict = field(default_factory=dict)


@dataclass
class DcOptimalPowerFlow:
    system: PowerSystem
    voltage: Angle
    power: DcPower
    method: OpfMethod
    device: torch.device = None
    kind: str = "optimal_power_flow"
    _spec: Optional[object] = None
    #: warm-start state vector (reference setInitialPoint! semantics)
    _x0: Optional[np.ndarray] = None
    signature: dict = None

    def _refresh_spec(self):
        """Rebuild the problem structure when the system moved past the
        captured revision (reference dcOptimalPowerFlow solve! signature
        check, dcOptimalPowerFlow.jl:298-310)."""
        rev = self.system.model.revision
        key = (rev.dc_model, rev.dc_pattern, rev.dc_optimization,
               rev.injection, rev.slack)
        if self.signature != {"key": key}:
            model(self.system, "dc")
            old = self._spec
            self._spec = _DcSpec(self.system, self.device)
            if old is not None and old.n_x != self._spec.n_x:
                self._x0 = None
            if self._x0 is None:
                self._x0 = self._spec.start(self.system)
            self.signature = {"key": key}


class _DcSpec:
    """Host problem structure (lists, as the JAX package's) and its device
    tensors (``arrays``)."""

    def __init__(self, system: PowerSystem, device=None):
        model(system, "dc")
        n = system.bus.number
        g = system.generator.number
        gen = system.generator
        bus = system.bus

        self.device = resolve_device(device)
        self.n, self.g = n, g
        self.slack = bus.layout.slack
        self.slack_angle = float(bus.voltage.angle[self.slack])
        self.nodal = system.model.dc.nodal
        self.rhs = (bus.demand.active.array[:n]
                    + bus.shunt.conductance.array[:n]
                    + system.model.dc.shift_power)
        self.gen_bus = gen.layout.bus.array[:g].astype(np.int64)
        self.gen_on = gen.layout.status.array[:g] == 1

        self._build_objective(system)
        self.n_h = len(self.pw_gens)
        self.n_x = n + g + self.n_h

        cap_lo, cap_hi, fix_p = [], [], []
        for i in range(g):
            if not self.gen_on[i]:
                continue
            lo = gen.capability.min_active[i]
            hi = gen.capability.max_active[i]
            if np.isfinite(lo) and lo == hi:
                # fixed output: an equality row, not two opposing
                # inequalities (their slacks could never both stay > 0)
                fix_p.append((i, float(lo)))
                continue
            if np.isfinite(lo):
                cap_lo.append((i, float(lo)))
            if np.isfinite(hi):
                cap_hi.append((i, float(hi)))
        self.cap_lo = cap_lo
        self.cap_hi = cap_hi
        self.fix_p = fix_p

        m = system.branch.number
        br = system.branch
        flows = []
        for k in range(m):
            if br.layout.status[k] != 1:
                continue
            lo = br.flow.min_from_bus[k]
            hi = br.flow.max_from_bus[k]
            if (lo != 0.0 and np.isfinite(lo)) or (hi != 0.0
                                                   and np.isfinite(hi)):
                adm = system.model.dc.admittance[k]
                flows.append((int(br.layout.from_bus[k]),
                              int(br.layout.to_bus[k]),
                              float(adm), float(br.parameter.shift_angle[k]),
                              float(lo), float(hi), k))
        self.flows = flows

        angles = []
        two_pi = 2 * np.pi
        for k in range(m):
            if br.layout.status[k] != 1:
                continue
            lo = br.voltage.min_diff_angle[k] if len(
                br.voltage.min_diff_angle) else -two_pi
            hi = br.voltage.max_diff_angle[k] if len(
                br.voltage.max_diff_angle) else two_pi
            meaningful = ((np.isfinite(lo) and lo not in (0.0, -two_pi))
                          or (np.isfinite(hi) and hi not in (0.0, two_pi)))
            if meaningful:
                angles.append((int(br.layout.from_bus[k]),
                               int(br.layout.to_bus[k]), float(lo),
                               float(hi), k))
        self.angles = angles

        self.arrays = None
        self._finalize()

    def _build_objective(self, system):
        """(Re)derive the cost arrays and piecewise cuts from the system
        (reference addObjective/addPiecewise, DC variant). Live cost edits
        re-run this; if the epigraph helper count changes the caller must
        rebuild the spec (state size)."""
        g = self.g
        gen = system.generator
        self.pw_gens = []       # gens with >2 piecewise points
        self.pw_cuts = []       # (gen_pos_in_x, helper_pos, slope, intercept)
        self.obj_quad = np.zeros(g)
        self.obj_lin = np.zeros(g)
        self.obj_const = 0.0

        cost = gen.cost.active
        for i in range(g):
            if not self.gen_on[i]:
                continue
            cmodel = int(cost.model[i]) if i < len(cost.model) else 0
            if cmodel == 2:
                poly = cost.polynomial[i]
                if len(poly) >= 3:
                    self.obj_quad[i] = poly[-3]
                    self.obj_lin[i] = poly[-2]
                    self.obj_const += poly[-1]
                elif len(poly) == 2:
                    self.obj_lin[i] = poly[0]
                    self.obj_const += poly[1]
                elif len(poly) == 1:
                    self.obj_const += poly[0]
            elif cmodel == 1:
                pts = cost.piecewise[i]
                if len(pts) == 2:
                    slope = (pts[1, 1] - pts[0, 1]) / (pts[1, 0] - pts[0, 0])
                    self.obj_lin[i] += slope
                    self.obj_const += pts[0, 1] - pts[0, 0] * slope
                elif len(pts) > 2:
                    hpos = len(self.pw_gens)
                    self.pw_gens.append(i)
                    for k in range(1, len(pts)):
                        slope = ((pts[k, 1] - pts[k - 1, 1])
                                 / (pts[k, 0] - pts[k - 1, 0]))
                        if not np.isfinite(slope):
                            raise ValueError(
                                "piecewise cost has an infinite slope")
                        self.pw_cuts.append(
                            (i, hpos, slope,
                             slope * pts[k - 1, 0] - pts[k - 1, 1]))
                else:
                    raise ValueError(
                        "piecewise cost requires at least two points")

    def _finalize(self):
        """Rebuild the inequality tag registry in the EXACT emission order
        of ``ineq`` (all capability mins, all maxes, flows min/max per
        branch, angles, piecewise cuts) and the device tensors that follow
        the lists; live edits (opf/edit.py) re-run this after list
        surgery. B is scattered once and kept."""
        from ..convert import dcopf_arrays_from_numpy

        tags = []
        for i, _ in self.cap_lo:
            tags.append(("capability_min", i))
        for i, _ in self.cap_hi:
            tags.append(("capability_max", i))
        for (_f, _t, _adm, _phi, lo, hi, k) in self.flows:
            if np.isfinite(lo):
                tags.append(("flow_min", k))
            if np.isfinite(hi):
                tags.append(("flow_max", k))
        for (_f, _t, _lo, _hi, k) in self.angles:
            tags.append(("angle_min", k))
            tags.append(("angle_max", k))
        for (gi, _hpos, _slope, _icept) in self.pw_cuts:
            tags.append(("piecewise", gi))
        self.ineq_tags = tags
        self.arrays = dcopf_arrays_from_numpy(
            self, self.device,
            b_dense=self.arrays.b_dense if self.arrays is not None else None)

    def start(self, system):
        """The starting point: the system's angles and outputs, pushed
        inside the boxes, helpers on their cuts."""
        n, g = self.n, self.g
        x0 = np.zeros(self.n_x)
        x0[:n] = system.bus.voltage.angle.array[:n]
        x0[n:n + g] = system.generator.output.active.array[:g]
        self.push_inside(x0)
        if self.n_h:
            self.init_helpers(x0)
        return x0

    def init_helpers(self, x0):
        """Initialize epigraph helpers to the piecewise cost at the starting
        outputs so every cut holds at the initial point."""
        n, g = self.n, self.g
        if not self.n_h:
            return
        pg0 = x0[n:n + g]
        h = np.full(self.n_h, -np.inf)
        for gi, hpos, slope, icept in self.pw_cuts:
            h[hpos] = max(h[hpos], slope * pg0[gi] - icept)
        x0[n + g:] = np.where(np.isfinite(h), h + 1e-3, 1.0)

    def push_inside(self, x0):
        """Project the start strictly inside the capability boxes and set
        fixed outputs exactly (Ipopt push_x0)."""
        n, g = self.n, self.g
        kappa = 0.01
        lo = np.full(g, -np.inf)
        hi = np.full(g, np.inf)
        for i, b in self.cap_lo:
            lo[i] = b
        for i, b in self.cap_hi:
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
        x0[n:n + g] = np.clip(x0[n:n + g], np.minimum(lo_eff, hi_eff),
                              np.maximum(lo_eff, hi_eff))
        for i, b in self.fix_p:
            x0[n + i] = b

    # ---- NLP functions (x: [..., n_x]) ------------------------------------

    def objective(self, x):
        return dcopf_objective(self.arrays, x)

    def eq(self, x):
        return dcopf_eq(self.arrays, x)

    def ineq(self, x):
        return dcopf_ineq(self.arrays, x)

    # the constraints are linear and the objective quadratic: their
    # derivatives are constant, scattered from the tensors at each call
    # (torch.func would push n_x tangents through B every iteration)

    def jac_eq(self, x):
        return dcopf_jac_eq(self.arrays, x)

    def jac_ineq(self, x):
        return dcopf_jac_ineq(self.arrays, x)

    def hess(self, x, y, z):
        return dcopf_hess(self.arrays, x)


def dcopf_objective(arr: DcOpfArrays, x):
    n, g = arr.n, arr.g
    pg = x[..., n:n + g]
    val = (torch.sum(arr.quad * pg**2, -1) + torch.sum(arr.lin * pg, -1)
           + arr.const)
    if arr.n_h:
        val = val + torch.sum(x[..., n + g:], -1)
    return val


def dcopf_eq(arr: DcOpfArrays, x):
    """Balance rows, the slack-angle row, Pg = 0 of the out-of-service
    generators, then the fixed outputs."""
    n, g = arr.n, arr.g
    theta, pg = x[..., :n], x[..., n:n + g]
    inj = segment_sum(torch.where(arr.gen_on, pg, 0.0), arr.gen_bus, n)
    # one point (also each tangent of a vmapped Jacobian block): B θ, whose
    # batching rule is one matrix product; a batch of points: θ Bᵀ. The
    # broadcast B θ[..., None] would run a matrix-vector product per point
    b_theta = arr.b_dense @ theta if theta.dim() == 1 \
        else theta @ arr.b_dense.mT
    balance = inj - b_theta - arr.rhs
    out = [balance, (theta[..., arr.slack] - arr.slack_angle)[..., None],
           pg[..., arr.off_idx], pg[..., arr.fix_idx] - arr.fix_val]
    return torch.cat(out, -1)


def dcopf_ineq(arr: DcOpfArrays, x):
    return (arr.a * (x[..., arr.i1] - arr.b * x[..., arr.i2] - arr.off)
            + arr.c0 + arr.e * x[..., arr.i3])


def dcopf_jac_eq(arr: DcOpfArrays, x):
    """∂dcopf_eq/∂x at one point ``x`` [n_x], the same entries as
    ``torch.func.jacfwd``: -B and the generator incidence, then unit rows
    for the slack angle, the out-of-service and the fixed outputs."""
    n, g = arr.n, arr.g
    n_unit = arr.off_idx.numel() + arr.fix_idx.numel()
    jac = x.new_zeros((n + 1 + n_unit, x.shape[-1]))
    jac[:n, :n] = -arr.b_dense
    gens = torch.arange(g, device=x.device)
    jac[arr.gen_bus, n + gens] = arr.gen_on.to(x.dtype)
    jac[n, arr.slack] = 1.0
    rows = torch.arange(n + 1, n + 1 + n_unit, device=x.device)
    jac[rows, n + torch.cat([arr.off_idx, arr.fix_idx])] = 1.0
    return jac


def dcopf_jac_ineq(arr: DcOpfArrays, x):
    """∂dcopf_ineq/∂x at one point ``x`` [n_x]: row r holds a[r] at
    i1[r], -a[r]·b[r] at i2[r] and e[r] at i3[r] (summed where they
    meet)."""
    m = arr.a.numel()
    jac = x.new_zeros((m, x.shape[-1]))
    rows = torch.arange(m, device=x.device)
    for cols, vals in ((arr.i1, arr.a), (arr.i2, arr.a * -arr.b),
                       (arr.i3, arr.e)):
        jac.index_put_((rows, cols), vals, accumulate=True)
    return jac


def dcopf_hess(arr: DcOpfArrays, x):
    """The Lagrangian's Hessian at ``x`` [n_x]: the objective's 2·quad on
    the dispatch diagonal (every constraint is linear)."""
    n, g = arr.n, arr.g
    hess = x.new_zeros((x.shape[-1], x.shape[-1]))
    pos = torch.arange(n, n + g, device=x.device)
    hess[pos, pos] = 2.0 * arr.quad
    return hess


def dc_optimal_power_flow(system: PowerSystem,
                          device=None) -> DcOptimalPowerFlow:
    """Reference dcOptimalPowerFlow (dcOptimalPowerFlow.jl:44-198) on
    ``device`` (default ``config.device``); the optimizer is the in-house
    interior point."""
    device = resolve_device(device)
    system.check_slack()
    model(system, "dc")
    spec = _DcSpec(system, device)
    n, g = spec.n, spec.g
    power = DcPower(generator=Cartesian(
        active=system.generator.output.active.array[:g].copy()))
    analysis = DcOptimalPowerFlow(
        system=system,
        voltage=Angle(system.bus.voltage.angle.array[:n].copy()),
        power=power,
        method=OpfMethod("dc_optimal_power_flow"),
        device=device,
    )
    analysis._spec = spec
    analysis._x0 = spec.start(system)
    return analysis


def solve(analysis: DcOptimalPowerFlow, max_iter: int = 200,
          tolerance: float = 1e-8, verbose: int = 0) -> DcOptimalPowerFlow:
    """Reference solve! — runs the IPM and harvests primal/duals."""
    analysis._refresh_spec()
    spec = analysis._spec
    problem = NlpProblem(
        objective=spec.objective,
        eq=spec.eq,
        ineq=spec.ineq if spec.ineq_tags else None,
        jac_eq=spec.jac_eq,
        jac_ineq=spec.jac_ineq if spec.ineq_tags else None,
        hess=spec.hess,
        push_inside=spec.push_inside)
    # dual carry across live edits, guarded by the constraint layout
    # (reference setdual/transferdual!, optimalPowerFlow/utility.jl)
    layout = (spec.n, tuple(spec.ineq_tags),
              tuple(i for i, _ in spec.fix_p))
    warm = None
    prev = analysis.method.result
    if getattr(analysis, "_carry_duals", False) and prev is not None \
            and getattr(analysis.method, "_warm_layout", None) == layout:
        warm = (prev.y, prev.z, prev.s)
    analysis._carry_duals = False
    res = solve_nlp(problem, analysis._x0, max_iter=max_iter,
                    tol=tolerance, verbose=verbose, warm_duals=warm,
                    device=analysis.device)
    analysis.method._warm_layout = layout
    analysis.method.result = res
    analysis.method.iteration = res.iterations
    analysis.method.converged = res.converged
    analysis.method.objective = res.objective

    n, g = spec.n, spec.g
    theta = res.x[:n]
    pg = res.x[n:n + g].copy()
    pg[~spec.gen_on] = 0.0
    analysis.voltage.angle = theta
    analysis.power.generator = Cartesian(active=pg)
    analysis._x0 = res.x  # warm start for the next solve

    # dual harvest: balance duals then per-family inequality duals
    analysis.method.dual = {
        "balance": res.y[:n],
        "ineq": dict(zip(range(len(spec.ineq_tags)), res.z)),
        "ineq_tags": spec.ineq_tags,
    }
    return analysis


def set_initial_point(analysis: DcOptimalPowerFlow, source=None):
    """Reference setInitialPoint! — warm start from system or another
    analysis (acOptimalPowerFlow.jl:762-924 semantics, DC variant)."""
    spec = analysis._spec
    n, g = spec.n, spec.g
    system = analysis.system
    if source is None:
        x0 = np.concatenate([
            system.bus.voltage.angle.array[:n],
            system.generator.output.active.array[:g],
            np.ones(spec.n_h)])
        spec.push_inside(x0)
        spec.init_helpers(x0)
        analysis._x0 = x0
    else:
        x0 = np.asarray(analysis._x0).copy()
        x0[:n] = source.voltage.angle[:n]
        if hasattr(source, "power") and source.power is not None \
                and len(source.power.generator.active) == g:
            x0[n:n + g] = source.power.generator.active
        spec.push_inside(x0)
        spec.init_helpers(x0)
        analysis._x0 = x0
