"""AC power flow: Newton-Raphson on PyTorch tensors.

Port of ``juliagrid_tpu/powerflow/ac.py`` (itself a redesign of JuliaGrid
src/powerFlow/acPowerFlow.jl). The mismatch and the Jacobian come from one
launch of the hand-written CUDA kernel K1 (``kernels/nr_fill.py``) over the
Y-bus entry list, the linear solve is one launch of K2
(``kernels/fleet_solve.py``, a dense f64 LU and solve) up to its order cap
and a dense f64 ``torch.linalg`` factorization (``ops/linalg.py``) above
it, and the outer iteration is a host loop that reads back one pair of
scalars per iteration.

State formulation: the Newton system is solved at the unknowns' order N =
npv + 2·npq: the angles at PV and PQ buses, then the magnitudes at PQ
buses, each in bus order, the reference's pvpq/pq index remapping
(acPowerFlow.jl:89-175). ``AcArrays.pos`` maps each of the 2n polar
variables to its row (and column) of that system, or -1 where the variable
is fixed (the slack angle, non-PQ magnitudes); K1 writes the Jacobian
through it, and it is rebuilt with the bus types. The JAX package keeps the
2n x 2n Jacobian with the fixed rows and columns masked to identity;
``_nr_jacobian`` gives that layout for the parity tests.

Iteration-count semantics match the reference driver exactly
(acPowerFlow.jl:1389-1433): compute mismatch, stop if max|dP|,max|dQ| < tol,
stop if the iteration limit is reached, otherwise solve and increment.

The analysis object and its stepwise ``mismatch``/``solve`` also serve the
fast decoupled (``fast_decoupled.py``) and Gauss-Seidel
(``gauss_seidel.py``) methods and the bordered-block-diagonal variants
(``newton_bbd.py``, ``fast_decoupled.py``), which keep their own drivers
(``power_flow_bbd``, ``power_flow_fnr_bbd``) as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..kernels import fleet_solve
from ..kernels.nr_fill import NrFill, nr_fill
from ..ops import linalg
from ..report.log import info
from ..system.model import model
from ..system.types import PowerSystem
from ..utils.errors import SlackDefinitionError
from ..utils.profiling import Timings, default_timings, mark

#: method names of the fast decoupled analyses (``fast_decoupled.py``)
FAST_DECOUPLED = ("fast_newton_raphson_bx", "fast_newton_raphson_xb")


class AcArrays(NamedTuple):
    """Device snapshot of the AC network for the power-flow kernels."""

    rows: torch.Tensor     # i32[nnz] Y-bus entry row (bus of the injection eq.)
    cols: torch.Tensor     # i32[nnz] Y-bus entry column
    yg: torch.Tensor       # f64[nnz] Re(Y)
    yb: torch.Tensor       # f64[nnz] Im(Y)
    diag: torch.Tensor     # i32[n]   position of the diagonal entry per bus
    bus_type: torch.Tensor  # i32[n]  1 PQ, 2 PV, 3 slack
    slack: int             # slack bus index (host int: no device readback)
    p_sched: torch.Tensor  # f64[n] supply - demand, active
    q_sched: torch.Tensor  # f64[n] supply - demand, reactive
    row_ptr: torch.Tensor  # i32[n+1] CSR offsets of the sorted rows (K1)
    pos: torch.Tensor      # i32[2n] row of each angle, then each magnitude,
                           # in the Newton system; -1 where it is fixed
    unknowns: torch.Tensor  # i64[N] the variable (k or n + k) of each row
    order: int             # N = npv + 2 npq (host int, as ``slack``)


def newton_unknowns(bus_type, slack: int):
    """``(pos, unknowns)`` of the Newton system, in numpy: the unknowns are
    the angles of every bus but the slack and the magnitudes of PQ buses,
    in that order and each in bus order (the masked system's order with its
    fixed variables left out); ``pos`` (int32[2n]) gives each variable's
    row, -1 where it is fixed, and ``unknowns`` (int64[N]) the inverse."""
    bus_type = np.asarray(bus_type)
    n = len(bus_type)
    unknowns = np.flatnonzero(np.concatenate([np.arange(n) != slack,
                                              bus_type == 1]))
    pos = np.full(2 * n, -1, dtype=np.int32)
    pos[unknowns] = np.arange(len(unknowns), dtype=np.int32)
    return pos, unknowns.astype(np.int64)


def check_entry_list(rows, cols, diag, n: int) -> None:
    """Raise unless the entry list is what K1 relies on: sorted by
    (row, col), no (row, col) pair twice, and one diagonal entry per bus."""
    if np.any(np.diff(rows) < 0):
        raise ValueError("Y-bus entries are not sorted by row")
    same_row = rows[1:] == rows[:-1]
    if np.any(same_row & (cols[1:] <= cols[:-1])):
        raise ValueError("Y-bus entry list repeats a (row, col) pair or is "
                         "not sorted by column within a row")
    if (len(diag) != n or np.any(rows[diag] != np.arange(n))
            or np.any(cols[diag] != np.arange(n))):
        raise ValueError("every bus needs exactly one diagonal Y-bus entry")


def ac_entry_host(system: PowerSystem):
    """Host-side (rows, cols, vals, diag) of the Y-bus entry list, sorted
    by (row, col) — the numpy source of truth for every compile step
    (``convert.ac_arrays_from_numpy`` checks it before it reaches K1)."""
    model(system, "ac")
    coo = system.model.ac.nodal.tocoo()
    order = np.lexsort((coo.col, coo.row))
    rows = coo.row[order].astype(np.int32)
    cols = coo.col[order].astype(np.int32)
    vals = coo.data[order]
    diag = np.flatnonzero(rows == cols).astype(np.int32)
    return rows, cols, vals, diag


def compile_ac_arrays(system: PowerSystem, device=None) -> AcArrays:
    # convert.py builds AcArrays from numpy and imports this module
    from ..convert import ac_arrays_from_numpy

    rows, cols, vals, diag = ac_entry_host(system)
    n = system.bus.number
    bus = system.bus
    return ac_arrays_from_numpy(
        rows=rows, cols=cols, yg=vals.real, yb=vals.imag, diag=diag,
        bus_type=bus.layout.type.array[:n], slack=bus.layout.slack,
        p_sched=bus.supply.active.array[:n] - bus.demand.active.array[:n],
        q_sched=(bus.supply.reactive.array[:n]
                 - bus.demand.reactive.array[:n]),
        device=device)


# --------------------------------------------------------------------------
# Tensor kernels (single state ``[n]``; the step pieces also take ``[B, n]``)
# --------------------------------------------------------------------------

def _fill(arr: AcArrays, vm, va, jacobian: bool) -> NrFill:
    return nr_fill(arr, vm[None], va[None], arr.p_sched[None],
                   arr.q_sched[None], jacobian=jacobian)


def _injections(arr: AcArrays, vm, va):
    """Per-bus P, Q injections (equation library sweep,
    backend/equations.jl:101-144) from K1."""
    res = _fill(arr, vm, va, jacobian=False)
    return res.p[0], res.q[0]


def _mismatch(arr: AcArrays, vm, va):
    """Reference mismatch! (acPowerFlow.jl:645-685): active residuals on all
    non-slack buses, reactive residuals on PQ buses; returns max-abs pair."""
    res = _fill(arr, vm, va, jacobian=False)
    mp, mq = res.mp[0], res.mq[0]
    return mp, mq, mp.abs().amax(), mq.abs().amax()


def _masked_jacobian(arr: AcArrays, jac):
    """The 2n x 2n layout of the reduced ``[B, N, N]`` Jacobian ``jac``:
    its rows and columns at the unknowns' places, identity at the fixed
    variables (the JAX package's masked Jacobian)."""
    n2 = arr.pos.numel()
    full = jac.new_zeros(jac.shape[:-2] + (n2, n2))
    idx = arr.unknowns
    full[..., idx[:, None], idx] = jac
    full.diagonal(dim1=-2, dim2=-1)[..., arr.pos < 0] = 1.0
    return full


def _nr_jacobian(arr: AcArrays, vm, va):
    """Full 2n x 2n polar Jacobian with masked identity rows/cols (K1's
    reduced Jacobian laid out as the JAX package's), and the mask vector.
    Not on the solves' path."""
    jac = _fill(arr, vm, va, jacobian=True).jac[0]
    return _masked_jacobian(arr, jac), (arr.pos >= 0).to(vm.dtype)


def _max_mismatch(res: NrFill):
    """``[B, 2]`` per-scenario (max|dP|, max|dQ|)."""
    return torch.stack([res.mp.abs().amax(-1), res.mq.abs().amax(-1)], -1)


def _nr_rhs(arr: AcArrays, res: NrFill):
    """``[B, N]``: K1's mismatch at the unknowns, the Newton system's
    right-hand side."""
    return torch.cat([res.mp, res.mq], dim=-1).index_select(-1,
                                                            arr.unknowns)


def _nr_move(arr: AcArrays, vm, va, dx):
    """``(vm, va)`` less the step ``dx [B, N]`` at the unknowns; a fixed
    variable has 0.0 taken off, so it keeps its bits, as the masked route's
    ``torch.where`` gave."""
    n = vm.shape[-1]
    step = dx.new_zeros(dx.shape[:-1] + (2 * n,)).index_copy_(
        -1, arr.unknowns, dx)
    return vm - step[..., n:], va - step[..., :n]


def _nr_update(arr: AcArrays, vm, va, res: NrFill, kind: str,
               check: bool = True):
    """Newton step for ``[B, n]`` states from K1's output at those states.

    The system is the reduced one at the unknowns' order N (``res.jac``,
    ``[B, N, N]``), its right-hand side the mismatch gathered at the
    unknowns (``_nr_rhs``), and the step moves the unknowns only
    (``_nr_move``). An LU is ``fleet_lu_solve`` (no factors written),
    which picks K2 or the library route by device and order; the other
    kinds go to ``linalg.factorize``/``solve``. A singular Jacobian raises
    ``LinAlgError`` unless ``check`` is off: then a singular scenario's
    step comes out inf or NaN."""
    rhs = _nr_rhs(arr, res)
    if kind not in (linalg.LU, linalg.KLU):
        return _nr_move(arr, vm, va, linalg.solve(
            linalg.factorize(res.jac, kind, check), rhs))
    dx, bad = fleet_solve.fleet_lu_solve(res.jac, rhs)
    if check and bool(bad.any()):
        b = int(bad.ne(0).nonzero()[0, 0])
        j = int(bad[b]) - 1
        raise torch.linalg.LinAlgError(
            f"the Jacobian of scenario {b} is singular: U[{j},{j}] is zero")
    return _nr_move(arr, vm, va, dx)


def _nr_step(arr: AcArrays, vm, va, kind: str):
    """One Newton-Raphson solve: returns the updated state."""
    res = _fill(arr, vm, va, jacobian=True)
    vm_new, va_new = _nr_update(arr, vm[None], va[None], res, kind)
    return vm_new[0], va_new[0]


def _nr_solve(arr: AcArrays, vm, va, tol: float, max_iter: int, kind: str,
              fill=nr_fill):
    """Full NR loop: one K1 launch (mismatch and Jacobian at the current
    state) and one scalar-pair readback per iteration, then the solve.

    The count equals the number of linear solves, and convergence is judged
    on the freshly recomputed mismatch. ``fill`` exists so a check can run
    the same loop on ``nr_fill_ref``; the main path never passes it.

    Stages (``utils.profiling.mark``), in loop order: ``fill`` (K1 with its
    Jacobian's memset), ``test`` (the mismatch pair's readback) and
    ``solve`` (the factorization, the solve and the step); a solve of k
    iterations makes k + 1 ``fill`` and ``test`` stages."""
    vm, va = vm[None], va[None]
    ps, qs = arr.p_sched[None], arr.q_sched[None]
    try:
        mark("fill")
        res = fill(arr, vm, va, ps, qs, jacobian=True)
        it = 0
        while True:
            mark("test")
            del_p, del_q = _max_mismatch(res)[0].tolist()
            converged = del_p < tol and del_q < tol
            if converged or it >= max_iter:
                break
            mark("solve")
            vm, va = _nr_update(arr, vm, va, res, kind)
            it += 1
            mark("fill")
            res = fill(arr, vm, va, ps, qs, jacobian=True)
        return vm[0], va[0], it, del_p, del_q, converged
    finally:
        mark(None)


# --------------------------------------------------------------------------
# Analysis objects (host-side, reference AcPowerFlow wrappers)
# --------------------------------------------------------------------------

@dataclass
class Polar:
    magnitude: np.ndarray
    angle: np.ndarray


@dataclass
class MethodState:
    name: str
    factorization: str = linalg.LU
    iteration: int = 0
    converged: bool = False
    max_mismatch_active: float = np.inf
    max_mismatch_reactive: float = np.inf
    timings: Timings = field(default_factory=Timings)


@dataclass
class AcPowerFlow:
    system: PowerSystem
    voltage: Polar
    method: MethodState
    arrays: NamedTuple     # AcArrays, FnrArrays, GsArrays or NrBbdArrays
    device: torch.device
    power: Optional[object] = None
    current: Optional[object] = None
    signature: dict = field(default_factory=dict)

    def _refresh_arrays(self):
        """Signature staleness protocol: rebuild the device snapshot when the
        system moved past the captured revision (reference acPowerFlow.jl:
        802-811, 890-895 decides rebuild vs refactorize; the dense path
        treats both as a snapshot refresh). Each rebuild is a span
        ``pf.rebuild`` of ``default_timings``, whose count is the
        rebuilds."""
        rev = self.system.model.revision
        sig = self.signature
        if sig and (sig.get("type") != rev.type
                    or sig.get("slack") != rev.slack):
            # The pinned-row VALUES are state too: when the pin set moves
            # (bus type change, slack re-designation) the live state must
            # re-seed PV/slack magnitudes from generator setpoints and move
            # the angle datum to the new slack's stored angle — a uniform
            # shift that keeps the warm start (flows are datum-invariant)
            # while matching a fresh build's reference exactly (reference
            # changeSlackBus!, acPowerFlow.jl:1334-1358).
            magnitude, angle = initialize_ac_power_flow(self.system)
            bus = self.system.bus
            n = bus.number
            vm = np.asarray(self.voltage.magnitude, dtype=float).copy()
            va = np.asarray(self.voltage.angle, dtype=float).copy()
            pinned = np.asarray(bus.layout.type[:n]) != 1
            vm[pinned] = magnitude[pinned]
            slack = bus.layout.slack
            va = va + (angle[slack] - va[slack])
            self.voltage.magnitude = vm
            self.voltage.angle = va
        if (sig.get("ac_model") != rev.ac_model
                or sig.get("ac_pattern") != rev.ac_pattern
                or sig.get("type") != rev.type
                or sig.get("injection") != rev.injection
                or sig.get("slack") != rev.slack):
            with default_timings.span("pf.rebuild"):
                if self.method.name in FAST_DECOUPLED:
                    from .fast_decoupled import compile_fnr_arrays
                    self.arrays = compile_fnr_arrays(
                        self.system, self.method.name.endswith("bx"),
                        self.device)
                elif self.method.name == "gauss_seidel":
                    from .gauss_seidel import compile_gs_arrays
                    self.arrays = compile_gs_arrays(self.system, self.device)
                elif self.method.name == "newton_raphson_bbd":
                    from .newton_bbd import compile_nr_bbd
                    self.arrays, self._bbd_layout = compile_nr_bbd(
                        self.system, self._bbd_n_blocks, self.device)
                elif self.method.name.startswith("fast_newton_raphson_bbd"):
                    from .fast_decoupled import compile_fnr_bbd
                    self.arrays, self._bbd_factors = compile_fnr_bbd(
                        self.system, self.method.name.endswith("bx"),
                        self._bbd_n_blocks, self.device)
                else:
                    self.arrays = compile_ac_arrays(self.system, self.device)
            sig["ac_model"] = rev.ac_model
            sig["ac_pattern"] = rev.ac_pattern
            sig["type"] = rev.type
            sig["injection"] = rev.injection
            sig["slack"] = rev.slack

    def _state(self):
        """The host voltage state as f64 tensors on the analysis device."""
        return (torch.as_tensor(self.voltage.magnitude, dtype=torch.float64,
                                device=self.device),
                torch.as_tensor(self.voltage.angle, dtype=torch.float64,
                                device=self.device))


def initialize_ac_power_flow(system: PowerSystem):
    """Bus-type repair + start voltages (reference acPowerFlow.jl:1312-1331).

    PV buses without in-service generators become PQ; PV/slack magnitudes are
    seeded from the first in-service generator's setpoint; the slack is
    re-designated if it lost its generators (changeSlackBus!, :1334-1358).
    """
    bus = system.bus
    n = bus.number
    magnitude = bus.voltage.magnitude.array[:n].copy()
    angle = bus.voltage.angle.array[:n].copy()

    for i in range(n):
        has_gen = i in bus.supply.generator and bus.supply.generator[i]
        if not has_gen and bus.layout.type[i] == 2:
            bus.layout.type[i] = 1
            system.type_changed()
        if has_gen and bus.layout.type[i] != 1:
            first = bus.supply.generator[i][0]
            magnitude[i] = system.generator.voltage.magnitude[first]

    change_slack_bus(system)
    return magnitude, angle


def change_slack_bus(system: PowerSystem):
    """Reference changeSlackBus! (acPowerFlow.jl:1334-1358)."""
    bus = system.bus
    slack = bus.layout.slack
    if slack in bus.supply.generator and bus.supply.generator[slack]:
        return
    bus.layout.type[slack] = 1
    system.type_changed()
    for i in range(bus.number):
        if bus.layout.type[i] == 2 and bus.supply.generator.get(i):
            bus.layout.type[i] = 3
            system.type_changed()
            bus.layout.slack = i
            system.slack_changed()
            info("No in-service generator found at the slack bus. "
                 f"The bus labeled {bus.label.label(i)} is the new slack bus.")
            break
    if bus.layout.type[bus.layout.slack] == 1:
        raise SlackDefinitionError(
            "No generator buses with an in-service generator are available; "
            "a slack bus cannot be designated.")


def newton_raphson(system: PowerSystem, factorization: str = linalg.LU,
                   device=None) -> AcPowerFlow:
    """Construct a Newton-Raphson AC power flow analysis
    (reference newtonRaphson, acPowerFlow.jl:39-87) on ``device``
    (default ``config.device``)."""
    device = resolve_device(device)
    system.check_slack()
    model(system, "ac")
    magnitude, angle = initialize_ac_power_flow(system)
    arrays = compile_ac_arrays(system, device)
    rev = system.model.revision
    return AcPowerFlow(
        system=system,
        voltage=Polar(magnitude, angle),
        method=MethodState("newton_raphson", factorization),
        arrays=arrays,
        device=device,
        signature={"ac_model": rev.ac_model, "ac_pattern": rev.ac_pattern,
                   "type": rev.type, "injection": rev.injection,
                   "slack": rev.slack},
    )


def mismatch(analysis: AcPowerFlow):
    """Reference mismatch!: returns (max|dP|, max|dQ|)."""
    analysis._refresh_arrays()
    if analysis.method.name in FAST_DECOUPLED:
        from .fast_decoupled import fnr_mismatch
        return fnr_mismatch(analysis)
    if analysis.method.name == "gauss_seidel":
        from .gauss_seidel import gs_mismatch
        return gs_mismatch(analysis)
    vm, va = analysis._state()
    arr = analysis.arrays
    _, _, del_p, del_q = _mismatch(
        arr.net if analysis.method.name == "newton_raphson_bbd" else arr,
        vm, va)
    del_p, del_q = torch.stack([del_p, del_q]).tolist()
    analysis.method.max_mismatch_active = del_p
    analysis.method.max_mismatch_reactive = del_q
    return del_p, del_q


def solve(analysis: AcPowerFlow):
    """Reference solve!: one iteration of the analysis's method."""
    analysis._refresh_arrays()
    if analysis.method.name in FAST_DECOUPLED:
        from .fast_decoupled import fnr_solve_step
        return fnr_solve_step(analysis)
    if analysis.method.name == "gauss_seidel":
        from .gauss_seidel import gs_solve_step
        return gs_solve_step(analysis)
    vm, va = analysis._state()
    vm, va = _nr_step(analysis.arrays, vm, va, analysis.method.factorization)
    analysis.voltage.magnitude = vm.cpu().numpy()
    analysis.voltage.angle = va.cpu().numpy()
    analysis.method.iteration += 1


def set_initial_point(target: AcPowerFlow, source=None):
    """Warm start (reference setInitialPoint!, acPowerFlow.jl:1226-1309):
    from the system's stored start voltages, or from another analysis."""
    system = target.system
    n = system.bus.number
    if source is None:
        magnitude, angle = initialize_ac_power_flow(system)
        target.voltage.magnitude = magnitude
        target.voltage.angle = angle
    else:
        target.voltage.magnitude = np.array(source.voltage.magnitude[:n])
        if hasattr(source.voltage, "angle"):
            target.voltage.angle = np.array(source.voltage.angle[:n])
