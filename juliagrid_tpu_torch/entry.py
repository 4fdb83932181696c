"""Entry points: one Newton-Raphson step of the port on case14test, and the
multi-device dry run.

The counterparts of the JAX package's ``__graft_entry__.py``. ``entry``: a
caller gets a function and its example arguments, and one call of the
function is one step of the port's main path — K1's fill (injections,
mismatch and the Jacobian over the unknowns in one launch), an f64 LU
solve and the state update. ``dryrun_multichip(n)``: the scenario-sharded NR and SE
fleets, the block-sharded Schur solve and the AC OPF with its KKT over a
block mesh, each on ``n`` ranks (``parallel/mesh.py::launch``), with the
JAX package's shapes and checks.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .estimation.acse import compile_se_arrays
from .measurement.devices import add_varmeter, add_voltmeter, add_wattmeter
from .measurement.load import measurement
from .opf import acopf
from .ops.bbd import bbd_partition, bbd_solve_sharded, build_bbd_arrays
from .parallel.batch import sharded_nr_solve, sharded_se_solve
from .parallel.mesh import launch
from .powerflow.ac import _nr_step, compile_ac_arrays, newton_raphson
from .powerflow.driver import power_flow
from .system.load import power_system
from .system.model import dc_model
from .utils.synthetic import synthetic_grid

#: the package's own copy of the MATPOWER case, so the entry point needs
#: nothing outside the package
CASE = Path(__file__).resolve().parent / "data" / "case14test.m"


def entry(device=None):
    """Return ``(fn, example_args)``: ``fn(arr, vm, va)`` is one
    Newton-Raphson step on case14test and returns the new ``(vm, va)``;
    its tensors are on ``device`` (default ``config.device``, the card)."""
    analysis = newton_raphson(power_system(str(CASE)), device=device)
    vm, va = analysis._state()

    def fn(arr, vm, va):
        return _nr_step(arr, vm, va, "LU")

    return fn, (analysis.arrays, vm, va)


def _require(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _dryrun_rank(mesh) -> dict:
    """One rank of ``dryrun_multichip``: the four paths of the JAX
    package's dry run on ``mesh``'s ranks. Returns what each path gave
    this rank (on the CPU)."""
    dev = mesh.device
    system = power_system(str(CASE))
    analysis = newton_raphson(system, device=dev)
    arr = analysis.arrays
    n_bus = system.bus.number

    # scenario-sharded NR: 2 scenarios a rank, 5% scale noise on P and Q
    nscen = 2 * mesh.size
    rng = np.random.default_rng(0)
    vm0, va0 = (x.expand(nscen, -1).contiguous() for x in analysis._state())
    scale = torch.as_tensor(1.0 + 0.05 * rng.standard_normal((nscen, 1)),
                            device=dev)
    vm, va, iters, conv = sharded_nr_solve(
        mesh, arr, vm0, va0, arr.p_sched[None] * scale,
        arr.q_sched[None] * scale, tol=1e-8, max_iter=20)
    _require(vm.shape == (nscen, n_bus) and bool(torch.isfinite(vm).all()),
             "the sharded NR fleet is not finite")

    # scenario-sharded WLS SE on noiseless meters, 0.1 sigma on the means
    power_flow(analysis, power=True)
    mon = measurement(system)
    add_voltmeter(mon, analysis=analysis, noise=False)
    add_wattmeter(mon, analysis=analysis, noise=False)
    add_varmeter(mon, analysis=analysis, noise=False)
    se_arr, _, _, host = compile_se_arrays(system, mon, return_host=True,
                                           device=dev)
    net = compile_ac_arrays(system, dev)
    sigma = 1.0 / np.sqrt(host.w)
    means = torch.as_tensor(
        host.mean[None, :] + 0.1 * sigma[None, :] * rng.standard_normal(
            (nscen, host.mean.shape[0])), device=dev)
    svm0 = torch.as_tensor(system.bus.voltage.magnitude.array[:n_bus],
                           device=dev).expand(nscen, -1).contiguous()
    sva0 = torch.as_tensor(system.bus.voltage.angle.array[:n_bus],
                           device=dev).expand(nscen, -1).contiguous()
    svm, sva, se_iters, se_conv = sharded_se_solve(
        mesh, se_arr, net, svm0, sva0, means, tol=1e-8, max_iter=40)
    _require(svm.shape == (nscen, n_bus) and bool(se_conv.all()),
             "the sharded SE scenarios must converge")

    # network blocks over the mesh: the BBD Schur solve of a DC system
    bmesh = mesh.renamed("block")
    grid = synthetic_grid(6, 8)
    dc_model(grid)
    n = grid.bus.number
    b = np.asarray(grid.model.dc.nodal.todense())
    m = np.ones(n)
    m[grid.bus.layout.slack] = 0.0
    a = m[:, None] * b * m[None, :] + np.diag(1 - m)
    rhs_dc = (grid.bus.supply.active.array[:n]
              - grid.bus.demand.active.array[:n]) * m
    adjacency = grid.model.dc.nodal.copy()
    adjacency.eliminate_zeros()
    block_of, border = bbd_partition(adjacency, mesh.size)
    bbd = build_bbd_arrays(a, block_of, border, device=dev)
    x = bbd_solve_sharded(bmesh, bbd, torch.as_tensor(rhs_dc, device=dev))
    residual = float(np.abs(a @ x.cpu().numpy() - rhs_dc).max())
    _require(residual < 1e-8, f"the sharded Schur solve misses by "
             f"{residual:.3e}")

    # the AC OPF with its structured KKT's blocks over the mesh
    opf = acopf.ac_optimal_power_flow(synthetic_grid(6, 8, opf=True),
                                      device=dev)
    acopf.solve(opf, kkt_blocks=mesh.size, kkt_mesh=bmesh, max_iter=60,
                tolerance=1e-7)
    res = opf.method.result
    _require(res.status in ("optimal", "acceptable"),
             f"the AC OPF over the mesh ended {res.status}")
    return {"nr": [t.cpu() for t in (vm, va, iters, conv)],
            "se": [t.cpu() for t in (svm, sva, se_iters, se_conv)],
            "bbd": x.cpu(), "bbd_residual": residual,
            "opf": {"status": res.status, "iterations": res.iterations,
                    "objective": res.objective, "x": res.x}}


def dryrun_multichip(n_devices: int, device=None, backend=None,
                     timeout: float = 600.0) -> list:
    """The JAX package's ``dryrun_multichip`` on ``n_devices`` ranks
    (``parallel/mesh.py::launch``; ``device`` defaults to the card, CUDA
    without a card raises, and ``backend`` to the launcher's rule): case14test
    with 2 scenarios a rank through ``sharded_nr_solve`` (5% scale noise
    on P and Q) and ``sharded_se_solve`` (noiseless meters, 0.1 sigma on
    the means, seed 0); ``synthetic_grid(6, 8)``'s slack-masked DC nodal
    matrix through ``bbd_partition`` and ``bbd_solve_sharded``, within
    1e-8 of its right-hand side; and ``synthetic_grid(6, 8, opf=True)``'s
    AC OPF with ``kkt_blocks=n_devices`` over a block mesh, ending optimal
    or acceptable. Raises where a check fails or a rank fails; returns
    each rank's results."""
    return launch(_dryrun_rank, n_devices, backend=backend, device=device,
                  timeout=timeout)
