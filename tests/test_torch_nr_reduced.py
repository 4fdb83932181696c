"""The Newton-Raphson step at the unknowns' order: the variable map built on
the host (``powerflow/ac.py::newton_unknowns``, ``AcArrays.pos``), K1's
Jacobian over the unknowns, and ``_nr_update`` on that system, against the
route it replaced, which solved the 2n x 2n Jacobian with the fixed
variables' rows and columns masked to identity.

The masked route is written out here (``_masked_fill``, ``_masked_update``)
as it was. Removing a fixed variable from the masked LU removes only
``fma(-0, u, a)`` steps, so on the card K2 must give the masked route's
bits (tests marked ``card``); on the CPU the library's LU blocks the two
orders differently, so there the states agree to the parity tests' 1e-9 of
the step. This file imports no JAX at module level and needs no conftest, so
the card tests also run where JAX is not installed::

    python -m pytest tests/test_torch_nr_reduced.py --noconftest -m card

The one comparison with the JAX package imports it inside the test."""

import pathlib

import numpy as np
import pytest
import torch

import juliagrid_tpu_torch as jgt
from juliagrid_tpu_torch.kernels import fleet_solve as k2
from juliagrid_tpu_torch.kernels.nr_fill import nr_fill, nr_fill_ref
from juliagrid_tpu_torch.parallel import batch, batched_nr_solve
from juliagrid_tpu_torch.powerflow import ac
from juliagrid_tpu_torch.powerflow.ac import (_masked_jacobian, _nr_rhs,
                                              _nr_update, newton_unknowns)

DATA = pathlib.Path(__file__).parent / "data"
CASES = ("case14test", "case30test", "case118")
#: the parity tests' tolerance on a Newton step (test_torch_fleet_solve.py)
STEP_TOL = 1e-9


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _analysis(case, device="cpu"):
    return jgt.newton_raphson(jgt.power_system(str(DATA / f"{case}.m")),
                              device=device)


def _inputs(arr, vm0, va0, batch_size, seed):
    """``batch_size`` states perturbed from ``vm0``/``va0`` (numpy,
    seeded) and the schedules, on ``arr``'s device."""
    rng = np.random.default_rng(seed)
    n = len(vm0)
    dev = arr.cols.device
    vm = torch.tensor(vm0 * (1 + 0.02 * rng.standard_normal((batch_size,
                                                             n))),
                      device=dev)
    va = torch.tensor(va0 + 0.02 * rng.standard_normal((batch_size, n)),
                      device=dev)
    return (vm, va, arr.p_sched.expand(batch_size, -1).contiguous(),
            arr.q_sched.expand(batch_size, -1).contiguous())


def _counts(arr):
    bus_type = arr.bus_type.cpu().numpy()
    return int((bus_type == 2).sum()), int((bus_type == 1).sum())


def _masked_fill(arr, vm, va, ps, qs):
    """The masked 2n x 2n Jacobian as K1's plain version formed it before
    the reduced system: the partials scattered at (row, column) of the
    polar variables, the fixed rows and columns masked to identity."""
    batch_size, n = vm.shape
    res = nr_fill_ref(arr, vm, va, ps, qs)
    p, q = res.p, res.q
    rows, cols = arr.rows.long(), arr.cols.long()
    vi, vj = vm[:, rows], vm[:, cols]
    th = va[:, rows] - va[:, cols]
    gc_bs = arr.yg * torch.cos(th) + arr.yb * torch.sin(th)
    gs_bc = arr.yg * torch.sin(th) - arr.yb * torch.cos(th)
    vv = vi * vj
    off = rows != cols
    n2 = 2 * n
    jac = torch.zeros((batch_size, n2 * n2), dtype=vm.dtype,
                      device=vm.device)
    jac.index_add_(1, rows * n2 + cols, torch.where(off, vv * gs_bc, 0.0))
    jac.index_add_(1, rows * n2 + n + cols,
                   torch.where(off, vi * gc_bs, 0.0))
    jac.index_add_(1, (n + rows) * n2 + cols,
                   torch.where(off, -vv * gc_bs, 0.0))
    jac.index_add_(1, (n + rows) * n2 + n + cols,
                   torch.where(off, vi * gs_bc, 0.0))
    i = torch.arange(n, device=vm.device)
    diag = arr.diag.long()
    gii, bii = arr.yg[diag], arr.yb[diag]
    jac.index_add_(1, i * n2 + i, -q - bii * vm**2)
    jac.index_add_(1, i * n2 + n + i, p / vm + gii * vm)
    jac.index_add_(1, (n + i) * n2 + i, p - gii * vm**2)
    jac.index_add_(1, (n + i) * n2 + n + i, q / vm - bii * vm)
    jac = jac.view(batch_size, n2, n2)
    m = torch.cat([i != arr.slack, arr.bus_type == 1]).to(vm.dtype)
    return m[:, None] * jac * m[None, :] + torch.diag(1.0 - m)


def _masked_update(arr, vm, va, res, kind="LU", check=False):
    """The step of the masked route: K2 (or its plain version on the CPU)
    on the masked 2n x 2n system, the update masked by ``torch.where``."""
    n = vm.shape[-1]
    dx, _ = k2.fleet_lu_solve(_masked_jacobian(arr, res.jac),
                              torch.cat([res.mp, res.mq], -1))
    not_slack = torch.arange(n, device=vm.device) != arr.slack
    return (vm - torch.where(arr.bus_type == 1, dx[..., n:], 0.0),
            va - torch.where(not_slack, dx[..., :n], 0.0))


# --------------------------------------------------------------------------
# The map
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_map_gives_the_unknowns_order(case):
    """N = npv + 2·npq; the non-slack angles, then the PQ magnitudes, each
    in bus order; -1 exactly at the slack angle and non-PQ magnitudes
    (case118's slack is bus 68, not bus 0)."""
    arr = _analysis(case).arrays
    npv, npq = _counts(arr)
    n = arr.bus_type.numel()
    assert arr.order == npv + 2 * npq == arr.unknowns.numel()
    assert arr.pos.dtype == torch.int32 and arr.unknowns.dtype == torch.int64
    fixed = torch.cat([torch.arange(n) == arr.slack, arr.bus_type != 1])
    assert torch.equal(arr.pos < 0, fixed)
    assert torch.equal(arr.unknowns, (~fixed).nonzero()[:, 0])
    assert torch.equal(arr.pos[arr.unknowns],
                       torch.arange(arr.order, dtype=torch.int32))
    assert int(arr.pos[arr.slack]) == -1
    if case == "case118":
        assert arr.slack == 68 and int(arr.pos[0]) == 0


def test_map_follows_live_edits():
    """A bus-type edit and a slack re-designation rebuild the map with
    ``bus_type``: PV to PQ adds the bus's magnitude, the new slack's angle
    leaves; the solve still converges."""
    analysis = _analysis("case14test")
    system = analysis.system
    before = analysis.arrays.order
    pv = int((analysis.arrays.bus_type == 2).nonzero()[0, 0])
    jgt.update_bus(system, system.bus.label.label(pv), type=1)
    jgt.mismatch(analysis)
    arr = analysis.arrays
    assert arr.order == before + 1 and int(arr.pos[14 + pv]) >= 0
    jgt.update_bus(system, system.bus.label.label(1), type=3)
    jgt.mismatch(analysis)
    arr = analysis.arrays
    assert arr.slack == 1 and int(arr.pos[1]) == -1
    pos, unknowns = newton_unknowns(arr.bus_type.numpy(), 1)
    assert np.array_equal(arr.pos.numpy(), pos)
    assert np.array_equal(arr.unknowns.numpy(), unknowns)
    npv, npq = _counts(arr)
    assert arr.order == npv + 2 * npq
    jgt.power_flow(analysis)
    assert analysis.method.converged


# --------------------------------------------------------------------------
# K1's Jacobian over the unknowns, and the step (CPU)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_reduced_jacobian_is_the_masked_ones_kept_block(case):
    """Bit for bit: the reduced Jacobian is the masked one's rows and
    columns at the unknowns, and ``_masked_jacobian`` lays it out as the
    masked one."""
    analysis = _analysis(case)
    arr = analysis.arrays
    vm0, va0 = (x.numpy() for x in analysis._state())
    inputs = _inputs(arr, vm0, va0, 3, seed=11)
    res = nr_fill_ref(arr, *inputs, jacobian=True)
    masked = _masked_fill(arr, *inputs)
    idx = arr.unknowns
    assert res.jac.shape == (3, arr.order, arr.order)
    assert torch.equal(res.jac, masked[:, idx[:, None], idx])
    assert torch.equal(_masked_jacobian(arr, res.jac), masked)


@pytest.mark.parametrize("case", CASES)
def test_nr_jacobian_expansion_matches_jax(case):
    """``_nr_jacobian`` (the JAX-shaped API) against the JAX package's, at
    test_torch_nr_fill.py's tolerance."""
    import juliagrid_tpu as jg
    import jax.numpy as jnp
    from juliagrid_tpu.powerflow import ac as jax_ac
    from juliagrid_tpu_torch.convert import ac_arrays_from_numpy

    system = jg.power_system(str(DATA / f"{case}.m"))
    jarr = jax_ac.compile_ac_arrays(system)
    tarr = ac_arrays_from_numpy(
        **{f: np.asarray(getattr(jarr, f)) for f in jarr._fields},
        device="cpu")
    rng = np.random.default_rng(5)
    n = tarr.bus_type.numel()
    vm = 1.0 + 0.05 * rng.standard_normal(n)
    va = 0.2 * rng.standard_normal(n)
    p, q, _, _ = jax_ac._injections(jarr, jnp.asarray(vm), jnp.asarray(va))
    want, wmask = jax_ac._nr_jacobian(jarr, jnp.asarray(vm),
                                      jnp.asarray(va), p, q)
    got, mask = ac._nr_jacobian(tarr, torch.tensor(vm), torch.tensor(va))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    assert np.array_equal(mask.numpy(), np.asarray(wmask))


@pytest.mark.parametrize("case", CASES)
def test_nr_update_agrees_with_the_masked_route(case):
    """On the CPU the library's LU blocks the two orders differently: the
    states agree to the parity tests' 1e-9 of the step, and the fixed
    variables keep their bits."""
    analysis = _analysis(case)
    arr = analysis.arrays
    vm0, va0 = (x.numpy() for x in analysis._state())
    vm, va, ps, qs = _inputs(arr, vm0, va0, 4, seed=3)
    res = nr_fill_ref(arr, vm, va, ps, qs, jacobian=True)
    got = torch.cat(_nr_update(arr, vm, va, res, "LU"), -1)
    want = torch.cat(_masked_update(arr, vm, va, res), -1)
    step = (want - torch.cat([vm, va], -1)).abs().amax(-1, keepdim=True)
    assert ((got - want).abs() / step).max() <= STEP_TOL
    fixed = torch.cat([arr.pos[arr.bus_type.numel():],
                       arr.pos[:arr.bus_type.numel()]]) < 0
    assert torch.equal(got[:, fixed], torch.cat([vm, va], -1)[:, fixed])


def test_jacobian_order_counts_the_unknowns():
    """K1's Jacobian is formed at the order npv + 2·npq (53 at
    case30test), the map's ``order``."""
    arr = _analysis("case30test").arrays
    vm = torch.ones((2, 30), dtype=torch.float64)
    assert nr_fill(arr, vm, vm * 0, vm, vm).jac is None
    res = nr_fill(arr, vm, vm * 0, vm, vm, jacobian=True)
    npv, npq = _counts(arr)
    assert res.jac.shape == (2, arr.order, arr.order)
    assert arr.order == npv + 2 * npq == 53


# --------------------------------------------------------------------------
# On the card: K2 at the unknowns' order gives the masked route's bits
# --------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("batch_size", [1, 4, 1024])
@pytest.mark.parametrize("case", CASES)
def test_card_reduced_solve_gives_the_masked_bits(card, case, batch_size):
    """K1 on the card against its plain version (the reduced Jacobian, to
    K1's 1e-12), then K2 on the reduced system and on its masked layout:
    the same x at the unknowns, bit for bit, 0 at the fixed variables."""
    analysis = _analysis(case, device=card)
    arr = analysis.arrays
    vm0, va0 = (x.cpu().numpy() for x in analysis._state())
    inputs = _inputs(arr, vm0, va0, batch_size, seed=batch_size)
    res = nr_fill(arr, *inputs, jacobian=True)
    ref = nr_fill_ref(arr, *inputs, jacobian=True)
    assert res.jac.shape[-1] == arr.order
    assert torch.equal(res.jac != 0, ref.jac != 0)
    rel = (res.jac - ref.jac).abs() / ref.jac.abs().clamp(min=1.0)
    assert float(rel.max()) <= 1e-12
    x, info = k2.fleet_lu_solve(res.jac, _nr_rhs(arr, res))
    xm, info_m = k2.fleet_lu_solve(_masked_jacobian(arr, res.jac),
                                   torch.cat([res.mp, res.mq], -1))
    assert not info.any() and not info_m.any()
    assert torch.equal(x, xm[:, arr.unknowns])
    assert not xm[:, arr.pos < 0].any()


@pytest.mark.card
def test_card_fleet_matches_the_masked_route(card, monkeypatch):
    """``batched_nr_solve`` on the benchmark's case118 draw (1,024
    scenarios from the set points, each bus's P and Q scaled by 1 + 0.05
    N(0, 1)): the masked route's counts, flags and states."""
    analysis = _analysis("case118", device=card)
    arr = analysis.arrays
    vm0, va0 = (x.expand(1024, -1).contiguous() for x in analysis._state())
    gen = torch.Generator(device=card)
    gen.manual_seed(3000000001)
    factor = 1.0 + 0.05 * torch.randn(vm0.shape, generator=gen,
                                      dtype=torch.float64, device=card)
    ps, qs = arr.p_sched * factor, arr.q_sched * factor
    got = batched_nr_solve(arr, vm0, va0, ps, qs)
    monkeypatch.setattr(batch, "_nr_update", _masked_update)
    want = batched_nr_solve(arr, vm0, va0, ps, qs)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert bool(got[3].all())
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
