"""The plain reference on the repository's own case data at case118 size:
NR and WLS converge, one input gives one result, and the port on the CPU
gives the same states, counts and flags."""

import numpy as np
import pytest
import torch

from portbench.reference.case import load_case
from portbench.reference import grid as ref

from .conftest import ROOT

CASE = ROOT / "tests" / "data" / "case118.m"
VARIANCES = dict(voltmeter=1e-4, wattmeter=1e-4, varmeter=1e-4,
                 pmu_magnitude=1e-8, pmu_angle=1e-8)


@pytest.fixture(scope="module")
def case118():
    case = load_case(str(CASE))
    return case, ref.Grid.build(case, "cpu")


def nr_inputs(case, batch, seed):
    rng = np.random.default_rng(seed)
    fac = torch.tensor(1 + 0.05 * rng.standard_normal((batch, case.n)))
    start = torch.tensor(case.vm_start)[None].expand(batch, -1).contiguous()
    angle = torch.tensor(case.va_case)[None].expand(batch, -1).contiguous()
    return (start, angle, torch.tensor(case.p_sched)[None] * fac,
            torch.tensor(case.q_sched)[None] * fac)


def se_inputs(case, grid, batch, seed):
    vm, va, _, ok = ref.nr_solve(grid, *(x[:1] for x in nr_inputs(case, 1,
                                                                  seed)))
    meas = ref.MeasurementSet.every_bus_and_branch(case, 10, VARIANCES)
    base = ref.measure(grid, meas, vm, va)[0]
    rng = np.random.default_rng(seed)
    means = base[None] + torch.tensor(np.sqrt(meas.variance))[None] * \
        torch.tensor(rng.standard_normal((batch, meas.rows)))
    start = torch.tensor(case.vm_case)[None].expand(batch, -1).contiguous()
    angle = torch.tensor(case.va_case)[None].expand(batch, -1).contiguous()
    return meas, base, (start, angle, means)


def test_case_reading(case118):
    case, grid = case118
    assert case.n == 118 and case.slack == 68 and len(case.f) == 186
    y = grid.y.numpy()
    assert np.allclose(y, y.T)            # no phase shifters in case118
    assert np.count_nonzero(y) == case.pattern_nnz()


def test_nr_converges_and_repeats(case118):
    case, grid = case118
    inputs = nr_inputs(case, 16, 3)
    first = ref.nr_solve(grid, *inputs, chunk=5)
    again = ref.nr_solve(grid, *inputs, chunk=5)
    whole = ref.nr_solve(grid, *inputs)
    assert bool(first[3].all()) and set(first[2].tolist()) <= {3, 4}
    for a, b, c in zip(first, again, whole):
        assert torch.equal(a, b)
        assert (a.double() - c.double()).abs().max() < 1e-12


def test_wls_converges_and_repeats(case118):
    case, grid = case118
    meas, _, inputs = se_inputs(case, grid, 8, 4)
    assert meas.rows == 1122
    first = ref.se_solve(grid, meas, *inputs, chunk=3)
    again = ref.se_solve(grid, meas, *inputs, chunk=3)
    whole = ref.se_solve(grid, meas, *inputs)
    assert bool(first[3].all()) and int(first[2].max()) <= 6
    for a, b, c in zip(first, again, whole):
        assert torch.equal(a, b)
        assert (a.double() - c.double()).abs().max() < 1e-12


def test_wls_recovers_the_power_flow_without_noise(case118):
    case, grid = case118
    meas, base, (vm0, va0, _) = se_inputs(case, grid, 2, 5)
    vm, va, _, ok = ref.se_solve(grid, meas, vm0, va0, base[None].repeat(2, 1))
    pf = ref.nr_solve(grid, *(x[:1] for x in nr_inputs(case, 1, 5)))
    assert bool(ok.all())
    assert (vm - pf[0]).abs().max() < 1e-9 and (va - pf[1]).abs().max() < 1e-9


def test_the_port_gives_the_reference_s_answers(case118):
    """The same inputs through the port on the CPU: states within 1e-12,
    the same counts and flags."""
    import juliagrid_tpu_torch as jgt
    from juliagrid_tpu_torch.parallel import batched_nr_solve, \
        batched_se_solve
    from portbench.spec import Spec

    case, grid = case118
    arr = jgt.newton_raphson(jgt.power_system(str(CASE)),
                             device="cpu").arrays
    assert np.array_equal(arr.bus_type.numpy(), case.bus_type)
    inputs = nr_inputs(case, 16, 6)
    got = batched_nr_solve(arr, *inputs)
    want = ref.nr_solve(grid, *inputs)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert max((got[i] - want[i]).abs().max().item() for i in (0, 1)) < 1e-12

    meas, base, inputs = se_inputs(case, grid, 8, 7)
    sut = Spec(ROOT).entry("se").build(
        CASE, dict(entry="se", tol=1e-8, max_iter=40), "cpu",
        dict(meas=meas, means=base.numpy()))
    assert torch.equal(sut.arrays.mean, base)      # the rows' order
    got = batched_se_solve(sut.arrays, sut.net, *inputs)
    want = ref.se_solve(grid, meas, *inputs)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert max((got[i] - want[i]).abs().max().item() for i in (0, 1)) < 1e-12
