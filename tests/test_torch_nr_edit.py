"""The benchmark's live-edit power flow (``portbench/entries/nr_edit.py``)
on the CPU: each call's loads set through ``update_bus`` to the base demand
times the call's factors, then one ``power_flow`` of the reused analysis.
Its answers are the plain reference's (``portbench/reference/``), a call
depends on its own inputs alone whatever came before it, the reused
analysis gives a fresh build's answer, and at ACTIVSg10k the entry's sizes
are the case's (read, not solved)."""

import numpy as np
import pytest
import torch

import juliagrid_tpu_torch as jgt
from portbench.generator import Traffic
from portbench.reference.case import load_case
from portbench.reference.grid import Grid
from portbench.spec import ROOT, Spec

SEED = 2 ** 31 + 4099
CASES = {"case14": ROOT / "tests" / "data" / "case14test.m",
         "case118": ROOT / "portbench" / "data" / "case118.m"}


@pytest.fixture(scope="module")
def entry():
    return Spec(ROOT).entry("nr_edit")


@pytest.fixture(scope="module")
def params():
    return Spec(ROOT).traffic("nr_edit.b1")


def _cell(entry, params, path):
    """The case, the reference's preparation and the seeded generator."""
    case = load_case(str(path))
    prep = entry.prepare(case, dict(case=str(path)), torch.device("cpu"))
    gen = Traffic(params, entry, case, prep, "cpu", SEED)
    return case, prep, gen


def _program(entry, params, path, prep):
    return entry.build(path, params, torch.device("cpu"), prep)


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_program_gives_the_reference_s_answers(entry, params, name):
    path = CASES[name]
    case, prep, gen = _cell(entry, params, path)
    grid = Grid.build(case, "cpu")
    program = _program(entry, params, path, prep)
    assert len(program.buses) == int(np.count_nonzero(
        (prep["pd"] != 0) | (prep["qd"] != 0)))
    for index in range(3):
        inputs = gen.call(index)
        vm, va, it, cv = program.solve(inputs)
        rvm, rva, rit, rcv = entry.reference_solve(grid, prep, params,
                                                   inputs, 1)
        assert bool(cv.all()) and bool(rcv.all())
        assert torch.equal(it, rit) and torch.equal(cv, rcv)
        assert (vm - rvm).abs().max().item() < 1e-10
        assert (va - rva).abs().max().item() < 1e-10


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_call_does_not_depend_on_the_calls_before_it(entry, params, name):
    path = CASES[name]
    _, prep, gen = _cell(entry, params, path)
    first, second = gen.call(0), gen.call(1)
    a = _program(entry, params, path, prep)
    b = _program(entry, params, path, prep)
    a0, a1 = a.solve(first), a.solve(second)
    b1, b0 = b.solve(second), b.solve(first)
    for x, y in ((a0, b0), (a1, b1)):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert not torch.equal(a0[0], a1[0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_reused_analysis_matches_a_fresh_build(entry, params, name):
    path = CASES[name]
    _, prep, gen = _cell(entry, params, path)
    program = _program(entry, params, path, prep)
    for index in range(2):
        vm, va, it, cv = program.solve(gen.call(index))
        fresh = jgt.newton_raphson(program.system, device="cpu")
        jgt.power_flow(fresh, iteration=params["max_iter"],
                       tolerance=params["tol"])
        assert fresh.method.converged and bool(cv.all())
        assert fresh.method.iteration == int(it[0])
        np.testing.assert_allclose(vm[0].numpy(), fresh.voltage.magnitude,
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(va[0].numpy(), fresh.voltage.angle,
                                   rtol=0, atol=1e-12)


def test_activsg10k_sizes(entry):
    """The configuration's sizes, from the case file alone."""
    spec = Spec(ROOT)
    config = spec.config("activsg10k")
    case = load_case(str(spec.path(config["case"])))
    prep = entry.prepare(case, config, torch.device("cpu"))
    shape = entry.shape(case, prep)
    sizes = config["sizes"]
    assert (shape["n"], shape["order"], shape["nnz"]) == \
        (10000, 18544, 34434)
    assert shape["n"] == sizes["buses"]
    assert shape["order"] == sizes["newton_order"]
    assert shape["nnz"] == sizes["ybus_entries"]
    assert shape["branches"] == sizes["branches_in_service"] == 12706
    assert (int((case.bus_type == 1).sum()), int((case.bus_type == 2).sum())) \
        == (sizes["pq"], sizes["pv"])
    assert int(np.count_nonzero((prep["pd"] != 0) | (prep["qd"] != 0))) == \
        sizes["buses_with_demand"] == 4170
    assert shape["extra_solves"] == 0
