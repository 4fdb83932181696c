"""The comparison that decides ``correct`` fails its control and the
faults a fleet can have, each at a size a test run holds (case118 at 8
scenarios a call, on the CPU), with the harness driving the rest of the
run. The control at the cells' own sizes runs on the card
(``control.py``; ``test_control_on_the_card``)."""

import pytest
import torch

import juliagrid_tpu_torch.parallel.batch as batch
from portbench.control import control_factory
from portbench.harness import run_cell
from portbench.spec import Spec

from .conftest import ROOT

SEED = 2 ** 31 + 501
CELLS = ("case118.nr_small", "case118.se_small")


@pytest.mark.parametrize("cell", CELLS)
def test_the_float32_control_is_not_correct(small_root, cell):
    spec = Spec(small_root)
    result, _ = run_cell(spec, cell, SEED, 0.5, False, device="cpu",
                         program=control_factory(spec, cell))
    assert result["correct"] is False
    checks = result["checks"]
    assert checks["count_gap_pct"]["value"] > checks["count_gap_pct"]["limit"]
    assert checks["state_gap"]["value"] > checks["state_gap"]["limit"]


def fault_program(kind):
    """The port with its timed path broken after the fact: ``half`` leaves
    the second half of each call's scenarios unsolved (their start state
    returned, with the first half's counts and flags), ``altered`` moves
    one scenario's answer by 1e-6 where it is produced."""
    def make(case_path, traffic, device, prep):
        sut = Spec(ROOT).entry(traffic["entry"]).build(case_path, traffic,
                                                       device, prep)
        solve = sut.solve

        def broken(inputs):
            if kind == "half":
                half = inputs["vm0"].shape[0] // 2
                part = {k: v[:half] for k, v in inputs.items()
                        if v.shape[0] > 1}
                part.update({k: v for k, v in inputs.items()
                             if v.shape[0] == 1})
                vm, va, it, cv = solve(part)
                return (torch.cat([vm, inputs["vm0"][half:]]),
                        torch.cat([va, inputs["va0"][half:]]),
                        it.repeat(2), cv.repeat(2))
            vm, va, it, cv = solve(inputs)
            vm = vm.clone()
            vm[0, 1] += 1e-6
            return vm, va, it, cv

        sut.solve = broken
        return sut

    return make


def unchanged_step(monkeypatch, cell):
    """A step that returns its state unchanged: the NR update, or a GN
    increment of zeros."""
    if cell.endswith("nr_small"):
        monkeypatch.setattr(batch, "_nr_update",
                            lambda arr, vm, va, res, kind, check=True:
                            (vm, va))
    else:
        real = batch._normal_increment

        def still(*args, **kwargs):
            dx, maxinc, rel = real(*args, **kwargs)
            return torch.zeros_like(dx), torch.zeros_like(maxinc), rel

        monkeypatch.setattr(batch, "_normal_increment", still)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(small_root, monkeypatch, cell,
                                            fault):
    spec = Spec(small_root)
    make = None
    if fault == "unchanged":
        unchanged_step(monkeypatch, cell)
    else:
        make = fault_program(fault)
    result, _ = run_cell(spec, cell, SEED + 1, 0.5, False, device="cpu",
                         program=make)
    assert result["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", ["case118.nr_fleet", "case118.se_fleet"])
def test_control_on_the_card(card, cell):
    """The control at a cell's own size on three seeds (a short window)."""
    spec = Spec(ROOT)
    for seed in (SEED + 10, SEED + 11, SEED + 12):
        result, _ = run_cell(spec, cell, seed, 1.0, False, device=card,
                             program=control_factory(spec, cell))
        assert result["correct"] is False
