"""Live edits of the port's AC OPF against the JAX package's, on the CPU
(tests/test_opf_edit.py's AC cases as parity).

One chain of edits runs on a solved case14optimal model in both packages —
a voltage bound, a demand, a polynomial cost, a fixed generator output and
its release — with a re-solve after each; the JAX chain runs once for the
module. Each re-solve is held to the JAX package's (objective rtol 1e-6,
states 1e-5: test_opf_edit.py's tolerances, the two KKT solves being f32
with refinement and f64 LU) and to the edit's meaning."""

import numpy as np
import pytest

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu import opf as jax_opf
from juliagrid_tpu.opf import acopf as jax_acopf
from juliagrid_tpu_torch import opf
from juliagrid_tpu_torch.opf import acopf

STEPS = ("bound", "demand", "cost", "fix", "unfix")


def _edit(mod, analysis, step):
    s = analysis.system
    if step == "bound":
        mod.set_bound(analysis, variable="magnitude",
                      label=s.bus.label.label(3),
                      max=float(analysis.voltage.magnitude[3]) - 0.005)
    elif step == "demand":
        mod.update_demand(analysis, s.bus.label.label(2),
                          active=1.05 * float(s.bus.demand.active[2]))
    elif step == "cost":
        mod.update_cost(analysis, s.generator.label.label(0), active=2,
                        polynomial=[0.05, 22.0, 0.0])
    elif step == "fix":
        mod.fix(analysis, variable="active",
                label=s.generator.label.label(1), value=0.3)
    else:
        mod.unfix(analysis, variable="active",
                  label=s.generator.label.label(1))


def _chain(pkg, mod, build, solve, data_path):
    """The solved model's record, then each edit's: the spec kept, the
    carried duals armed, the spec's rows before the edit and after its
    re-solve, the objective, status, V, θ and Pg."""
    system = pkg.power_system(str(data_path / "case14optimal.m"))
    analysis = build(system)
    solve(analysis)
    out = {"start": (analysis.method.objective,
                     analysis.power.generator.active.copy())}
    for step in STEPS:
        spec = analysis._spec
        before = (list(spec.ineq_tags), np.array(spec.vlo_i),
                  np.array(spec.vhi_i))
        _edit(mod, analysis, step)
        armed = bool(analysis._carry_duals)
        kept = analysis._spec is spec
        solve(analysis)
        spec = analysis._spec
        out[step] = dict(
            kept=kept, armed=armed, before=before,
            after=(list(spec.ineq_tags), np.array(spec.vlo_i),
                   np.array(spec.vhi_i)),
            vhi=dict(zip(spec.vhi_i.tolist(), spec.vhi_b.tolist())),
            fix_p=[i for i, _ in spec.fix_p],
            objective=analysis.method.objective,
            status=analysis.method.result.status,
            vm=np.array(analysis.voltage.magnitude),
            va=np.array(analysis.voltage.angle),
            pg=np.array(analysis.power.generator.active))
    return out


@pytest.fixture(scope="module")
def chains(data_path):
    jax_run = _chain(jg, jax_opf, jax_acopf.ac_optimal_power_flow,
                     jax_acopf.solve, data_path)
    port = _chain(jgt, opf,
                  lambda s: acopf.ac_optimal_power_flow(s, device="cpu"),
                  acopf.solve, data_path)
    return jax_run, port


@pytest.mark.parametrize("step", STEPS)
def test_edit_resolve_matches_jax(chains, step):
    jax_run, port = chains
    got, want = port[step], jax_run[step]
    assert got["kept"] and got["armed"]
    assert got["status"] in ("optimal", "acceptable")
    assert got["status"] == want["status"]
    assert abs(got["objective"] - want["objective"]) <= \
        1e-6 * max(1.0, abs(want["objective"]))
    for key in ("vm", "va", "pg"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5)


def test_value_edits_keep_the_structure(chains):
    """A bound tightened and a demand moved keep the spec and its rows."""
    _, port = chains
    for step in ("bound", "demand"):
        rec = port[step]
        (tags, vlo, vhi), (tags2, vlo2, vhi2) = rec["before"], rec["after"]
        assert tags2 == tags
        np.testing.assert_array_equal(vlo2, vlo)
        np.testing.assert_array_equal(vhi2, vhi)
    assert port["bound"]["vm"][3] <= port["bound"]["vhi"][3] + 1e-7


def test_fix_and_unfix(chains):
    """fix! pins the output (an equality row), unfix! restores the box and
    the re-solve returns to the optimum before the fix."""
    _, port = chains
    assert abs(port["fix"]["pg"][1] - 0.3) < 1e-6
    assert 1 in port["fix"]["fix_p"]
    assert 1 not in port["unfix"]["fix_p"]
    assert abs(port["unfix"]["objective"] - port["cost"]["objective"]) <= \
        1e-6 * abs(port["cost"]["objective"])
    np.testing.assert_allclose(port["unfix"]["pg"], port["cost"]["pg"],
                               atol=1e-4)


def test_unfix_without_fix_and_bad_variable_raise(data_path):
    system = jgt.power_system(str(data_path / "case14optimal.m"))
    analysis = acopf.ac_optimal_power_flow(system, device="cpu")
    with pytest.raises(ValueError, match="no recorded fix"):
        opf.unfix(analysis, variable="reactive",
                  label=system.generator.label.label(0))
    with pytest.raises(ValueError, match="variable must be one of"):
        opf.set_bound(analysis, variable="angle",
                      label=system.bus.label.label(0), max=1.0)
    with pytest.raises(ValueError, match="out-of-service"):
        opf.set_bound(analysis, variable="active",
                      label=system.generator.label.label(3), max=1.0)
