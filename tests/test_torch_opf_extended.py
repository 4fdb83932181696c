"""User extensions (``opf/extended.py``) and the DC cost edit of the port
against the JAX package on the CPU (tests/test_opf.py's
test_opf_user_extension and test_cost_update_changes_opf as parity), and
an extension of the AC model.

Tolerances: objectives rtol 1e-6 and reserves 1e-6 against the JAX
package's solves (its KKT in f32 with refinement, the port's in f64 LU);
the test's own 1e-6 / 1e-4 for the reserve's sum and split."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.opf import extended as jax_ext
from juliagrid_tpu.opf.dcopf import dc_optimal_power_flow as jax_dc
from juliagrid_tpu.opf.dcopf import solve as jax_dc_solve
from juliagrid_tpu_torch.opf import acopf, dcopf, extended, update_cost


def _reserve(mod, analysis, xp):
    """The spinning-reserve extension of test_opf_user_extension: two
    reserve variables >= 0 summing to 0.2, costed quadratically."""
    mod.add_variable(analysis, "reserve", dim=2, lower=0.0, start=0.1)
    mod.add_constraint(analysis, lambda s: xp.sum(s["reserve"]) - 0.2,
                       kind="eq")
    mod.add_objective_term(analysis,
                           lambda s: 50.0 * xp.sum(s["reserve"] ** 2))


@pytest.fixture(scope="module")
def dc_runs(data_path):
    """(base, extended, cost-edited) DC solves of case14test in each
    package."""
    out = {}
    for name, pkg, build, solve, mod, xp in (
            ("jax", jg, jax_dc, jax_dc_solve, jax_ext, jnp),
            ("port", jgt, lambda s: dcopf.dc_optimal_power_flow(s, "cpu"),
             dcopf.solve, extended, torch)):
        system = pkg.power_system(str(data_path / "case14test.m"))
        base = build(system)
        solve(base)
        ext = build(system)
        _reserve(mod, ext, xp)
        mod.solve_extended(ext)
        obj1 = base.method.objective
        # cost! live edit: generator 1 made much cheaper, then re-solved
        pkg.cost(system, system.generator.label.label(0), active=2,
                 polynomial=[1.0, 1.0, 0.0])
        solve(base)
        out[name] = (obj1, ext, base)
    return out


def test_dc_user_extension_matches_jax(dc_runs):
    obj_j, ext_j, _ = dc_runs["jax"]
    obj_t, ext_t, _ = dc_runs["port"]
    assert ext_t.method.converged
    r = ext_t.method.user_values["reserve"]
    assert abs(r.sum() - 0.2) < 1e-6
    assert abs(r[0] - r[1]) < 1e-4          # symmetric cost: an even split
    assert ext_t.method.objective > obj_t   # the extension adds cost
    assert abs(ext_t.method.objective - ext_j.method.objective) <= \
        1e-6 * abs(ext_j.method.objective)
    np.testing.assert_allclose(r, ext_j.method.user_values["reserve"],
                               atol=1e-6)
    np.testing.assert_allclose(ext_t.power.generator.active,
                               ext_j.power.generator.active, atol=1e-6)


def test_dc_cost_update_matches_jax(dc_runs):
    obj1_j, _, base_j = dc_runs["jax"]
    obj1_t, _, base_t = dc_runs["port"]
    assert base_t.method.converged
    assert base_t.method.objective < obj1_t
    assert abs(base_t.method.objective - base_j.method.objective) <= \
        1e-6 * abs(base_j.method.objective)


def test_ac_user_extension(data_path):
    """An extension of the AC model: the reserve plus a bound on two bus
    voltages, through torch.func derivatives of the whole problem; without
    extensions solve_extended reaches the plain solve's optimum."""
    system = jgt.power_system(str(data_path / "case14optimal.m"))
    plain = acopf.ac_optimal_power_flow(system, device="cpu")
    acopf.solve(plain)
    bare = acopf.ac_optimal_power_flow(system, device="cpu")
    extended.solve_extended(bare)
    assert bare.method.converged
    assert abs(bare.method.objective - plain.method.objective) <= \
        1e-6 * abs(plain.method.objective)
    ext = acopf.ac_optimal_power_flow(system, device="cpu")
    _reserve(extended, ext, torch)
    extended.add_constraint(ext, lambda s: 1.04 - s["magnitude"][3:5])
    extended.solve_extended(ext)
    assert ext.method.converged
    r = ext.method.user_values["reserve"]
    assert abs(r.sum() - 0.2) < 1e-6 and abs(r[0] - r[1]) < 1e-4
    assert (ext.voltage.magnitude[3:5] <= 1.04 + 1e-7).all()
    assert ext.method.objective > plain.method.objective
    extended.remove(ext, "constraint", 1)
    assert len(ext._extension.constraints) == 1


def test_cost_edit_on_the_ac_model_splices_in_place(data_path):
    system = jgt.power_system(str(data_path / "case14optimal.m"))
    analysis = acopf.ac_optimal_power_flow(system, device="cpu")
    analysis._refresh_spec()    # capture the revision, as a solve does
    spec = analysis._spec
    update_cost(analysis, system.generator.label.label(0), active=2,
                polynomial=[0.05, 22.0, 0.0])
    assert analysis._spec is spec and analysis._carry_duals
    assert ("p", 0) in [(k, i) for k, i, _ in spec.poly_terms]
    # a piecewise cost of more than two points adds a helper: rebuilt
    update_cost(analysis, system.generator.label.label(0), active=1,
                piecewise=[[0.0, 1.0], [1.0, 20.0], [2.0, 60.0]])
    assert analysis._spec is not spec
    assert analysis._spec.n_hp == spec.n_hp + 1
