"""The port's AC optimal power flow on the CPU against the JAX package and
the MATPOWER goldens.

Tolerances: the goldens' own (tests/test_opf.py: states 1e-6, power
columns 1e-5); the JAX solve's objective within 1e-2 of 95587.8394
(test_ac_opf_ipopt_class_iterations) and its states within 1e-8, in the same
iterations (both stop at a KKT error under 1e-8 on the same path; the JAX
package factors its KKT in f32 with refinement, the port in f64 LU); a live
edit's re-solve: objective rtol 1e-6, states 1e-5 (test_opf_edit.py's)."""

import numpy as np
import pytest

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.opf import acopf as jax_acopf
from juliagrid_tpu.opf import remove_constraint as jax_remove
from juliagrid_tpu_torch.opf import acopf, remove_constraint, solve_opf

from .utils import h5group

STATE_TOL = 1e-8


@pytest.fixture(scope="module")
def jax14(data_path):
    system = jg.power_system(str(data_path / "case14optimal.m"))
    analysis = jax_acopf.ac_optimal_power_flow(system)
    jax_acopf.solve(analysis)
    return analysis


@pytest.fixture(scope="module")
def port14(data_path):
    system = jgt.power_system(str(data_path / "case14optimal.m"))
    analysis = jgt.ac_optimal_power_flow(system, device="cpu")
    jgt.power_flow(analysis, power=True, current=True)
    return analysis


def test_case14_matches_golden(port14, data_path):
    golden = h5group(data_path / "results.h5",
                     "case14optimal/acOptimalPowerFlow")
    assert port14.method.converged
    for got, key in ((port14.voltage.magnitude, "voltageMagnitude"),
                     (port14.voltage.angle, "voltageAngle"),
                     (port14.power.generator.active, "generatorActive"),
                     (port14.power.generator.reactive, "generatorReactive")):
        np.testing.assert_allclose(got, golden[key], atol=1e-6)


def test_case14_matches_jax(port14, jax14):
    res, jres = port14.method.result, jax14.method.result
    assert res.status == jres.status == "optimal"
    assert res.iterations == jres.iterations
    assert abs(res.objective - 95587.8394) < 1e-2
    for got, want in ((port14.voltage.magnitude, jax14.voltage.magnitude),
                      (port14.voltage.angle, jax14.voltage.angle),
                      (port14.power.generator.active,
                       jax14.power.generator.active),
                      (port14.power.generator.reactive,
                       jax14.power.generator.reactive)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=STATE_TOL)
    # the dual harvest lines up row for row
    assert port14.method.dual["ineq_tags"] == \
        jax14.method.dual["ineq_tags"]
    assert len(port14.method.dual["ineq"]) == \
        len(port14.method.dual["ineq_tags"])


def test_case14_powers_match_golden(port14, data_path):
    """power_flow(opf, power=True) post-processes through
    postprocessing/ac.py, as test_ac_opf_powers_matpower does."""
    golden = h5group(data_path / "results.h5",
                     "case14optimal/acOptimalPowerFlow")
    p = port14.power
    for got, key in ((p.injection.active, "injectionActive"),
                     (p.injection.reactive, "injectionReactive"),
                     (p.from_.active, "fromActive"),
                     (p.to.reactive, "toReactive"),
                     (p.series.active, "lossActive"),
                     (p.shunt.reactive, "shuntReactive"),
                     (p.supply.active, "supplyActive")):
        np.testing.assert_allclose(got, golden[key], atol=1e-5)
    np.testing.assert_allclose(p.generator.active,
                               golden["generatorActive"], atol=1e-6)
    # current=True: the branch currents at the optimum
    m = port14.system.branch.number
    assert port14.current.from_.magnitude.shape == (m,)
    assert np.isfinite(port14.current.from_.magnitude).all()


def test_case30_converges_with_fixed_q_generators(data_path):
    """case30test's fixed-Q generators (Qmin == Qmax) take equality rows;
    the interior point converges in Ipopt's iteration class."""
    system = jgt.power_system(str(data_path / "case30test.m"))
    analysis = jgt.ac_optimal_power_flow(system, device="cpu")
    solve_opf(analysis)
    assert analysis.method.converged
    assert analysis.method.iteration <= 25
    assert analysis._spec.fix_q


def test_dense_kkt_only(data_path, monkeypatch, tmp_path):
    """kkt_blocks=0 is the dense KKT only, even at the BBD size (no
    structured KKT is built). A KKT mesh whose axis size is not the block
    count raises, as in the JAX package (a one-rank gloo group of this
    process, ended before the solves)."""
    import torch.distributed as dist

    from juliagrid_tpu_torch.parallel import scenario_mesh

    system = jgt.power_system(str(data_path / "case14optimal.m"))
    analysis = jgt.ac_optimal_power_flow(system, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = scenario_mesh(axis="block", device="cpu")
        with pytest.raises(ValueError, match="must equal mesh axis"):
            acopf.solve(analysis, kkt_blocks=2, kkt_mesh=mesh)
    finally:
        dist.destroy_process_group()
    monkeypatch.setattr(acopf, "_KKT_BBD_AUTO", 10)
    acopf.solve(analysis, kkt_blocks=0, max_iter=2)
    assert analysis.method.iteration == 2
    assert getattr(analysis, "_kkt_cache", None) is None


def test_solve_opf_dispatch(data_path):
    system = jgt.power_system(str(data_path / "case14optimal.m"))
    with pytest.raises(TypeError, match="AC or DC optimal power flow"):
        solve_opf(jgt.newton_raphson(system, device="cpu"))
    analysis = jgt.ac_optimal_power_flow(system, device="cpu")
    assert solve_opf(analysis, max_iter=3) is analysis
    assert analysis.method.iteration == 3


def test_remove_flow_constraint_matches_jax(data_path):
    """remove! drops a flow limit from the live case30test model only; the
    re-solve equals the JAX package's, and a fresh build restores the
    limit (tests/test_opf_edit.py::test_remove_flow_constraint_live)."""
    runs = []
    for pkg, mod, remove, kw in ((jg, jax_acopf, jax_remove, {}),
                                 (jgt, acopf, remove_constraint,
                                  {"device": "cpu"})):
        system = pkg.power_system(str(data_path / "case30test.m"))
        analysis = mod.ac_optimal_power_flow(system, **kw)
        mod.solve(analysis)
        spec = analysis._spec
        k = sorted({f[0] for f in spec.flows})[0]
        n_flows = len(spec.flows)
        remove(analysis, constraint="flow", label=system.branch.label.label(k))
        assert analysis._spec is spec and len(spec.flows) < n_flows
        assert all(f[0] != k for f in spec.flows)
        mod.solve(analysis)
        fresh = mod.ac_optimal_power_flow(system, **kw)
        assert any(f[0] == k for f in fresh._spec.flows)
        runs.append(analysis)
    jax_run, port = runs
    assert port.method.result.status in ("optimal", "acceptable")
    assert abs(port.method.objective - jax_run.method.objective) <= \
        1e-6 * abs(jax_run.method.objective)
    np.testing.assert_allclose(port.voltage.magnitude,
                               np.asarray(jax_run.voltage.magnitude),
                               atol=1e-5)
    with pytest.raises(ValueError, match="balance"):
        remove_constraint(port, constraint="balance",
                          label=port.system.bus.label.label(0))


def test_ac_opf_on_a_cuda_request_without_card_raises(data_path):
    """The entry point runs on the card unless asked for the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    system = jgt.power_system(str(data_path / "case14optimal.m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jgt.ac_optimal_power_flow(system)

