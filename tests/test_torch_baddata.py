"""The port's bad-data processing against the JAX package on the CPU: the
four tests of tests/test_baddata.py in the port's form, the projection
diagonal, ``residual_test`` and ``chi_test`` against the JAX package on AC,
DC and PMU sets fed identical values, the two Takahashi tests on the port's
copy, and the three faults of the JAX package the port does not copy.

Tolerances: projection diagonals to 1e-10, chi objectives to 1e-10
relative, normalized residuals to 1e-8 relative, LNR states to 1e-9 (the
JAX package factors in f32 and refines; the port factors in f64)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.estimation import baddata as jax_bad
from juliagrid_tpu.estimation import takahashi as jax_taka
from juliagrid_tpu_torch.estimation import baddata as torch_bad
from juliagrid_tpu_torch.estimation.takahashi import (projection_diag_sparse,
                                                      takahashi_diag)


def _case(data_path, name="case14test.m"):
    return str(data_path / name)


def ac_set(pkg, system, pf):
    """SCADA with wattmeter 5 planted at 5.0 (test_baddata.py:54)."""
    mon = pkg.measurement(system)
    pkg.add_voltmeter(mon, analysis=pf)
    pkg.add_wattmeter(mon, analysis=pf)
    pkg.add_varmeter(mon, analysis=pf)
    pkg.update_wattmeter(mon, mon.wattmeter.label.label(5), active=5.0)
    return mon


def dc_set(pkg, system, pf):
    """Every wattmeter, flow 20 planted at 10.0 (test_baddata.py:23)."""
    mon = pkg.measurement(system)
    pkg.add_wattmeter(mon, analysis=pf)
    pkg.update_wattmeter(mon, mon.wattmeter.label.label(20), active=10.0)
    return mon


def pmu_set(pkg, system, pf):
    """Rectangular PMUs everywhere, the magnitude of PMU 3 planted at
    1.5."""
    mon = pkg.measurement(system)
    pkg.add_pmu(mon, analysis=pf)
    pkg.update_pmu(mon, mon.pmu.label.label(3), magnitude=1.5)
    return mon


SETS = {"ac": (ac_set, "newton_raphson", "gauss_newton"),
        "dc": (dc_set, "dc_power_flow", "dc_state_estimation"),
        "pmu": (pmu_set, "newton_raphson", "pmu_state_estimation")}


def _solved_pair(data_path, kind):
    """The same planted set estimated by each package, from one JAX power
    flow (identical measurement values): (JAX analysis, port analysis)."""
    build, flow, estimator = SETS[kind]
    path = _case(data_path)
    pf = getattr(jg, flow)(jg.power_system(path))
    jg.power_flow(pf, power=True, current=kind != "dc")
    jse = getattr(jg, estimator)(build(jg, jg.power_system(path), pf))
    tse = getattr(jgt, estimator)(build(jgt, jgt.power_system(path), pf),
                                  device="cpu")
    jg.state_estimation(jse)
    jgt.state_estimation(tse)
    return jse, tse


@pytest.mark.parametrize("kind", ["ac", "dc", "pmu"])
def test_projection_diag_matches_jax(data_path, kind):
    jse, tse = _solved_pair(data_path, kind)
    if kind == "ac":
        jg.estimation.acse.residuals(jse)
        h, w = jse.method.jacobian, jse.method.precision_diag
        mask = [int(jse.arrays.slack)]
    else:
        h, w = np.asarray(jse.arrays.h_dense), np.asarray(jse.arrays.w)
        mask = [int(jse.arrays.slack)] if kind == "dc" else None
    want = np.asarray(jax_bad._projection_diag(h, w, mask_cols=mask))
    got = torch_bad._projection_diag(torch.tensor(h), torch.tensor(w), mask)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("kind", ["ac", "dc", "pmu"])
def test_residual_and_chi_tests_match_jax(data_path, kind):
    jse, tse = _solved_pair(data_path, kind)
    jchi, tchi = jax_bad.chi_test(jse), torch_bad.chi_test(tse)
    assert tchi.detect and jchi.detect
    assert tchi.treshold == jchi.treshold
    np.testing.assert_allclose(tchi.objective, jchi.objective, rtol=1e-10)
    jbad = jax_bad.residual_test(jse, threshold=3.0)
    tbad = torch_bad.residual_test(tse, threshold=3.0)
    assert tbad.detect and jbad.detect
    assert (tbad.index, tbad.label) == (jbad.index, jbad.label)
    np.testing.assert_allclose(tbad.max_normalized_residual,
                               jbad.max_normalized_residual, rtol=1e-8)
    for family in ("wattmeter", "pmu"):
        jmeter = getattr(jse.monitoring, family)
        tmeter = getattr(tse.monitoring, family)
        status = "active" if family == "wattmeter" else "magnitude"
        assert np.array_equal(getattr(jmeter, status).status.array,
                              getattr(tmeter, status).status.array)


def test_dc_outlier_detection(data_path):
    """test_baddata.py:23 on the port."""
    system = jgt.power_system(_case(data_path))
    pf = jgt.dc_power_flow(system, device="cpu")
    jgt.power_flow(pf, power=True)
    monitoring = dc_set(jgt, system, pf)
    bad_label = monitoring.wattmeter.label.label(20)
    se = jgt.dc_state_estimation(monitoring, device="cpu")
    jgt.state_estimation(se)
    assert jgt.chi_test(se).detect
    bad = jgt.residual_test(se, threshold=3.0)
    assert bad.detect and bad.label == bad_label
    assert monitoring.wattmeter.active.status[20] == 0
    se2 = jgt.dc_state_estimation(monitoring, device="cpu")
    jgt.state_estimation(se2)
    np.testing.assert_allclose(se2.voltage.angle, pf.voltage.angle,
                               atol=1e-8)
    assert not jgt.chi_test(se2).detect


def _ac_planted(data_path, planted):
    system = jgt.power_system(_case(data_path))
    pf = jgt.newton_raphson(system, device="cpu")
    jgt.power_flow(pf, power=True, current=True)
    mon = jgt.measurement(system)
    jgt.add_voltmeter(mon, analysis=pf)
    jgt.add_wattmeter(mon, analysis=pf)
    jgt.add_varmeter(mon, analysis=pf)
    for idx, value in planted:
        jgt.update_wattmeter(mon, mon.wattmeter.label.label(idx),
                             active=value)
    return pf, mon


def test_ac_outlier_detection(data_path):
    """test_baddata.py:54 on the port."""
    pf, monitoring = _ac_planted(data_path, [(5, 5.0)])
    se = jgt.gauss_newton(monitoring, device="cpu")
    jgt.state_estimation(se)
    assert jgt.chi_test(se).detect
    bad = jgt.residual_test(se, threshold=3.0)
    assert bad.detect and bad.label == monitoring.wattmeter.label.label(5)
    se2 = jgt.gauss_newton(monitoring, device="cpu")
    jgt.state_estimation(se2)
    assert se2.method.converged
    np.testing.assert_allclose(se2.voltage.magnitude, pf.voltage.magnitude,
                               atol=1e-7)
    assert not jgt.chi_test(se2).detect


def test_residual_test_sparse_path_matches(data_path):
    """test_baddata.py:85 on the port: the host Takahashi path names the
    device the dense projection names."""
    _, monitoring = _ac_planted(data_path, [(8, 4.0)])
    se = jgt.gauss_newton(monitoring, device="cpu")
    jgt.state_estimation(se)
    dense = jgt.residual_test(se, threshold=3.0, sparse=False)
    monitoring.wattmeter.active.status[8] = 1
    monitoring.changed()
    se2 = jgt.gauss_newton(monitoring, device="cpu")
    jgt.state_estimation(se2)
    sparse = jgt.residual_test(se2, threshold=3.0, sparse=True)
    assert dense.label == sparse.label == monitoring.wattmeter.label.label(8)
    assert abs(dense.max_normalized_residual
               - sparse.max_normalized_residual) < 1e-6


def test_lnr_removal_matches_stepwise_and_jax(data_path):
    """test_baddata.py:114 on the port: ``lnr_removal`` removes the devices
    the stepwise residual_test + state_estimation loop removes, in the same
    order, and so does the JAX package's fused loop; the states agree."""
    planted = [(5, 5.0), (12, -4.0)]
    _, mon_a = _ac_planted(data_path, planted)
    se_a = jgt.gauss_newton(mon_a, device="cpu")
    jgt.state_estimation(se_a)
    removed_a = []
    for _ in range(10):
        bad = jgt.residual_test(se_a, threshold=3.0)
        if not bad.detect:
            break
        removed_a.append(bad.label)
        jgt.state_estimation(se_a)

    _, mon_b = _ac_planted(data_path, planted)
    se_b = jgt.gauss_newton(mon_b, device="cpu")
    removed_b = jgt.lnr_removal(se_b, threshold=3.0, max_remove=10)

    system = jg.power_system(_case(data_path))
    pf = jg.newton_raphson(system)
    jg.power_flow(pf, power=True, current=True)
    mon_c = ac_set(jg, system, pf)
    jg.update_wattmeter(mon_c, mon_c.wattmeter.label.label(12), active=-4.0)
    se_c = jg.gauss_newton(mon_c)
    removed_c = jax_bad.lnr_removal(se_c, threshold=3.0, max_remove=10)

    assert len(removed_a) == 2
    assert removed_b == removed_a == removed_c
    assert se_b.method.converged
    for part in ("magnitude", "angle"):
        np.testing.assert_allclose(getattr(se_b.voltage, part),
                                   getattr(se_a.voltage, part), atol=1e-9)
        np.testing.assert_allclose(getattr(se_b.voltage, part),
                                   np.asarray(getattr(se_c.voltage, part)),
                                   atol=1e-9)
    np.testing.assert_array_equal(mon_b.wattmeter.active.status,
                                  mon_a.wattmeter.active.status)
    # the revision bump was absorbed: a re-solve starts converged
    jgt.state_estimation(se_b)
    assert se_b.method.iteration == 0


def test_takahashi_diag_matches_dense():
    """test_takahashi.py:11 on the port's copy."""
    m = sp.random(40, 40, density=0.1, random_state=3)
    a = (m @ m.T + 10 * sp.eye(40)).tocsc()
    np.testing.assert_allclose(takahashi_diag(a),
                               np.diag(np.linalg.inv(a.toarray())),
                               rtol=1e-8)
    np.testing.assert_array_equal(takahashi_diag(a),
                                  jax_taka.takahashi_diag(a))


def test_projection_diag_sparse_matches_dense(data_path):
    """test_takahashi.py:21 on the port's copy and DC analysis."""
    system = jgt.power_system(_case(data_path))
    pf = jgt.dc_power_flow(system, device="cpu")
    jgt.power_flow(pf, power=True)
    monitoring = jgt.measurement(system)
    jgt.add_wattmeter(monitoring, analysis=pf)
    se = jgt.dc_state_estimation(monitoring, device="cpu")
    jgt.state_estimation(se)
    arr = se.arrays
    c_dense = torch_bad._projection_diag(arr.h_dense, arr.w, [arr.slack])
    c_sparse = projection_diag_sparse(sp.csr_matrix(arr.h_dense.numpy()),
                                      arr.w.numpy(), mask_cols=[arr.slack])
    np.testing.assert_allclose(c_sparse, c_dense.numpy(), atol=1e-8)


# ---- faults of the JAX package the port does not copy (ROADMAP queue 3) ----

def test_lnr_removal_reports_an_unconverged_final_solve(data_path):
    """The JAX package's lnr_removal sets converged = True whatever its
    solves did (baddata.py:288); the port reports the final solve's
    max|dx| < tolerance."""
    _, mon = _ac_planted(data_path, [(5, 5.0), (12, -4.0)])
    se = jgt.gauss_newton(mon, device="cpu")
    jgt.lnr_removal(se, max_iter=1)
    assert not se.method.converged
    _, mon = _ac_planted(data_path, [(5, 5.0), (12, -4.0)])
    se = jgt.gauss_newton(mon, device="cpu")
    jgt.lnr_removal(se)
    assert se.method.converged


def test_lnr_removal_refuses_more_than_the_device_holds(data_path,
                                                       monkeypatch):
    """The JAX package forms the dense H and G⁻¹Hᵀ with no guard
    (baddata.py:204); the port checks about 3·m·2n·8 bytes against the
    device's free memory first and names the stepwise loop."""
    _, mon = _ac_planted(data_path, [(5, 5.0)])
    se = jgt.gauss_newton(mon, device="cpu")
    m, n2 = se.arrays.mean.shape[0], 2 * se.system.bus.number
    monkeypatch.setattr(torch_bad, "_free_bytes",
                        lambda device: 3 * m * n2 * 8 - 1)
    with pytest.raises(MemoryError, match=r"residual_test\(analysis, "
                       r"sparse=True\), then state_estimation"):
        jgt.lnr_removal(se)
    assert mon.wattmeter.active.status[5] == 1
    monkeypatch.setattr(torch_bad, "_free_bytes",
                        lambda device: 3 * m * n2 * 8)
    assert jgt.lnr_removal(se) == [mon.wattmeter.label.label(5)]


def test_dc_residuals_with_a_nonzero_slack_angle(data_path):
    """The JAX package's residual_test and chi_test take r = z - Hθ
    (baddata.py:131,315), off by θ_slack on every PMU angle row; the port
    takes z - H(θ - θ_slack) as dc_se_solve does. A zero-noise set with a
    slack angle of 0.2 rad and PMU angle rows detects nothing."""
    system = jgt.power_system(_case(data_path))
    system.bus.voltage.angle[system.bus.layout.slack] = 0.2
    pf = jgt.dc_power_flow(system, device="cpu")
    jgt.power_flow(pf, power=True)
    mon = jgt.measurement(system)
    jgt.add_wattmeter(mon, analysis=pf)
    for b in range(0, system.bus.number, 3):
        jgt.add_pmu(mon, bus=system.bus.label.label(b), magnitude=1.0,
                    angle=float(pf.voltage.angle[b]))
    se = jgt.dc_state_estimation(mon, device="cpu")
    jgt.state_estimation(se)
    np.testing.assert_allclose(se.voltage.angle, pf.voltage.angle,
                               atol=1e-8)
    assert not jgt.chi_test(se).detect
    bad = jgt.residual_test(se)
    assert not bad.detect and bad.max_normalized_residual < 1e-6
