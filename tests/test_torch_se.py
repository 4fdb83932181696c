"""The port's Gauss-Newton WLS state estimation against the JAX package on
the CPU, on the measurement sets of tests/test_estimation.py: equal
iteration counts and states within 1e-9.

Tolerance: the JAX package factors the gain in f32 and refines in f64; the
port factors it in f64 (Cholesky). The two increments differ at about
1e-12, far inside 1e-9, and the iteration counts agree."""

import jax
import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.estimation.pmuse import pmu_state_estimation
from juliagrid_tpu.parallel.batch import batched_se_solve_jit
from juliagrid_tpu_torch.estimation import acse as torch_acse
from juliagrid_tpu_torch.kernels.se_fill import se_fill_entries_ref
from juliagrid_tpu_torch.parallel import batched_se_solve
from juliagrid_tpu_torch.utils.errors import MethodError_

STATE_TOL = dict(rtol=0, atol=1e-9)


def scada(pkg, system, pf, **kw):
    mon = pkg.measurement(system)
    pkg.add_voltmeter(mon, analysis=pf, **kw)
    pkg.add_wattmeter(mon, analysis=pf, **kw)
    pkg.add_varmeter(mon, analysis=pf, **kw)
    return mon


def amm_pmu(pkg, system, pf):
    mon = scada(pkg, system, pf)
    pkg.add_ammeter(mon, analysis=pf)
    pkg.add_pmu(mon, analysis=pf)
    return mon


def polar(pkg, system, pf):
    mon = scada(pkg, system, pf)
    pkg.add_pmu(mon, analysis=pf, polar=True, status_from=-1, status_to=-1)
    return mon


def correlated(pkg, system, pf):
    mon = scada(pkg, system, pf)
    pkg.add_pmu(mon, analysis=pf, correlated=True)
    return mon


SETS = {"scada": scada, "amm_pmu": amm_pmu, "polar": polar,
        "correlated": correlated}


def _solved(pkg, path, **dev):
    system = pkg.power_system(path)
    pf = pkg.newton_raphson(system, **dev)
    pkg.power_flow(pf, power=True, current=True)
    return system, pf


@pytest.fixture(scope="module")
def pair14(data_path):
    """case14test solved by each package: (JAX system, pf), (port ...)."""
    path = str(data_path / "case14test.m")
    return _solved(jg, path), _solved(jgt, path, device="cpu")


def _both(pair, build, factorization="LU"):
    """The same measurement set and analysis in each package."""
    (js, jpf), (ts, tpf) = pair
    jse = jg.gauss_newton(build(jg, js, jpf), factorization)
    tse = jgt.gauss_newton(build(jgt, ts, tpf), factorization, device="cpu")
    return jse, tse


def _assert_same(port, ref):
    assert port.method.iteration == ref.method.iteration
    assert port.method.converged and ref.method.converged
    np.testing.assert_allclose(port.voltage.magnitude,
                               np.asarray(ref.voltage.magnitude), **STATE_TOL)
    np.testing.assert_allclose(port.voltage.angle,
                               np.asarray(ref.voltage.angle), **STATE_TOL)


@pytest.mark.parametrize("name,factorization", [
    ("scada", "LU"), ("scada", "LDLt"), ("amm_pmu", "LU"), ("polar", "LU"),
    ("correlated", "KLU"), ("scada", "QR"), ("amm_pmu", "QR"),
    ("scada", "PW")])
def test_gauss_newton_matches_jax(pair14, name, factorization):
    jse, tse = _both(pair14, SETS[name], factorization)
    jg.state_estimation(jse, power=True)
    jgt.state_estimation(tse, power=True)
    _assert_same(tse, jse)
    assert tse.method.refine_residual < 1e-6
    np.testing.assert_allclose(tse.power.injection.active,
                               np.asarray(jse.power.injection.active),
                               **STATE_TOL)
    np.testing.assert_allclose(tse.power.supply.reactive,
                               np.asarray(jse.power.supply.reactive),
                               **STATE_TOL)
    # zero-noise measurements: the estimate reproduces the power flow
    pf = pair14[1][1]
    np.testing.assert_allclose(tse.voltage.magnitude, pf.voltage.magnitude,
                               atol=1e-8)


def test_damped_gauss_newton_matches_jax(pair14):
    """Full polar PMU coverage from the linear PMU estimate (computed by
    the JAX package and fed to both), with backtracking."""
    (js, jpf), _ = pair14

    def polar_all(pkg, system, pf):
        mon = scada(pkg, system, pf)
        pkg.add_pmu(mon, analysis=pf, polar=True)
        return mon

    lin = pmu_state_estimation(polar_all(jg, js, jpf))
    jg.state_estimation(lin)
    jse, tse = _both(pair14, polar_all)
    for se in (jse, tse):
        se.voltage.magnitude = np.array(lin.voltage.magnitude)
        se.voltage.angle = np.array(lin.voltage.angle)
    jg.state_estimation(jse, damping=True, iteration=200)
    jgt.state_estimation(tse, damping=True, iteration=200)
    _assert_same(tse, jse)


def test_peters_wilkinson_extreme_weights_match_jax(pair14):
    """PW at a 1e17 weight ratio (test_estimation.py:170-200)."""
    def extreme(pkg, system, pf):
        mon = scada(pkg, system, pf, noise=False)
        pkg.update_voltmeter(mon, mon.voltmeter.label.label(0),
                             variance=1e-18)
        for v in range(1, mon.voltmeter.number):
            pkg.update_voltmeter(mon, mon.voltmeter.label.label(v),
                                 variance=1e-1)
        return mon

    jse, tse = _both(pair14, extreme, "PW")
    jg.state_estimation(jse)
    jgt.state_estimation(tse)
    _assert_same(tse, jse)
    pf = pair14[1][1]
    np.testing.assert_allclose(tse.voltage.magnitude, pf.voltage.magnitude,
                               atol=1e-9)


def test_stepwise_increment_solve_matches_jax(pair14):
    """Reference increment!/solve! loop, and the pending increment."""
    jse, tse = _both(pair14, amm_pmu)
    for inc, slv, se in ((jg.increment, jg.estimation.acse.solve, jse),
                         (jgt.increment, torch_acse.solve, tse)):
        for _ in range(20):
            if inc(se) < 1e-8:
                break
            slv(se)
    assert tse.method.iteration == jse.method.iteration > 0
    np.testing.assert_allclose(tse.method._pending_dx,
                               np.asarray(jse.method._pending_dx), atol=1e-12)
    np.testing.assert_allclose(tse.voltage.magnitude,
                               np.asarray(jse.voltage.magnitude), **STATE_TOL)
    np.testing.assert_allclose(tse.voltage.angle,
                               np.asarray(jse.voltage.angle), **STATE_TOL)


def test_residuals_match_jax(pair14):
    jse, tse = _both(pair14, correlated)
    rng = np.random.default_rng(11)
    n = 14
    vm = np.asarray(jse.voltage.magnitude) + 0.01 * rng.standard_normal(n)
    va = np.asarray(jse.voltage.angle) + 0.01 * rng.standard_normal(n)
    for se in (jse, tse):
        se.voltage.magnitude, se.voltage.angle = vm.copy(), va.copy()
    r_j = jg.estimation.acse.residuals(jse)
    r_t = torch_acse.residuals(tse)
    np.testing.assert_allclose(r_t, r_j, rtol=1e-12, atol=1e-12)
    for name in ("jacobian", "precision_diag", "mean"):
        np.testing.assert_allclose(getattr(tse.method, name),
                                   getattr(jse.method, name),
                                   rtol=1e-12, atol=1e-12)


def test_live_value_patch_matches_jax(pair14):
    """A mean/variance edit after the build patches the row values in place
    (no rebuild) and the next solve follows it, as in the JAX package."""
    jse, tse = _both(pair14, scada)
    jg.state_estimation(jse)
    jgt.state_estimation(tse)
    desc = tse.arrays.desc
    for pkg, se in ((jg, jse), (jgt, tse)):
        mon = se.monitoring
        pkg.update_wattmeter(mon, mon.wattmeter.label.label(2), active=0.3,
                             variance=1e-3)
        pkg.update_varmeter(mon, mon.varmeter.label.label(4), status=0)
    jg.state_estimation(jse)
    jgt.state_estimation(tse)
    assert tse.arrays.desc is desc
    _assert_same(tse, jse)


def test_verbose_run_matches_quiet_run(pair14, capsys):
    (_, _), (ts, tpf) = pair14
    quiet = jgt.gauss_newton(amm_pmu(jgt, ts, tpf), device="cpu")
    jgt.state_estimation(quiet)
    loud = jgt.gauss_newton(amm_pmu(jgt, ts, tpf), device="cpu")
    jgt.state_estimation(loud, verbose=3)
    out = capsys.readouterr().out
    assert "Iteration   Objective Value" in out
    assert "Number of measurement functions:" in out
    assert loud.method.iteration == quiet.method.iteration
    assert loud.method.converged
    np.testing.assert_allclose(loud.voltage.magnitude,
                               quiet.voltage.magnitude, **STATE_TOL)


def test_orthogonal_rejects_correlated_pmus(pair14):
    """Reference acStateEstimation.jl:47-49: rectangular correlated PMUs
    carry 2x2 precision blocks the square-root paths cannot represent."""
    _, (ts, tpf) = pair14
    mon = jgt.measurement(ts)
    jgt.add_voltmeter(mon, analysis=tpf)
    jgt.add_pmu(mon, analysis=tpf, correlated=True)
    for kind in ("QR", "PW"):
        with pytest.raises(MethodError_, match="non-diagonal precision"):
            jgt.gauss_newton(mon, kind, device="cpu")


def test_singular_gain_sets_rel_inf_and_escalates_to_qr(pair14):
    """Voltmeters alone (three sets: H stays taller than wide) leave every
    angle column of H empty: the gain is singular, the Cholesky reports
    it, ``rel`` is inf and the solve goes to the QR path."""
    _, (ts, tpf) = pair14
    mon = jgt.measurement(ts)
    for _ in range(3):
        jgt.add_voltmeter(mon, analysis=tpf)
    se = jgt.gauss_newton(mon, device="cpu")
    jgt.increment(se)
    assert se.method.refine_residual == np.inf
    jgt.state_estimation(se)
    assert se.method.refine_escalated
    assert not se.method.converged


def test_cuda_request_raises_without_card(pair14):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    _, (ts, tpf) = pair14
    mon = scada(jgt, ts, tpf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jgt.gauss_newton(mon)


@pytest.fixture(scope="module")
def fleet118(data_path):
    """case118 with bench.py's SCADA + PMU set (polar bus PMUs on every
    10th bus, no noise), eight scenarios of means base + 0.5 sigma N(0,1)
    from default_rng(3), compiled by the JAX package and carried across."""
    from juliagrid_tpu.estimation.acse import compile_se_arrays
    from juliagrid_tpu_torch.convert import (ac_arrays_from_numpy,
                                             se_arrays_from_numpy)

    system = jg.power_system(str(data_path / "case118.m"))
    pf = jg.newton_raphson(system)
    jg.power_flow(pf, power=True)
    mon = scada(jg, system, pf, noise=False)
    for b in range(0, system.bus.number, 10):
        jg.add_pmu(mon, bus=system.bus.label.label(b),
                   magnitude=float(pf.voltage.magnitude[b]),
                   angle=float(pf.voltage.angle[b]), polar=True, noise=False)
    jarr, _, _, host = compile_se_arrays(system, mon, return_host=True)
    jnet = jg.powerflow.ac.compile_ac_arrays(system)
    rng = np.random.default_rng(3)
    means = host.mean[None, :] + 0.5 / np.sqrt(host.w)[None, :] * \
        rng.standard_normal((8, len(host.mean)))
    n = system.bus.number
    vm0 = np.tile(system.bus.voltage.magnitude.array[:n], (8, 1))
    va0 = np.tile(system.bus.voltage.angle.array[:n], (8, 1))
    tarr = se_arrays_from_numpy(host, "cpu")
    tnet = ac_arrays_from_numpy(
        **{f: np.asarray(getattr(jnet, f)) for f in jnet._fields},
        device="cpu")
    return jarr, jnet, tarr, tnet, vm0, va0, means


def test_batched_se_solve_matches_jax(fleet118):
    jarr, jnet, tarr, tnet, vm0, va0, means = fleet118
    jvm, jva, jit, jconv = batched_se_solve_jit(
        jarr, jnet, jax.numpy.asarray(vm0), jax.numpy.asarray(va0),
        jax.numpy.asarray(means), tol=1e-8, max_iter=40)
    tvm, tva, tit, tconv = batched_se_solve(
        tarr, tnet, torch.tensor(vm0), torch.tensor(va0),
        torch.tensor(means))
    assert bool(np.all(np.asarray(jconv))) and bool(tconv.all())
    assert np.array_equal(tit.numpy(), np.asarray(jit))
    np.testing.assert_allclose(tvm.numpy(), np.asarray(jvm), **STATE_TOL)
    np.testing.assert_allclose(tva.numpy(), np.asarray(jva), **STATE_TOL)


def test_batched_se_solve_scenario_equals_single_solve(fleet118):
    """A fleet scenario ends where the single-case loop ends from the same
    start and means, with the same count; and the fleet loop runs the same
    on an explicit ``fill``."""
    _, _, tarr, tnet, vm0, va0, means = fleet118
    vm, va, iters, conv = batched_se_solve(
        tarr, tnet, torch.tensor(vm0[:2]), torch.tensor(va0[:2]),
        torch.tensor(means[:2]), fill=se_fill_entries_ref)
    one = tarr._replace(mean=torch.tensor(means[1]))
    svm, sva, it, _, converged, _ = torch_acse._se_solve(
        one, tnet, torch.tensor(vm0[1]), torch.tensor(va0[1]), 1e-8, 40,
        "LU")
    assert converged and bool(conv[1]) and int(iters[1]) == it
    np.testing.assert_allclose(vm[1].numpy(), svm.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(va[1].numpy(), sva.numpy(), rtol=0,
                               atol=1e-12)
