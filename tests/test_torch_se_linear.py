"""The port's linear state estimators (DC and PMU WLS) against the JAX
package on the CPU: the same measurement tables bit for bit, states within
1e-10 of the JAX package (LU and QR), the power-flow state within 1e-8 of
zero-noise sets (tests/test_estimation.py:107,118), the arrays carried
across from the JAX package, and the ``state_estimation`` dispatch.

Tolerance: the JAX package factors the gain in f32 and refines in f64, the
port factors it in f64; the states differ at about 1e-13."""

import types

import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.estimation import dcse as jax_dcse
from juliagrid_tpu.estimation import pmuse as jax_pmuse
from juliagrid_tpu_torch.convert import (dcse_arrays_from_numpy,
                                         pmuse_arrays_from_numpy)
from juliagrid_tpu_torch.estimation import dcse as torch_dcse
from juliagrid_tpu_torch.estimation import pmuse as torch_pmuse

STATE_TOL = dict(rtol=0, atol=1e-10)


def dc_set(pkg, system, pf):
    """Every wattmeter, one out of service, and bus-angle PMUs (one out of
    service) from the DC power flow ``pf``."""
    mon = pkg.measurement(system)
    pkg.add_wattmeter(mon, analysis=pf)
    pkg.update_wattmeter(mon, mon.wattmeter.label.label(2), status=0)
    for b in (0, 3, 7):
        pkg.add_pmu(mon, bus=system.bus.label.label(b), magnitude=1.0,
                    angle=float(pf.voltage.angle[b]), status=int(b != 3))
    return mon


def pmu_set(pkg, system, pf):
    """Rectangular PMUs everywhere (to-branch ones out of service), plus a
    second, correlated set without the from-branch PMUs."""
    mon = pkg.measurement(system)
    pkg.add_pmu(mon, analysis=pf, status_to=0)
    pkg.add_pmu(mon, analysis=pf, correlated=True, status_from=0)
    return mon


def pmu_plain(pkg, system, pf):
    mon = pkg.measurement(system)
    pkg.add_pmu(mon, analysis=pf)
    return mon


KINDS = {
    "dc": (dc_set, jg.dc_power_flow, jg.dc_state_estimation,
           jgt.dc_state_estimation),
    "pmu": (pmu_plain, jg.newton_raphson, jg.pmu_state_estimation,
            jgt.pmu_state_estimation),
    "pmu_correlated": (pmu_set, jg.newton_raphson, jg.pmu_state_estimation,
                       jgt.pmu_state_estimation),
}


def _sets(data_path, case, kind):
    """The same measurement set in each package, from one JAX power flow
    (so that both read identical values): (JAX monitoring, port
    monitoring, the JAX power flow)."""
    build, flow = KINDS[kind][:2]
    path = str(data_path / case)
    pf = flow(jg.power_system(path))
    jg.power_flow(pf, power=True, current=kind != "dc")
    return (build(jg, jg.power_system(path), pf),
            build(jgt, jgt.power_system(path), pf), pf)


@pytest.mark.parametrize("case", ["case14test.m", "case30test.m"])
@pytest.mark.parametrize("kind", ["dc", "pmu_correlated"])
def test_tables_equal_jax(data_path, case, kind):
    """H scattered on the device from host COO equals the JAX package's
    dense host H bit for bit, and so do the other fields."""
    jmon, tmon, _ = _sets(data_path, case, kind)
    if kind == "dc":
        jarr, jdev, jin = jax_dcse.compile_dcse_arrays(jmon.system, jmon)
        tarr, tdev, tin = torch_dcse.compile_dcse_arrays(
            tmon.system, tmon, device="cpu")
        assert jdev == tdev
    else:
        jarr, jin = jax_pmuse.compile_pmuse_arrays(jmon.system, jmon)
        tarr, tin = torch_pmuse.compile_pmuse_arrays(tmon.system, tmon,
                                                     device="cpu")
        assert tarr.pair_r1.numel() > 0
    assert jin == tin
    for name in jarr._fields:
        t = getattr(tarr, name)
        t = t.numpy() if isinstance(t, torch.Tensor) else t
        assert np.array_equal(np.asarray(getattr(jarr, name)), t), name


@pytest.mark.parametrize("factorization", ["LU", "QR"])
@pytest.mark.parametrize("kind", ["dc", "pmu", "pmu_correlated"])
def test_states_match_jax(data_path, kind, factorization):
    jmon, tmon, pf = _sets(data_path, "case14test.m", kind)
    jbuild, tbuild = KINDS[kind][2:]
    jse = jbuild(jmon, factorization)
    tse = tbuild(tmon, factorization, device="cpu")
    jg.state_estimation(jse, power=True)
    jgt.state_estimation(tse, power=True)
    assert tse.method.converged
    for part in ("magnitude", "angle"):
        if hasattr(jse.voltage, part):
            np.testing.assert_allclose(getattr(tse.voltage, part),
                                       np.asarray(getattr(jse.voltage, part)),
                                       **STATE_TOL)
    np.testing.assert_allclose(tse.power.injection.active,
                               np.asarray(jse.power.injection.active),
                               **STATE_TOL)
    np.testing.assert_allclose(tse.method.residual,
                               np.asarray(jse.method.residual),
                               rtol=0, atol=1e-10)
    assert tse.method.inservice == jse.method.inservice


@pytest.mark.parametrize("kind", ["dc", "pmu"])
def test_linear_se_reproduces_pf(data_path, kind):
    """The port's forms of test_estimation.py:107 (PMU) and :118 (DC): a
    zero-noise set from the port's own power flow gives its state back."""
    system = jgt.power_system(str(data_path / "case14test.m"))
    mon = jgt.measurement(system)
    if kind == "dc":
        pf = jgt.dc_power_flow(system, device="cpu")
        jgt.power_flow(pf, power=True)
        jgt.add_wattmeter(mon, analysis=pf)
        se = jgt.dc_state_estimation(mon, device="cpu")
    else:
        pf = jgt.newton_raphson(system, device="cpu")
        jgt.power_flow(pf, power=True, current=True)
        jgt.add_pmu(mon, analysis=pf)
        se = jgt.pmu_state_estimation(mon, device="cpu")
    jgt.state_estimation(se)
    np.testing.assert_allclose(se.voltage.angle, pf.voltage.angle, atol=1e-8)
    if kind == "pmu":
        np.testing.assert_allclose(se.voltage.magnitude,
                                   pf.voltage.magnitude, atol=1e-8)


@pytest.mark.parametrize("kind", ["dc", "pmu_correlated"])
def test_arrays_from_numpy_round_trip(data_path, kind):
    """The JAX package's arrays carried across (``np.asarray`` of each
    field) equal the port's own build and solve to the JAX solve."""
    jmon, tmon, _ = _sets(data_path, "case14test.m", kind)
    if kind == "dc":
        jarr = jax_dcse.compile_dcse_arrays(jmon.system, jmon)[0]
        tarr = dcse_arrays_from_numpy(
            **{f: np.asarray(getattr(jarr, f)) for f in jarr._fields},
            device="cpu")
        own = torch_dcse.compile_dcse_arrays(tmon.system, tmon, "cpu")[0]
        got = [torch_dcse._dcse_solve(tarr, "LU").numpy()]
        want = [np.asarray(jax_dcse._dcse_solve(jarr, "LU"))]
    else:
        jarr = jax_pmuse.compile_pmuse_arrays(jmon.system, jmon)[0]
        tarr = pmuse_arrays_from_numpy(
            **{f: np.asarray(getattr(jarr, f)) for f in jarr._fields},
            device="cpu")
        own = torch_pmuse.compile_pmuse_arrays(tmon.system, tmon, "cpu")[0]
        got = [x.numpy() for x in torch_pmuse._pmuse_solve(tarr, "LU")]
        want = [np.asarray(x) for x in jax_pmuse._pmuse_solve(jarr, "LU")]
    for name in tarr._fields:
        a, b = getattr(tarr, name), getattr(own, name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        else:
            assert a == b, name
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **STATE_TOL)


def test_dispatch_and_lav_refusal(data_path):
    """``state_estimation`` runs DC and PMU analyses through their solves
    and a DC LAV analysis through its interior point (ROADMAP item 12b);
    an analysis of no ported kind raises; and a CUDA request without a
    card raises."""
    _, tmon, _ = _sets(data_path, "case14test.m", "dc")
    se = jgt.dc_state_estimation(tmon, device="cpu")
    assert jgt.state_estimation(se) is se and se.method.converged
    assert isinstance(se.method.jacobian, torch.Tensor)
    lav = jgt.dc_lav_state_estimation(tmon, device="cpu")
    assert jgt.state_estimation(lav) is lav and lav.method.converged
    np.testing.assert_allclose(lav.voltage.angle, se.voltage.angle,
                               atol=1e-6)
    _, tmon, _ = _sets(data_path, "case14test.m", "pmu")
    se = jgt.pmu_state_estimation(tmon, device="cpu")
    assert jgt.state_estimation(se, current=True) is se
    assert se.current is not None
    other = types.SimpleNamespace(method=types.SimpleNamespace(name="wls"))
    with pytest.raises(NotImplementedError, match="is not ported"):
        jgt.state_estimation(other)
    if not torch.cuda.is_available():
        for build in (jgt.dc_state_estimation, jgt.pmu_state_estimation):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build(tmon)
