"""The port's observability analysis and PMU placement (a copy of the JAX
package's host code) on the port's analyses: the six tests of
tests/test_observability.py, with islands, tie sets, restored measurement
sets and PMU placements equal to the JAX package's on the same input."""

import numpy as np
import pytest

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.measurement import configuration as jax_conf
from juliagrid_tpu_torch.measurement import configuration as torch_conf


@pytest.fixture(scope="module")
def solved14(data_path):
    """case14test solved by each package: (JAX system, pf), (port ...)."""
    path = str(data_path / "case14test.m")
    js = jg.power_system(path)
    jpf = jg.newton_raphson(js)
    jg.power_flow(jpf, power=True, current=True)
    ts = jgt.power_system(path)
    tpf = jgt.newton_raphson(ts, device="cpu")
    jgt.power_flow(tpf, power=True, current=True)
    return (js, jpf), (ts, tpf)


def _same_islands(j, t):
    assert t.island == j.island
    assert np.array_equal(t.bus, j.bus)
    assert (t.tie.bus, t.tie.branch, t.tie.injection) == \
        (j.tie.bus, j.tie.branch, j.tie.injection)


def flows_only(pkg, system, pf):
    mon = pkg.measurement(system)
    pkg.add_wattmeter(mon, analysis=pf, status_bus=-1)
    pkg.add_varmeter(mon, analysis=pf, status_bus=-1)
    return mon


def injections_only(pkg, system, pf):
    mon = pkg.measurement(system)
    pkg.add_wattmeter(mon, analysis=pf, status_from=-1, status_to=-1)
    pkg.add_varmeter(mon, analysis=pf, status_from=-1, status_to=-1)
    return mon


def nothing(pkg, system, pf):
    return pkg.measurement(system)


@pytest.mark.parametrize("build,flow,islands", [
    (flows_only, True, 1), (nothing, False, 14), (injections_only, False, 1)])
def test_islands_match_jax(solved14, build, flow, islands):
    """test_observability.py:35 (flow islands of full flow measurements),
    :46 (no measurements: singletons) and :53 (injections merge)."""
    (js, jpf), (ts, tpf) = solved14
    fn = "island_topological_flow" if flow else "island_topological"
    j = getattr(jg, fn)(build(jg, js, jpf))
    t = getattr(jgt, fn)(build(jgt, ts, tpf))
    assert len(t.island) == islands
    _same_islands(j, t)
    if flow:
        assert sorted(t.island[0]) == list(range(ts.bus.number))
        assert not t.tie.branch


def _ten_flows(pkg, system, pf):
    """Flows on the first ten in-service branches only."""
    mon = pkg.measurement(system)
    added = 0
    for k in range(system.branch.number):
        if system.branch.layout.status[k] != 1 or added >= 10:
            continue
        label = system.branch.label.label(k)
        pkg.add_wattmeter(mon, from_branch=label,
                          active=float(pf.power.from_.active[k]))
        pkg.add_varmeter(mon, from_branch=label,
                         reactive=float(pf.power.from_.reactive[k]))
        added += 1
    return mon


def test_restoration_promotes_pseudo(solved14):
    """test_observability.py:63 on the port; the restored sets equal the
    JAX package's, and the port's Gauss-Newton estimates the PF state."""
    (js, jpf), (ts, tpf) = solved14
    out = []
    for pkg, system, pf in ((jg, js, jpf), (jgt, ts, tpf)):
        mon = _ten_flows(pkg, system, pf)
        islands = pkg.island_topological(mon)
        assert len(islands.island) > 1
        pseudo = injections_only(pkg, system, pf)
        n_before = mon.wattmeter.number
        pkg.restoration_gram(mon, pseudo, islands)
        assert mon.wattmeter.number > n_before
        out.append((mon, islands, pkg.island_topological(mon)))
    (jmon, jis, jis2), (tmon, tis, tis2) = out
    _same_islands(jis, tis)
    _same_islands(jis2, tis2)
    assert len(tis2.island) == 1
    for family in ("wattmeter", "varmeter"):
        j, t = getattr(jmon, family), getattr(tmon, family)
        assert t.number == j.number
        assert np.array_equal(t.layout.index.array, j.layout.index.array)
        assert t.label._keys == j.label._keys

    jgt.add_voltmeter(tmon, analysis=tpf)
    se = jgt.gauss_newton(tmon, device="cpu")
    jgt.state_estimation(se)
    assert se.method.converged
    np.testing.assert_allclose(se.voltage.magnitude, tpf.voltage.magnitude,
                               atol=1e-6)


def test_pmu_placement_observable(solved14):
    """test_observability.py:99 on the port: ``pmu_placement_apply`` on
    the port's solved NR analysis places the JAX package's PMUs, and the
    port's PMU estimator reproduces the power flow."""
    (js, jpf), (ts, tpf) = solved14
    jplace = jg.pmu_placement_apply(jg.measurement(js), jpf)
    monitoring = jgt.measurement(ts)
    placement = jgt.pmu_placement_apply(monitoring, tpf)
    assert (placement.bus, placement.from_, placement.to) == \
        (jplace.bus, jplace.from_, jplace.to)
    assert len(placement.bus) >= 3
    se = jgt.pmu_state_estimation(monitoring, device="cpu")
    jgt.state_estimation(se)
    np.testing.assert_allclose(se.voltage.magnitude, tpf.voltage.magnitude,
                               atol=1e-6)
    np.testing.assert_allclose(se.voltage.angle, tpf.voltage.angle,
                               atol=1e-6)
    legacy = jgt.pmu_placement(_ten_flows(jgt, ts, tpf), legacy=True)
    jlegacy = jg.pmu_placement(_ten_flows(jg, js, jpf), legacy=True)
    assert legacy.bus == jlegacy.bus


def test_restoration_with_reference_fixtures(data_path):
    """test_observability.py:113 on the port, against the JAX package."""
    out = []
    for pkg, conf in ((jg, jax_conf), (jgt, torch_conf)):
        system, monitoring, pseudo = pkg.ems(
            str(data_path / "case14.h5"), str(data_path / "monitoring.h5"),
            str(data_path / "pseudo.h5"))
        conf.seed(4)
        pkg.status_wattmeter(monitoring, inservice=10)
        for i in range(monitoring.varmeter.number):
            monitoring.varmeter.reactive.status[i] = \
                monitoring.wattmeter.active.status[i]
        for i in range(monitoring.pmu.number):
            monitoring.pmu.magnitude.status[i] = 0
            monitoring.pmu.angle.status[i] = 0
        monitoring.changed()
        islands = pkg.island_topological(monitoring)
        pkg.restoration_gram(monitoring, pseudo, islands)
        out.append((islands, pkg.island_topological(monitoring)))
    (jis, jis2), (tis, tis2) = out
    _same_islands(jis, tis)
    _same_islands(jis2, tis2)
    assert len(tis.island) > 1 and len(tis2.island) < len(tis.island)
