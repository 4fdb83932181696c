"""The port's LAV state estimation (DC, PMU, AC) on the CPU: the
zero-noise reproduction of the power flow of tests/test_lav.py, the AC
Hessian against the JAX package's ``jax.hessian``, the ``state_estimation``
dispatch of the three kinds and the reuse sweep of
tests/test_reusing_matrix.py.

Tolerances: the power-flow reproductions are the reference tests' own
(1e-6 DC and PMU, 1e-5 AC); the AC problem functions are the same
arithmetic in both packages (Hessian 1e-10, h and H 1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
import torch
from juliagrid_tpu.estimation import lav as jax_lav
from juliagrid_tpu_torch.estimation import lav
from juliagrid_tpu_torch.measurement.devices import (add_pmu, add_varmeter,
                                                      add_voltmeter,
                                                      add_wattmeter,
                                                      update_wattmeter)
from juliagrid_tpu_torch.postprocessing import ac as ac_post
from juliagrid_tpu_torch.postprocessing import dc as dc_post
from juliagrid_tpu_torch.system import builders
from juliagrid_tpu_torch.system.model import physical_island

CPU = dict(device="cpu")


def _ac_pf(data_path, pkg=jgt, **dev):
    system = pkg.power_system(str(data_path / "case14test.m"))
    pf = pkg.newton_raphson(system, **dev)
    pkg.power_flow(pf, power=True, current=True)
    return system, pf


def test_dc_lav_reproduces_pf(data_path):
    system = jgt.power_system(str(data_path / "case14test.m"))
    pf = jgt.dc_power_flow(system, **CPU)
    jgt.power_flow(pf)
    dc_post.power(pf)
    monitoring = jgt.measurement(system)
    add_wattmeter(monitoring, analysis=pf)
    se = lav.dc_lav_state_estimation(monitoring, **CPU)
    lav.dc_lav_solve(se)
    assert se.method.converged
    np.testing.assert_allclose(se.voltage.angle, pf.voltage.angle, atol=1e-6)


def test_pmu_lav_reproduces_pf(data_path):
    system, pf = _ac_pf(data_path, **CPU)
    monitoring = jgt.measurement(system)
    add_pmu(monitoring, analysis=pf)
    se = lav.pmu_lav_state_estimation(monitoring, **CPU)
    lav.pmu_lav_solve(se)
    assert se.method.converged
    np.testing.assert_allclose(se.voltage.magnitude, pf.voltage.magnitude,
                               atol=1e-6)
    np.testing.assert_allclose(se.voltage.angle, pf.voltage.angle,
                               atol=1e-6)


def _scada(pkg, system, pf):
    mon = pkg.measurement(system)
    pkg.add_voltmeter(mon, analysis=pf)
    pkg.add_wattmeter(mon, analysis=pf)
    pkg.add_varmeter(mon, analysis=pf)
    return mon


def test_ac_lav_reproduces_pf(data_path):
    system, pf = _ac_pf(data_path, **CPU)
    se = lav.ac_lav_state_estimation(_scada(jgt, system, pf), **CPU)
    lav.lav_solve(se)
    np.testing.assert_allclose(se.voltage.magnitude, pf.voltage.magnitude,
                               atol=1e-5)
    np.testing.assert_allclose(se.voltage.angle, pf.voltage.angle,
                               atol=1e-5)


def test_ac_lav_problem_and_hessian_match_jax(data_path):
    """h, H and the Hessian −Σ yᵢ∇²hᵢ of the AC LAV problem (every row
    type of the SCADA set plus polar and rectangular PMUs) at a seeded
    state and seeded duals, against the JAX package's functions."""
    def build(pkg, **dev):
        system, pf = _ac_pf(data_path, pkg, **dev)
        mon = _scada(pkg, system, pf)
        pkg.add_ammeter(mon, analysis=pf)
        pkg.add_pmu(mon, analysis=pf)
        pkg.add_pmu(mon, analysis=pf, polar=True)
        return pkg.ac_lav_state_estimation(mon, **dev)

    jse, tse = build(jg), build(jgt, **CPU)
    n = jse.system.bus.number
    active = np.flatnonzero(np.asarray(jse.arrays.status) == 1)
    m_act = len(active)
    assert m_act == int((tse.arrays.status == 1).sum())
    rng = np.random.default_rng(17)
    x = np.concatenate([rng.normal(0.0, 0.1, n),
                        1.0 + rng.normal(0.0, 0.03, n),
                        rng.uniform(0.0, 0.1, 2 * m_act)])
    y = rng.normal(size=m_act + 1)
    jp = {"arr": jse.arrays, "net": jse.net,
          "z": jnp.asarray(np.asarray(jse.arrays.mean)[active]),
          "act": jnp.asarray(active), "slack": jnp.asarray(0),
          "anchor": jnp.asarray(0.0)}
    tp = {"arr": tse.arrays, "net": tse.net,
          "z": tse.arrays.mean[torch.as_tensor(active)],
          "act": torch.as_tensor(active), "slack": 0, "anchor": 0.0}
    jfn = jax_lav._ac_lav_fns(n, m_act)
    tfn = lav._ac_lav_fns(n, m_act)
    xj, xt = jnp.asarray(x), torch.tensor(x)
    for k, name in ((1, "eq"), (3, "jac_eq"), (4, "jac_ineq")):
        np.testing.assert_allclose(tfn[k](xt, tp).numpy(),
                                   np.asarray(jfn[k](xj, jp)), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    want = np.asarray(jfn[5](xj, jnp.asarray(y), jnp.zeros(2 * m_act), jp))
    got = tfn[5](xt, torch.tensor(y), torch.zeros(2 * m_act), tp).numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    # the batched h of the line search: row by row as single states
    xb = torch.tensor(np.stack([x, x * 0.99]))
    torch.testing.assert_close(
        tfn[1](xb, tp), torch.stack([tfn[1](v, tp) for v in xb]),
        rtol=0, atol=0)


def _planted_dc(data_path):
    """case14test DC wattmeters (every injection and flow) from the DC
    power flow, with one flow meter 1 p.u. off."""
    system = jgt.power_system(str(data_path / "case14test.m"))
    pf = jgt.dc_power_flow(system, **CPU)
    jgt.power_flow(pf, power=True)
    mon = jgt.measurement(system)
    add_wattmeter(mon, analysis=pf)
    label = mon.wattmeter.label.label(20)
    update_wattmeter(mon, label,
                     active=float(mon.wattmeter.active.mean[20]) * 100 + 100)
    return system, mon, pf


def test_state_estimation_runs_dc_lav_not_wls(data_path):
    """A DC LAV analysis goes to the LP (the JAX package's dispatch sends it
    to the WLS solve): with one gross error among redundant wattmeters LAV
    gives the power flow back, WLS does not."""
    system, mon, pf = _planted_dc(data_path)
    se = jgt.dc_lav_state_estimation(mon, **CPU)
    jgt.state_estimation(se)
    wls = jgt.dc_state_estimation(mon, **CPU)
    jgt.state_estimation(wls)
    assert se.method.converged and se.method.iteration > 0
    np.testing.assert_allclose(se.voltage.angle, pf.voltage.angle, atol=1e-6)
    assert np.abs(wls.voltage.angle - pf.voltage.angle).max() > 1e-2


def test_state_estimation_runs_pmu_and_ac_lav(data_path):
    system, pf = _ac_pf(data_path, **CPU)
    pmon = jgt.measurement(system)
    add_pmu(pmon, analysis=pf)
    pse = jgt.pmu_lav_state_estimation(pmon, **CPU)
    jgt.state_estimation(pse, iteration=200)
    assert pse.method.name == "pmu_lav" and pse.method.iteration > 0
    np.testing.assert_allclose(pse.voltage.angle, pf.voltage.angle,
                               atol=1e-6)
    ase = jgt.ac_lav_state_estimation(_scada(jgt, system, pf), **CPU)
    jgt.state_estimation(ase, iteration=200, power=True)
    assert ase.method.converged and ase.power is not None
    np.testing.assert_allclose(ase.voltage.magnitude, pf.voltage.magnitude,
                               atol=1e-5)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_lav_cuda_request_without_card_raises(data_path):
    system, pf = _ac_pf(data_path, **CPU)
    mon = _scada(jgt, system, pf)
    for build in (jgt.ac_lav_state_estimation, jgt.dc_lav_state_estimation,
                  jgt.pmu_lav_state_estimation):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(mon)


# ---------------------------------------------------------------------------
# reuse after edits (test_reusing_matrix.py::test_lav_se_reuse_matches_fresh)
# ---------------------------------------------------------------------------

def _monitored(data_path, pmu_every=4):
    system, pf = _ac_pf(data_path, **CPU)
    mon = jgt.measurement(system)
    add_voltmeter(mon, analysis=pf, noise=False)
    add_wattmeter(mon, analysis=pf, noise=False)
    add_varmeter(mon, analysis=pf, noise=False)
    for b in range(0, system.bus.number, pmu_every):
        add_pmu(mon, bus=system.bus.label.label(b),
                magnitude=float(pf.voltage.magnitude[b]),
                angle=float(pf.voltage.angle[b]), polar=True, noise=False)
    return system, mon


def _removable_branch(system):
    for k in range(system.branch.number):
        if system.branch.layout.status[k] != 1:
            continue
        system.branch.layout.status[k] = 0
        connected = len(physical_island(system)) == 1
        system.branch.layout.status[k] = 1
        if connected:
            return k
    raise AssertionError("no removable branch")


LAV_EDITS = {
    "watt_value": lambda s, mon: update_wattmeter(
        mon, mon.wattmeter.label.label(2), active=0.31),
    "watt_off": lambda s, mon: update_wattmeter(
        mon, mon.wattmeter.label.label(5), status=0),
    "branch_off": lambda s, mon: builders.update_branch(
        s, s.branch.label.label(_removable_branch(s)), status=0),
}


@pytest.mark.parametrize("edit", list(LAV_EDITS))
def test_lav_se_reuse_matches_fresh(data_path, edit):
    system, mon = _monitored(data_path)
    live = jgt.ac_lav_state_estimation(mon, **CPU)
    jgt.state_estimation(live)

    LAV_EDITS[edit](system, mon)

    fresh = jgt.ac_lav_state_estimation(mon, **CPU)
    jgt.state_estimation(live)
    jgt.state_estimation(fresh)
    np.testing.assert_allclose(live.voltage.magnitude,
                               fresh.voltage.magnitude, atol=5e-6)
    np.testing.assert_allclose(live.voltage.angle, fresh.voltage.angle,
                               atol=5e-6)
