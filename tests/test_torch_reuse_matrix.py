"""The JAX package's live-edit ("reuse") matrix run against the port.

tests/test_reusing_matrix.py holds the JAX package to the rule of the
reference's reusing suites: every live edit applied to an already-solved
analysis re-solves to the SAME solution as an analysis freshly built from
the edited system, so the revision protocol never leaves a stale device
array behind. This file runs the same cases on the port (on the CPU), with
the same edit functions, written once here for either package (``pkg`` is
``juliagrid_tpu`` or ``juliagrid_tpu_torch``), and the same tolerances.
Each case asserts two things:

1. the port's reused analysis re-solves to the port's fresh build, at the
   JAX matrix's tolerance for that family (its ``assert_allclose`` call:
   that atol and numpy's default rtol of 1e-7);
2. the port's fresh solve matches the JAX package's fresh solve of the same
   edited case, at that atol alone (rtol 0).

One case has no estimate to compare: PMU state estimation after
``pmu_off`` leaves bus 2 without a measurement. The JAX package's reused
and fresh estimates are both NaN there (its matrix compares NaN to NaN);
the port's reused and fresh analyses both raise on the singular gain
(``torch.linalg.lu_factor``'s zero pivot), as the reference's LU does.

The AC OPF and LAV cases are ``slow`` there, and here.
"""

import numpy as np
import pytest

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt

PORT = {"device": "cpu"}


def _build(pkg, name, target):
    """``pkg.<name>(target)``: the port's analyses on the CPU."""
    return getattr(pkg, name)(target, **(PORT if pkg is jgt else {}))


# ---------------------------------------------------------------------------
# system edits (applied between the first and second solve)
# ---------------------------------------------------------------------------

def _blab(system, i):
    return system.bus.label.label(i)


def _removable_branch(pkg, system):
    """An in-service branch whose outage keeps the island connected."""
    for k in range(system.branch.number):
        if system.branch.layout.status[k] != 1:
            continue
        system.branch.layout.status[k] = 0
        connected = len(pkg.physical_island(system)) == 1
        system.branch.layout.status[k] = 1
        if connected:
            return k
    raise AssertionError("no removable branch")


def e_demand(pkg, s):
    pkg.update_bus(s, _blab(s, 3), active=0.28, reactive=0.09)


def e_shunt(pkg, s):
    pkg.update_bus(s, _blab(s, 8), susceptance=0.22)


def e_setpoint(pkg, s):
    # PV setpoint magnitude (bus 2 of case14 is a generator bus)
    pkg.update_bus(s, _blab(s, 1), magnitude=1.03)


def e_branch_param(pkg, s):
    pkg.update_branch(s, s.branch.label.label(2), reactance=0.3,
                      resistance=0.02)


def e_branch_tap(pkg, s):
    pkg.update_branch(s, s.branch.label.label(7), turns_ratio=1.04,
                      shift_angle=0.015)


def e_branch_off(pkg, s):
    k = _removable_branch(pkg, s)
    pkg.update_branch(s, s.branch.label.label(k), status=0)


def e_branch_off_on(pkg, s):
    k = _removable_branch(pkg, s)
    lab = s.branch.label.label(k)
    pkg.update_branch(s, lab, status=0)
    pkg.update_branch(s, lab, status=1)


def e_gen_output(pkg, s):
    pkg.update_generator(s, s.generator.label.label(1), active=0.42,
                         reactive=0.12)


def _nonslack_gen(s):
    """A generator NOT at the slack bus whose bus hosts only that one."""
    slack = s.bus.layout.slack
    for k in range(s.generator.number):
        if int(s.generator.layout.bus[k]) != slack \
                and s.generator.layout.status[k] == 1:
            return k
    raise AssertionError("no non-slack generator")


def e_gen_off(pkg, s):
    k = _nonslack_gen(s)
    pkg.update_generator(s, s.generator.label.label(k), status=0)


def e_gen_off_on(pkg, s):
    k = _nonslack_gen(s)
    lab = s.generator.label.label(k)
    pkg.update_generator(s, lab, status=0)
    pkg.update_generator(s, lab, status=1)


def e_add_branch(pkg, s):
    pkg.add_branch(s, from_bus=_blab(s, 2), to_bus=_blab(s, 7),
                   reactance=0.35, resistance=0.01)


def e_add_generator(pkg, s):
    pkg.add_generator(s, bus=_blab(s, 4), active=0.15, reactive=0.02,
                      max_active=0.8, min_active=0.0, max_reactive=0.4,
                      min_reactive=-0.4, magnitude=1.02, status=1)


def e_slack_move(pkg, s):
    # re-designate the slack onto generator bus 2 (the old slack demotes)
    pkg.update_bus(s, _blab(s, 1), type=3)


SYSTEM_EDITS = {
    "demand": e_demand,
    "shunt": e_shunt,
    "setpoint": e_setpoint,
    "branch_param": e_branch_param,
    "branch_tap": e_branch_tap,
    "branch_off": e_branch_off,
    "branch_off_on": e_branch_off_on,
    "gen_output": e_gen_output,
    "gen_off": e_gen_off,
    "gen_off_on": e_gen_off_on,
    "add_branch": e_add_branch,
    "add_generator": e_add_generator,
    "slack_move": e_slack_move,
}


# ---------------------------------------------------------------------------
# power-flow families: (constructor, iteration cap, state tolerance)
# ---------------------------------------------------------------------------

PF_FAMILIES = {
    "nr": ("newton_raphson", 100, 1e-9),
    "fnr_bx": ("fast_newton_raphson_bx", 300, 1e-8),
    "fnr_xb": ("fast_newton_raphson_xb", 300, 1e-8),
    "gs": ("gauss_seidel", 3000, 1e-6),
    "dc": ("dc_power_flow", 100, 1e-12),
}

# the full 13-edit sweep runs on NR and DC; the other iterative families
# cover the structurally distinct subset (matrix pattern, slack, shapes)
_PF_EDITS = {
    "nr": list(SYSTEM_EDITS),
    "dc": list(SYSTEM_EDITS),
    "fnr_bx": ["demand", "branch_param", "branch_off", "add_branch",
               "slack_move", "gen_off"],
    "fnr_xb": ["demand", "branch_tap", "branch_off_on", "add_generator",
               "slack_move", "setpoint"],
    "gs": ["demand", "branch_off", "add_branch", "slack_move"],
}

PF_CASES = [(fam, edit) for fam in PF_FAMILIES for edit in _PF_EDITS[fam]]


def _same_voltage(a, b, atol, magnitude=True, rtol=1e-7):
    """The JAX matrix's check (its rtol is numpy's default); ``rtol=0``
    for the port against the JAX package."""
    np.testing.assert_allclose(a.voltage.angle, b.voltage.angle, rtol=rtol,
                               atol=atol)
    if magnitude:
        np.testing.assert_allclose(a.voltage.magnitude, b.voltage.magnitude,
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("family,edit", PF_CASES,
                         ids=[f"{f}-{e}" for f, e in PF_CASES])
def test_pf_reuse_matches_fresh(data_path, family, edit):
    name, iteration, atol = PF_FAMILIES[family]
    path = str(data_path / "case14test.m")
    fresh = {}
    for pkg in (jgt, jg):
        system = pkg.power_system(path)
        if pkg is jgt:
            live = _build(pkg, name, system)
            pkg.power_flow(live, iteration=iteration)
            assert live.method.converged
        SYSTEM_EDITS[edit](pkg, system)
        fresh[pkg] = _build(pkg, name, system)
        pkg.power_flow(fresh[pkg], iteration=iteration)
        assert fresh[pkg].method.converged
    jgt.power_flow(live, iteration=iteration)  # the reused analysis
    assert live.method.converged
    magnitude = getattr(fresh[jgt].voltage, "magnitude", None) is not None
    _same_voltage(live, fresh[jgt], atol, magnitude)
    _same_voltage(fresh[jgt], fresh[jg], atol, magnitude, rtol=0)


# ---------------------------------------------------------------------------
# OPF families
# ---------------------------------------------------------------------------

def e_cost_poly(pkg, s):
    pkg.cost(s, s.generator.label.label(1), active=2,
             polynomial=[820.0, 22.0, 0.008])


def e_cost_piecewise(pkg, s):
    pkg.cost(s, s.generator.label.label(1), active=1,
             piecewise=[[0.0, 2.0], [0.4, 14.0], [0.9, 40.0]])


def e_gen_limits(pkg, s):
    pkg.update_generator(s, s.generator.label.label(1), max_active=0.6,
                         min_active=0.05)


def e_add_generator_cost(pkg, s):
    k = pkg.add_generator(s, bus=_blab(s, 4), active=0.1, max_active=0.7,
                          min_active=0.0, max_reactive=0.3,
                          min_reactive=-0.3, status=1)
    pkg.cost(s, s.generator.label.label(k), active=2,
             polynomial=[100.0, 30.0, 0.02])


OPF_EDITS = {
    "demand": e_demand,
    "branch_param": e_branch_param,
    "branch_off": e_branch_off,
    "add_branch": e_add_branch,
    "add_generator": e_add_generator_cost,
    "gen_limits": e_gen_limits,
    "cost_poly": e_cost_poly,
    "cost_piecewise": e_cost_piecewise,
    "gen_off": e_gen_off,
}


def _opf_pair(path, name, edit):
    """(the port's reused analysis, {pkg: fresh analysis}), all solved."""
    fresh = {}
    for pkg in (jgt, jg):
        system = pkg.power_system(path)
        if pkg is jgt:
            live = _build(pkg, name, system)
            pkg.solve_opf(live)
            assert live.method.converged
        OPF_EDITS[edit](pkg, system)
        fresh[pkg] = _build(pkg, name, system)
        pkg.solve_opf(fresh[pkg])
    jgt.solve_opf(live)
    return live, fresh


@pytest.mark.parametrize("edit", list(OPF_EDITS))
def test_dc_opf_reuse_matches_fresh(data_path, edit):
    live, fresh = _opf_pair(str(data_path / "case14test.m"),
                            "dc_optimal_power_flow", edit)
    for got, want, rtol in ((live, fresh[jgt], 1e-7),
                            (fresh[jgt], fresh[jg], 0)):
        assert got.method.converged and want.method.converged
        np.testing.assert_allclose(got.method.objective,
                                   want.method.objective,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.voltage.angle, want.voltage.angle,
                                   rtol=rtol, atol=1e-5)


_AC_OPF_EDITS = ["demand", "gen_limits", "cost_poly", "cost_piecewise",
                 "branch_off", "add_generator", "add_branch"]


@pytest.mark.slow
@pytest.mark.parametrize("edit", _AC_OPF_EDITS)
def test_ac_opf_reuse_matches_fresh(data_path, edit):
    live, fresh = _opf_pair(str(data_path / "case14optimal.m"),
                            "ac_optimal_power_flow", edit)
    ok = ("optimal", "acceptable")
    for got, want in ((live, fresh[jgt]), (fresh[jgt], fresh[jg])):
        assert got.method.result.status in ok
        assert want.method.result.status in ok
        np.testing.assert_allclose(got.method.objective,
                                   want.method.objective, rtol=1e-5)


# ---------------------------------------------------------------------------
# estimator families: system edits + per-device measurement edits
# ---------------------------------------------------------------------------

def _monitored(pkg, path, pmu_every=4):
    system = pkg.power_system(path)
    pf = _build(pkg, "newton_raphson", system)
    pkg.power_flow(pf, power=True)
    mon = pkg.measurement(system)
    pkg.add_voltmeter(mon, analysis=pf, noise=False)
    pkg.add_wattmeter(mon, analysis=pf, noise=False)
    pkg.add_varmeter(mon, analysis=pf, noise=False)
    for b in range(0, system.bus.number, pmu_every):
        pkg.add_pmu(mon, bus=system.bus.label.label(b),
                    magnitude=float(pf.voltage.magnitude[b]),
                    angle=float(pf.voltage.angle[b]), polar=True,
                    noise=False)
    return system, mon


def m_watt_value(pkg, mon):
    pkg.update_wattmeter(mon, mon.wattmeter.label.label(2), active=0.31)


def m_watt_variance(pkg, mon):
    pkg.update_wattmeter(mon, mon.wattmeter.label.label(2), variance=4e-3)


def m_watt_off(pkg, mon):
    pkg.update_wattmeter(mon, mon.wattmeter.label.label(5), status=0)


def m_watt_off_on(pkg, mon):
    lab = mon.wattmeter.label.label(5)
    pkg.update_wattmeter(mon, lab, status=0)
    pkg.update_wattmeter(mon, lab, status=1)


def m_var_off(pkg, mon):
    pkg.update_varmeter(mon, mon.varmeter.label.label(4), status=0)


def m_volt_value(pkg, mon):
    pkg.update_voltmeter(mon, mon.voltmeter.label.label(3), magnitude=1.01,
                         variance=2e-3)


def m_pmu_value(pkg, mon):
    pkg.update_pmu(mon, mon.pmu.label.label(1), magnitude=1.02, angle=-0.06)


def m_pmu_off(pkg, mon):
    pkg.update_pmu(mon, mon.pmu.label.label(2), status=0)


def m_pmu_off_on(pkg, mon):
    lab = mon.pmu.label.label(2)
    pkg.update_pmu(mon, lab, status=0)
    pkg.update_pmu(mon, lab, status=1)


def m_add_wattmeter(pkg, mon):
    s = mon.system
    pkg.add_wattmeter(mon, bus=s.bus.label.label(6), active=0.0,
                      variance=1e-2, noise=False)


MEAS_EDITS = {
    "watt_value": m_watt_value,
    "watt_variance": m_watt_variance,
    "watt_off": m_watt_off,
    "watt_off_on": m_watt_off_on,
    "var_off": m_var_off,
    "volt_value": m_volt_value,
    "pmu_value": m_pmu_value,
    "pmu_off": m_pmu_off,
    "pmu_off_on": m_pmu_off_on,
    "add_wattmeter": m_add_wattmeter,
}


def _se_pair(path, name, edit, pmu_every=4):
    """(the port's reused estimate, {pkg: fresh estimate}), all solved:
    one measurement set per package, the edit applied to each."""
    fresh = {}
    for pkg in (jgt, jg):
        system, mon = _monitored(pkg, path, pmu_every)
        if pkg is jgt:
            live = _build(pkg, name, mon)
            pkg.state_estimation(live)
        if edit in MEAS_EDITS:
            MEAS_EDITS[edit](pkg, mon)
        else:
            SYSTEM_EDITS[edit](pkg, system)
        fresh[pkg] = _build(pkg, name, mon)
        pkg.state_estimation(fresh[pkg])
    jgt.state_estimation(live)
    return live, fresh


_SE_SYS_EDITS = ["branch_off", "branch_off_on", "slack_move", "add_branch",
                 "add_generator"]


@pytest.mark.parametrize("edit", list(MEAS_EDITS) + _SE_SYS_EDITS)
def test_wls_se_reuse_matches_fresh(data_path, edit):
    live, fresh = _se_pair(str(data_path / "case14test.m"), "gauss_newton",
                           edit)
    for got, want, rtol in ((live, fresh[jgt], 1e-7),
                            (fresh[jgt], fresh[jg], 0)):
        assert got.method.converged and want.method.converged
        _same_voltage(got, want, 1e-9, rtol=rtol)


_DC_SE_EDITS = ["watt_value", "watt_variance", "watt_off", "watt_off_on",
                "add_wattmeter", "branch_off", "slack_move"]


@pytest.mark.parametrize("edit", _DC_SE_EDITS)
def test_dc_se_reuse_matches_fresh(data_path, edit):
    live, fresh = _se_pair(str(data_path / "case14test.m"),
                           "dc_state_estimation", edit)
    _same_voltage(live, fresh[jgt], 1e-10, magnitude=False)
    _same_voltage(fresh[jgt], fresh[jg], 1e-10, magnitude=False, rtol=0)


_PMU_SE_EDITS = ["pmu_value", "pmu_off", "pmu_off_on", "branch_off",
                 "slack_move"]


@pytest.mark.parametrize("edit", _PMU_SE_EDITS)
def test_pmu_se_reuse_matches_fresh(data_path, edit):
    path = str(data_path / "case14test.m")
    if edit == "pmu_off":
        _unobservable_pmu_set(path)
        return
    live, fresh = _se_pair(path, "pmu_state_estimation", edit, pmu_every=1)
    _same_voltage(live, fresh[jgt], 1e-9)
    _same_voltage(fresh[jgt], fresh[jg], 1e-9, rtol=0)


def _unobservable_pmu_set(path):
    """``pmu_off`` with a PMU on every bus: bus 2 loses its only
    measurement. The JAX package's reused and fresh estimates are NaN at
    every bus; the port's reused and fresh analyses both refuse the
    singular gain."""
    for pkg in (jgt, jg):
        system, mon = _monitored(pkg, path, pmu_every=1)
        live = _build(pkg, "pmu_state_estimation", mon)
        pkg.state_estimation(live)
        assert np.isfinite(live.voltage.angle).all()
        MEAS_EDITS["pmu_off"](pkg, mon)
        assert int(mon.pmu.layout.index[2]) == 2 \
            and mon.pmu.magnitude.status[2] == 0
        fresh = _build(pkg, "pmu_state_estimation", mon)
        for analysis in (fresh, live):
            if pkg is jg:
                pkg.state_estimation(analysis)
                assert np.isnan(analysis.voltage.angle).all()
                assert np.isnan(analysis.voltage.magnitude).all()
            else:
                with pytest.raises(RuntimeError, match="lu_factor.*zero"):
                    pkg.state_estimation(analysis)


_LAV_EDITS = ["watt_value", "watt_off", "branch_off"]


@pytest.mark.slow
@pytest.mark.parametrize("edit", _LAV_EDITS)
def test_lav_se_reuse_matches_fresh(data_path, edit):
    live, fresh = _se_pair(str(data_path / "case14test.m"),
                           "ac_lav_state_estimation", edit)
    _same_voltage(live, fresh[jgt], 5e-6)
    _same_voltage(fresh[jgt], fresh[jg], 5e-6, rtol=0)


def test_residual_column_follows_a_reestimate(data_path):
    """Regression: a meter table printed after a live edit and a re-solve
    reports the residuals z - h(x) of the new estimate. The residuals the
    first table computed and stored on the analysis were reported again
    after the re-solve (the JAX package still does: its column below is
    the old state's)."""
    import io

    from juliagrid_tpu_torch.estimation.acse import residuals

    tables = {}
    for pkg in (jgt, jg):
        _, mon = _monitored(pkg, str(data_path / "case14test.m"))
        se = _build(pkg, "gauss_newton", mon)
        pkg.state_estimation(se)
        fmt = {"Residual": "{:.17e}"}
        before = pkg.print_wattmeter_data(mon, analysis=se, fmt=fmt,
                                          file=io.StringIO())
        m_watt_value(pkg, mon)
        pkg.state_estimation(se)
        after = pkg.print_wattmeter_data(mon, analysis=se, fmt=fmt,
                                         file=io.StringIO())
        tables[pkg] = (before, after, se)

    def column(text):
        return [float(line.strip("|").split("|")[-1])
                for line in text.splitlines()[4:-1]]

    before, after, se = tables[jgt]
    r = residuals(se)
    first = {}
    for row, (kind, dev) in enumerate(se.method.row_device):
        if kind == "wattmeter":
            first.setdefault(dev, r[row])
    assert column(after) == [first[i] for i in range(len(first))]
    assert column(after) != column(before)
    jax_before, jax_after, _ = tables[jg]
    assert column(jax_after) == column(jax_before)  # stale there
