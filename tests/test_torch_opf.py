"""The port's interior point and DC optimal power flow against the JAX
package on the CPU.

Tolerances: the problem functions are the same arithmetic in both packages
(1e-12). The JAX package solves its KKT systems in f32 with f64 refinement
and switches to an f64 LDLᵀ at its precision wall; the port factors in f64
LU from the first iteration, so a step agrees to 1e-8 relative and full
solves to solver level: objectives rtol 1e-7, states 1e-6 (the MATPOWER
goldens' own 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.opf import dcopf as jax_dcopf
from juliagrid_tpu.opf import ipm as jax_ipm
from juliagrid_tpu_torch.convert import dcopf_arrays_from_numpy
from juliagrid_tpu_torch.opf import (fix, remove_constraint, set_bound,
                                     solve_opf, unfix, update_cost,
                                     update_demand)
from juliagrid_tpu_torch.opf import dcopf, ipm
from juliagrid_tpu_torch.opf.dcopf import (dc_optimal_power_flow,
                                           dcopf_eq, dcopf_ineq,
                                           dcopf_objective)
from juliagrid_tpu_torch.system import builders
from juliagrid_tpu_torch.system.model import physical_island

from .utils import h5group

FN_TOL = 1e-12


def dc_solve(analysis):
    return dcopf.solve(analysis)


# ---------------------------------------------------------------------------
# the spec: host lists, tags and problem functions against the JAX package
# ---------------------------------------------------------------------------

def _edited(pkg, builders_mod, system):
    """case14test with a piecewise cost (4 points), a fixed generator and
    an angle-difference limit."""
    gen = system.generator.label
    pkg.cost(system, gen.label(1), active=1,
             piecewise=[[0.0, 2.0], [0.3, 10.0], [0.6, 25.0], [1.0, 60.0]])
    builders_mod.update_generator(system, gen.label(3), min_active=0.2,
                                  max_active=0.2)
    builders_mod.update_branch(system, system.branch.label.label(3),
                               min_diff_angle=-0.2, max_diff_angle=0.25)
    return system


def _both_systems(data_path, case):
    from juliagrid_tpu.system import builders as jax_builders
    name = "case14test" if case == "case14test_edited" else case
    js = jg.power_system(str(data_path / f"{name}.m"))
    ts = jgt.power_system(str(data_path / f"{name}.m"))
    if case == "case14test_edited":
        _edited(jg, jax_builders, js)
        _edited(jgt, builders, ts)
    return js, ts


def _seeded_x(spec, k, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0.0, 0.5, spec.n_x) for _ in range(k)]


@pytest.mark.parametrize("case", ["case14test", "case30test", "case118",
                                  "case14test_edited"])
def test_dc_spec_matches_jax(data_path, case):
    js, ts = _both_systems(data_path, case)
    jspec = jax_dcopf._DcSpec(js)
    tspec = dcopf._DcSpec(ts, device="cpu")
    for name in ("cap_lo", "cap_hi", "fix_p", "flows", "angles", "pw_cuts",
                 "pw_gens", "ineq_tags"):
        assert getattr(tspec, name) == getattr(jspec, name), name
    assert (tspec.n, tspec.g, tspec.n_h, tspec.n_x) == \
        (jspec.n, jspec.g, jspec.n_h, jspec.n_x)
    if case == "case14test_edited":
        assert tspec.pw_cuts and tspec.fix_p and tspec.angles
    # the JAX spec's lists through the carry-across function
    carried = dcopf_arrays_from_numpy(jspec, "cpu")
    for x in _seeded_x(tspec, 5):
        xj = jnp.asarray(x)
        xt = torch.tensor(x)
        want = (float(jspec.objective(xj)), np.asarray(jspec.eq(xj)),
                np.asarray(jspec.ineq(xj)))
        for arr in (tspec.arrays, carried):
            got = (float(dcopf_objective(arr, xt)),
                   dcopf_eq(arr, xt).numpy(), dcopf_ineq(arr, xt).numpy())
            assert abs(got[0] - want[0]) <= FN_TOL * max(1.0, abs(want[0]))
            for a, b in zip(got[1:], want[1:]):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, rtol=FN_TOL, atol=FN_TOL)
    # the scattered derivatives are torch.func's, entry for entry
    x = torch.tensor(_seeded_x(tspec, 1, seed=2)[0])
    rng = np.random.default_rng(3)
    y = torch.tensor(rng.normal(size=tspec.eq(x).shape[0]))
    z = torch.tensor(rng.normal(size=len(tspec.ineq_tags)))
    lag = lambda xx: (tspec.objective(xx) - y @ tspec.eq(xx)  # noqa: E731
                      - z @ tspec.ineq(xx))
    for got, want in ((tspec.jac_eq(x), torch.func.jacfwd(tspec.eq)(x)),
                      (tspec.jac_ineq(x), torch.func.jacfwd(tspec.ineq)(x)),
                      (tspec.hess(x, y, z), torch.func.hessian(lag)(x))):
        assert torch.equal(got, want)
    # a batch of points evaluates row by row as the single points do
    xb = torch.tensor(np.stack(_seeded_x(tspec, 3, seed=1)))
    for fn in (dcopf_objective, dcopf_eq, dcopf_ineq):
        rows = torch.stack([fn(tspec.arrays, x) for x in xb])
        torch.testing.assert_close(fn(tspec.arrays, xb), rows, rtol=1e-15,
                                   atol=1e-13)


# ---------------------------------------------------------------------------
# the interior point's device functions on a seeded QP
# ---------------------------------------------------------------------------

def _qp(seed=4, n=7, me=2, mi=5):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, n))
    q = q @ q.T + n * np.eye(n)
    c = rng.normal(size=n)
    a = rng.normal(size=(me, n))
    b = rng.normal(size=me)
    g = rng.normal(size=(mi, n))
    h = rng.normal(size=mi) - 2.0
    return q, c, a, b, g, h


def _qp_fns(lib, q, c, a, b, g, h):
    """The QP plus one curved row (1 - |x|²/10 >= 0) in ``lib`` (jnp or
    torch), as functions of x."""
    if lib is torch:
        q, c, a, b, g, h = (torch.tensor(v) for v in (q, c, a, b, g, h))

        def f(x):
            return 0.5 * (x @ q * x).sum(-1) + (c * x).sum(-1)

        def ce(x):
            return (a @ x[..., None])[..., 0] - b

        def ci(x):
            lin = (g @ x[..., None])[..., 0] - h
            return torch.cat([lin, 1.0 - (x * x).sum(-1, keepdim=True)
                              / 10.0], -1)
        return f, ce, ci

    def f(x, p):
        return 0.5 * x @ q @ x + c @ x

    def ce(x, p):
        return a @ x - b

    def ci(x, p):
        return jnp.concatenate([g @ x - h, jnp.array([1.0]) - x @ x / 10.0])
    return f, ce, ci


def test_ipm_step_kkt_error_and_probe_match_jax():
    data = _qp()
    n, me, mi = 7, 2, 6
    jf = jax_ipm._make_fns(*_qp_fns(jnp, *data), n, me, mi)
    j_step, j_kkt, j_multi, j_probe = jf[0], jf[2], jf[5][6], jf[5][8]
    tf = ipm._make_fns(*_qp_fns(torch, *data), n, me, mi)
    rng = np.random.default_rng(9)
    x = rng.normal(size=n) * 0.3
    y = rng.normal(size=me)
    z = rng.uniform(0.1, 2.0, mi)
    s = rng.uniform(0.1, 2.0, mi)
    mu = 0.05
    ce = np.asarray(_qp_fns(jnp, *data)[1](jnp.asarray(x), ()))
    ri = np.asarray(_qp_fns(jnp, *data)[2](jnp.asarray(x), ())) - s
    J = [jnp.asarray(v) for v in (x, y, z, s)]
    T = [torch.tensor(v) for v in (x, y, z, s)]
    for delta in (0.0, 1e-4):
        want = j_step(*J, mu, delta, jnp.asarray(ce), jnp.asarray(ri), ())
        got = tf.step(*T, mu, delta, torch.tensor(ce), torch.tensor(ri))
        for a, b in zip(got, want):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-8,
                                       atol=1e-8 * max(1.0, np.abs(b).max()))
    mus = [0.0, 0.1, 1e-3]
    want = np.asarray(j_multi(*J, jnp.asarray(mus), ()))
    got = tf.kkt_error_multi(*T, torch.tensor(mus)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert abs(float(tf.kkt_error(*T, mu)) - float(j_kkt(*J, mu, ()))) \
        <= 1e-12 * float(j_kkt(*J, mu, ()))
    dx, _, ds, _, _ = got_step = tf.step(*T, mu, 0.0, torch.tensor(ce),
                                         torch.tensor(ri))
    alphas = 0.5 ** np.arange(1, 8)
    th_w, ph_w = j_probe(J[0], J[3], mu, jnp.asarray(dx.numpy()),
                         jnp.asarray(ds.numpy()), jnp.asarray(alphas), ())
    th_g, ph_g = tf.ls_probe(T[0], T[3], mu, dx, ds, torch.tensor(alphas))
    np.testing.assert_allclose(th_g.numpy(), np.asarray(th_w), rtol=1e-12)
    np.testing.assert_allclose(ph_g.numpy(), np.asarray(ph_w), rtol=1e-12)
    del got_step


def test_singular_kkt_escalates_instead_of_raising():
    """A singular Newton system factors without raising: its step comes
    back non-finite, which the loop answers by raising delta."""
    def f(x):
        return (x * 0.0).sum(-1)  # zero Hessian, zero gradient

    tf = ipm._make_fns(f, None, None, 3, 0, 0)
    x = torch.zeros(3, dtype=torch.float64)
    e = x.new_zeros(0)
    *_, stats = tf.step(x, e, e, e, 0.1, 0.0, e, e)
    assert stats[6].item() == 0.0      # not finite
    *_, stats = tf.step(x, e, e, e, 0.1, 1e-8, e, e)
    assert stats[6].item() == 1.0


def test_chunked_jacobian_matches_jacfwd():
    rng = np.random.default_rng(2)
    m = torch.tensor(rng.normal(size=(5, 600)))

    def fn(x):
        return torch.sin(m @ x) + x[:5] ** 2

    x = torch.tensor(rng.normal(size=600))
    torch.testing.assert_close(ipm._chunked_jacfwd(fn, 600, block=256)(x),
                               torch.func.jacfwd(fn)(x), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# full solves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["case14test", "case30test"])
def test_dc_opf_matpower(data_path, case):
    system = jgt.power_system(str(data_path / f"{case}.m"))
    golden = h5group(data_path / "results.h5", f"{case}/dcOptimalPowerFlow")
    analysis = dc_optimal_power_flow(system, device="cpu")
    dc_solve(analysis)
    assert analysis.method.converged
    np.testing.assert_allclose(analysis.voltage.angle, golden["voltage"],
                               atol=1e-6)
    np.testing.assert_allclose(analysis.power.generator.active,
                               golden["generator"], atol=1e-6)


def test_dc_opf_case14_matches_jax(data_path):
    path = str(data_path / "case14test.m")
    ref = jax_dcopf.dc_optimal_power_flow(jg.power_system(path))
    jax_dcopf.solve(ref)
    got = dc_optimal_power_flow(jgt.power_system(path), device="cpu")
    dc_solve(got)
    print(f"case14test DC OPF iterations: JAX {ref.method.iteration}, "
          f"port {got.method.iteration}")
    assert got.method.converged and ref.method.converged
    assert got.method.result.status == ref.method.result.status == "optimal"
    np.testing.assert_allclose(got.method.objective, ref.method.objective,
                               rtol=1e-7)
    np.testing.assert_allclose(got.voltage.angle, ref.voltage.angle,
                               atol=1e-6)
    np.testing.assert_allclose(got.power.generator.active,
                               ref.power.generator.active, atol=1e-6)
    assert got.method.dual["ineq_tags"] == ref.method.dual["ineq_tags"]
    np.testing.assert_allclose(got.method.dual["balance"],
                               ref.method.dual["balance"], rtol=1e-5,
                               atol=1e-5)


def linear_costs(system, rng_seed=11):
    """Every generator's cost replaced by a distinct linear curve, as
    tests/test_opf_anchor.py does, so the DC OPF is an LP."""
    rng = np.random.default_rng(rng_seed)
    g = system.generator.number
    c1 = 20.0 + 30.0 * rng.random(g)
    for i in range(g):
        jgt.cost(system, system.generator.label.label(i), active=2,
                 polynomial=[float(c1[i]), 5.0])
    return c1


def test_dc_opf_118_vs_independent_lp(data_path):
    """The case118 anchor of tests/test_opf_anchor.py on the port: the LP
    assembled from raw system data and solved by scipy's HiGHS."""
    from .test_opf_anchor import _independent_dc_lp

    system = jgt.power_system(str(data_path / "case118.m"))
    c1 = linear_costs(system)
    lp = _independent_dc_lp(system, c1)
    opf = dc_optimal_power_flow(system, device="cpu")
    dc_solve(opf)
    assert opf.method.converged
    on = system.generator.layout.status.array[:system.generator.number] == 1
    np.testing.assert_allclose(opf.method.objective,
                               lp.fun + 5.0 * on.sum(), rtol=1e-7)
    pg_lp = np.zeros(system.generator.number)
    pg_lp[np.flatnonzero(on)] = lp.x[system.bus.number:]
    np.testing.assert_allclose(opf.power.generator.active, pg_lp, atol=2e-6)


def test_power_flow_and_solve_opf(data_path):
    system = jgt.power_system(str(data_path / "case14test.m"))
    a = dc_optimal_power_flow(system, device="cpu")
    jgt.power_flow(a, power=True)
    b = dc_optimal_power_flow(system, device="cpu")
    solve_opf(b)
    assert a.method.converged and b.method.converged
    np.testing.assert_allclose(a.power.generator.active,
                               b.power.generator.active, rtol=0, atol=0)
    # the post-processed flows balance the dispatch at every bus
    p = a.power
    demand = system.bus.demand.active.array[:system.bus.number]
    np.testing.assert_allclose(p.supply.active - demand, p.injection.active,
                               atol=1e-8)
    with pytest.raises(TypeError, match="AC or DC optimal power flow"):
        solve_opf(jgt.newton_raphson(system, device="cpu"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_request_without_card_raises(data_path):
    system = jgt.power_system(str(data_path / "case14test.m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dc_optimal_power_flow(system)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ipm.solve_nlp(ipm.NlpProblem(lambda x: (x * x).sum(-1)),
                      np.ones(2), device="cuda")


# ---------------------------------------------------------------------------
# live edits (tests/test_opf_edit_dc.py on the port)
# ---------------------------------------------------------------------------

def _solved(data_path, case="case14optimal.m"):
    system = jgt.power_system(str(data_path / case))
    analysis = dc_optimal_power_flow(system, device="cpu")
    dc_solve(analysis)
    assert analysis.method.converged
    return system, analysis


def _obj_close(a, b, rel=1e-6):
    assert abs(a - b) <= rel * max(1.0, abs(a), abs(b)), (a, b)


def _fresh(system):
    fresh = dc_optimal_power_flow(system, device="cpu")
    dc_solve(fresh)
    assert fresh.method.converged
    return fresh


def test_set_bound_matches_fresh(data_path):
    system, analysis = _solved(data_path)
    spec = analysis._spec
    g = int(np.argmax(analysis.power.generator.active))
    new_max = float(analysis.power.generator.active[g]) - 0.05
    set_bound(analysis, variable="active",
              label=system.generator.label.label(g), max=new_max)
    assert analysis._spec is spec                      # no rebuild
    dc_solve(analysis)
    assert analysis.method.converged
    fresh = _fresh(system)
    _obj_close(analysis.method.objective, fresh.method.objective)
    np.testing.assert_allclose(analysis.power.generator.active,
                               fresh.power.generator.active, atol=1e-5)
    assert analysis.power.generator.active[g] <= new_max + 1e-7


def test_set_bound_rejects_non_active(data_path):
    system, analysis = _solved(data_path)
    with pytest.raises(ValueError, match="active"):
        set_bound(analysis, variable="magnitude",
                  label=system.bus.label.label(1), max=1.1)


def test_fix_unfix_roundtrip(data_path):
    system, analysis = _solved(data_path)
    spec = analysis._spec
    g0 = system.generator.label.label(0)
    cap = system.generator.capability
    before = (float(cap.min_active[0]), float(cap.max_active[0]))
    pinned = float(analysis.power.generator.active[0]) * 0.9

    fix(analysis, variable="active", label=g0, value=pinned)
    assert analysis._spec is spec
    assert any(i == 0 for i, _ in spec.fix_p)
    assert int(spec.arrays.fix_idx.numel()) == len(spec.fix_p)
    dc_solve(analysis)
    assert analysis.method.converged
    np.testing.assert_allclose(analysis.power.generator.active[0], pinned,
                               atol=1e-7)

    unfix(analysis, variable="active", label=g0)
    after = (float(cap.min_active[0]), float(cap.max_active[0]))
    assert before == after                 # capability data restored
    dc_solve(analysis)
    fresh = _fresh(system)
    _obj_close(analysis.method.objective, fresh.method.objective)


def test_unfix_without_fix_raises(data_path):
    system, analysis = _solved(data_path)
    with pytest.raises(ValueError, match="no recorded fix"):
        unfix(analysis, variable="active",
              label=system.generator.label.label(0))


def test_remove_flow_constraint_live(data_path):
    system, analysis = _solved(data_path, case="case30test.m")
    spec = analysis._spec
    flow_ks = {f[6] for f in spec.flows}
    assert flow_ks, "case30test should carry flow limits"
    k = sorted(flow_ks)[0]
    label = system.branch.label.label(k)
    n_flows = len(spec.flows)
    n_rows = int(spec.arrays.a.numel())
    remove_constraint(analysis, constraint="flow", label=label)
    assert analysis._spec is spec
    assert len(spec.flows) < n_flows
    assert int(spec.arrays.a.numel()) < n_rows     # the tensors followed
    dc_solve(analysis)
    assert analysis.method.converged
    fresh = _fresh(system)                 # restores the constraint
    assert analysis.method.objective <= fresh.method.objective + 1e-6
    assert any(f[6] == k for f in fresh._spec.flows)


def test_remove_balance_raises(data_path):
    system, analysis = _solved(data_path)
    with pytest.raises(ValueError, match="balance"):
        remove_constraint(analysis, constraint="balance",
                          label=system.bus.label.label(0))


def test_update_demand_matches_fresh(data_path):
    system, analysis = _solved(data_path)
    spec = analysis._spec
    label = system.bus.label.label(2)
    update_demand(analysis, label,
                  active=1.1 * float(system.bus.demand.active[2]))
    assert analysis._spec is spec
    dc_solve(analysis)
    assert analysis.method.converged
    fresh = _fresh(system)
    _obj_close(analysis.method.objective, fresh.method.objective)
    np.testing.assert_allclose(analysis.voltage.angle, fresh.voltage.angle,
                               atol=1e-6)


def test_update_cost_polynomial_live(data_path):
    system, analysis = _solved(data_path)
    spec = analysis._spec
    g0 = system.generator.label.label(0)
    update_cost(analysis, g0, active=2, polynomial=[0.05, 30.0, 50.0])
    assert analysis._spec is spec
    assert spec.obj_quad[0] == 0.05 and spec.obj_lin[0] == 30.0
    assert float(spec.arrays.quad[0]) == 0.05
    dc_solve(analysis)
    assert analysis.method.converged
    fresh = _fresh(system)
    _obj_close(analysis.method.objective, fresh.method.objective)


def test_duals_carried_across_edit(data_path):
    system, analysis = _solved(data_path)
    update_demand(analysis, system.bus.label.label(2),
                  active=1.02 * float(system.bus.demand.active[2]))
    assert analysis._carry_duals
    dc_solve(analysis)
    warm_iters = analysis.method.iteration
    assert analysis.method.converged
    fresh = _fresh(system)
    assert warm_iters <= fresh.method.iteration


def test_dual_tags_aligned(data_path):
    system, analysis = _solved(data_path, case="case30test.m")
    spec = analysis._spec
    tags = spec.ineq_tags
    n_lo = len(spec.cap_lo)
    n_hi = len(spec.cap_hi)
    assert all(t == "capability_min" for t, _ in tags[:n_lo])
    assert all(t == "capability_max" for t, _ in tags[n_lo:n_lo + n_hi])
    assert [i for _, i in tags[:n_lo]] == [i for i, _ in spec.cap_lo]
    z = analysis.method.dual["ineq"]
    assert len(z) == len(tags)


def test_ac_analysis_edit_names_item_12c(data_path):
    """Item 12c (the AC OPF) is ported: a live edit takes an AC OPF
    analysis, and refuses an analysis that is no OPF."""
    system = jgt.power_system(str(data_path / "case14test.m"))
    with pytest.raises(ValueError, match="AC or DC optimal power flow"):
        update_demand(jgt.newton_raphson(system, device="cpu"),
                      system.bus.label.label(1), active=0.1)
    ac = jgt.ac_optimal_power_flow(system, device="cpu")
    update_demand(ac, system.bus.label.label(1), active=0.1)
    assert ac._carry_duals
    assert float(ac._spec.arrays.pd[1]) == system.bus.demand.active[1]


# ---------------------------------------------------------------------------
# reuse after system edits (test_reusing_matrix.py's DC OPF sweep)
# ---------------------------------------------------------------------------

def _blab(s, i):
    return s.bus.label.label(i)


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


def _nonslack_gen(s):
    slack = s.bus.layout.slack
    for k in range(s.generator.number):
        if int(s.generator.layout.bus[k]) != slack \
                and s.generator.layout.status[k] == 1:
            return k
    raise AssertionError("no non-slack generator")


def _add_generator_cost(s):
    k = builders.add_generator(s, bus=_blab(s, 4), active=0.1,
                               max_active=0.7, min_active=0.0,
                               max_reactive=0.3, min_reactive=-0.3, status=1)
    jgt.cost(s, s.generator.label.label(k), active=2,
             polynomial=[100.0, 30.0, 0.02])


OPF_EDITS = {
    "demand": lambda s: builders.update_bus(s, _blab(s, 3), active=0.28,
                                            reactive=0.09),
    "branch_param": lambda s: builders.update_branch(
        s, s.branch.label.label(2), reactance=0.3, resistance=0.02),
    "branch_off": lambda s: builders.update_branch(
        s, s.branch.label.label(_removable_branch(s)), status=0),
    "add_branch": lambda s: builders.add_branch(
        s, from_bus=_blab(s, 2), to_bus=_blab(s, 7), reactance=0.35,
        resistance=0.01),
    "add_generator": _add_generator_cost,
    "gen_limits": lambda s: builders.update_generator(
        s, s.generator.label.label(1), max_active=0.6, min_active=0.05),
    "cost_poly": lambda s: jgt.cost(s, s.generator.label.label(1), active=2,
                                    polynomial=[820.0, 22.0, 0.008]),
    "cost_piecewise": lambda s: jgt.cost(
        s, s.generator.label.label(1), active=1,
        piecewise=[[0.0, 2.0], [0.4, 14.0], [0.9, 40.0]]),
    "gen_off": lambda s: builders.update_generator(
        s, s.generator.label.label(_nonslack_gen(s)), status=0),
}


@pytest.mark.parametrize("edit", list(OPF_EDITS))
def test_dc_opf_reuse_matches_fresh(data_path, edit):
    system = jgt.power_system(str(data_path / "case14test.m"))
    analysis = dc_optimal_power_flow(system, device="cpu")
    dc_solve(analysis)
    assert analysis.method.converged

    OPF_EDITS[edit](system)

    fresh = dc_optimal_power_flow(system, device="cpu")
    dc_solve(analysis)
    dc_solve(fresh)
    assert analysis.method.converged and fresh.method.converged
    np.testing.assert_allclose(analysis.method.objective,
                               fresh.method.objective,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(analysis.voltage.angle, fresh.voltage.angle,
                               atol=1e-5)
