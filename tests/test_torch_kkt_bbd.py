"""The port's structured (BBD) KKT of the AC OPF (``opf/kkt_bbd.py``) on
the CPU, against the JAX package's ``AcKktBbd`` and the port's own dense
KKT (tests/test_opf_kkt.py on the port).

Tolerances, each with its reason:
- layout: equal (the host build is the JAX package's, and ``nd_partition``
  partitions bit for bit as it does);
- values and blocks against the JAX package: 1e-12 of the row's scale
  (``|a - b| <= 1e-12 max(1, max |row of b|)``): the same arithmetic, the
  flow rows' autodiff and the sums in another order;
- the summed COO matrix against the dense KKT: 1e-9 of its largest entry
  (test_kkt_matrix_element_exact's: the dense JᵢᵀΣJᵢ is a matrix product);
- a step against a dense solve: 1e-6 of the solution's scale, lin_res
  below 1e-8 (test_kkt_solve_matches_dense's);
- row maxima: rtol 1e-9 (test_kkt_row_maxes_match_dense's);
- end to end against the dense path: objective 1e-6 relative, V 1e-5
  (the two solves stop at KKT errors under 1e-8 along the same path)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliagrid_tpu_torch as jgt
from juliagrid_tpu.opf import acopf as jax_acopf
from juliagrid_tpu.opf.kkt_bbd import AcKktBbd as JaxKktBbd
from juliagrid_tpu.opf.kkt_bbd import spec_pattern as jax_spec_pattern
from juliagrid_tpu.ops.partition import nd_partition as jax_nd_partition
from juliagrid_tpu_torch.kernels import kkt_fill as k7
from juliagrid_tpu_torch.kernels import opf_fill as k6
from juliagrid_tpu_torch.opf import acopf, ipm, kkt_bbd
from juliagrid_tpu_torch.opf.edit import update_cost
from juliagrid_tpu_torch.opf.kkt_bbd import AcKktBbd
from juliagrid_tpu_torch.system.builders import cost as cost_builder
from juliagrid_tpu_torch.utils.synthetic import synthetic_grid

from .test_torch_opf_fill import _systems

ROW_TOL = 1e-12


def _port_spec(data_path, case):
    system = jgt.power_system(str(data_path / f"{case}.m"))
    return acopf._AcSpec(system, device="cpu"), system


def _iterate(spec, x0, seed, flat=False):
    """A random interior point near ``x0`` (or the flat start): x, y, z,
    s, Σ = z / s, and random objective and row scales."""
    rng = np.random.default_rng(seed)
    x = np.array(x0, dtype=np.float64)
    if flat:
        x[:spec.n], x[spec.n:2 * spec.n] = 0.0, 1.0
    else:
        x += 0.01 * rng.standard_normal(spec.n_x)
    y = rng.standard_normal(spec.m_e)
    z = rng.uniform(0.1, 2.0, spec.m_i)
    s = rng.uniform(0.1, 2.0, spec.m_i)
    scales = (float(rng.uniform(0.2, 1.0)), rng.uniform(0.3, 1.0, spec.m_e),
              rng.uniform(0.3, 1.0, spec.m_i))
    return x, y, z, s, z / s, scales


def _close_rows(got, want, tol=ROW_TOL):
    """|got - want| within ``tol`` of each row's scale (a vector: of each
    entry's, against max(1, |want|))."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max(axis=-1, keepdims=True) if want.ndim > 1 \
        else np.abs(want)
    bad = np.abs(got - want) > tol * np.maximum(1.0, scale)
    assert not bad.any(), (np.argwhere(bad)[:5], got[bad][:5], want[bad][:5])


@pytest.mark.parametrize("case,blocks", [("case14test", 3),
                                         ("case30test", 3), ("case118", 4)])
def test_layout_matches_jax(data_path, case, blocks):
    import juliagrid_tpu as jg
    jan = jax_acopf.ac_optimal_power_flow(
        jg.power_system(str(data_path / f"{case}.m")))
    jan._refresh_spec()
    jk = JaxKktBbd(jan._spec, blocks)
    tk = AcKktBbd(_port_spec(data_path, case)[0], blocks)
    assert (tk.k, tk.ni, tk.mb, tk.mbl, tk.n_entries, tk.n_w) == \
        (jk.k, jk.ni, jk.mb, jk.mbl, jk.n_entries, jk._n_w)
    block_of, border = jax_nd_partition(
        jax_spec_pattern(jan._spec, jan._spec.n), blocks)
    np.testing.assert_array_equal(tk.block_of, block_of)
    np.testing.assert_array_equal(tk.border, border)
    np.testing.assert_array_equal(tk.owner, jk.owner)
    np.testing.assert_array_equal(tk.rows, np.asarray(jk._rows))
    np.testing.assert_array_equal(tk.cols, np.asarray(jk._cols))
    np.testing.assert_array_equal(tk.bsel, np.asarray(jk._bsel))
    np.testing.assert_array_equal(tk.bmask, np.asarray(jk._bmask))
    np.testing.assert_array_equal(tk.interior_idx_np,
                                  np.asarray(jk._interior_idx))
    np.testing.assert_array_equal(tk.border_idx_np,
                                  np.asarray(jk._border_idx))
    np.testing.assert_array_equal(tk.cross, np.asarray(jk._cross))
    for mine, theirs in ((tk.ii, jk._ii), (tk.ib, jk._ib), (tk.bi, jk._bi),
                         (tk.bb, jk._bb)):
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, np.asarray(b))


#: (case, flow class on every branch or 0, the flat start): the flat start
#: of case30test's √ classes puts its shunt-free lines at S² = I² = 0
VALUE_CASES = [("case14edited", 0, False), ("case30test", 2, True),
               ("case30test", 4, True), ("case118", 0, False)]


@pytest.mark.parametrize("case,cls,flat", VALUE_CASES,
                         ids=lambda v: str(v))
def test_values_and_blocks_match_jax(data_path, case, cls, flat):
    """kkt_fill_ref's COO values, equilibration and padded blocks against
    the JAX package's ``_values``/``_assemble`` at one iterate, scales
    included."""
    js, ts = _systems(data_path, case, cls)
    jspec = jax_acopf._AcSpec(js)
    tspec = acopf._AcSpec(ts, device="cpu")
    if flat:
        assert (tspec.arrays.fl_cls == cls).all()
    jk, tk = JaxKktBbd(jspec, 3), AcKktBbd(tspec, 3)
    x, y, z, _, sigma, (sf, ge, gi) = _iterate(tspec, tspec.start(ts), 1,
                                               flat)
    delta = 1e-4
    pk = {"p": jspec.params, "sf": jnp.asarray(sf), "ge": jnp.asarray(ge),
          "gi": jnp.asarray(gi)}
    vals, _, d, arr, _ = jax.jit(jk._assemble)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jnp.asarray(sigma),
        delta, pk, jnp.zeros(tspec.n_x), jnp.zeros(tspec.m_e))
    t = torch.tensor
    fill = k7.kkt_fill(tk.table, tspec.arrays, t(x), t(y), t(z), t(sigma),
                       delta, sf, t(ge), t(gi))
    # a value against the scale of its KKT row (the largest value there)
    rmax = np.zeros(tk.n_aug)
    np.maximum.at(rmax, tk.rows, np.abs(np.asarray(vals)))
    bad = np.abs(fill.vals.numpy() - np.asarray(vals)) > \
        ROW_TOL * np.maximum(1.0, rmax[tk.rows])
    assert not bad.any(), np.flatnonzero(bad)[:5]
    _close_rows(fill.d, d)
    for name in ("a_ii", "a_ib", "a_bi", "a_bb"):
        _close_rows(getattr(fill, name), getattr(arr, name))


def _dense_kkt(spec, x, y, z, sigma, delta):
    """The augmented matrix as the port's dense step builds it, from K6's
    plain version (raw duals, unit scales)."""
    t = torch.tensor
    arr = spec.arrays
    jac = k6.opf_fill(arr, t(x))
    h = k6.opf_fill(arr, t(x), t(y), t(z)).hess.numpy()
    ji, je = jac.jac_ineq.numpy(), jac.jac_eq.numpy()
    n_x, m_e = spec.n_x, spec.m_e
    kkt = np.zeros((n_x + m_e, n_x + m_e))
    kkt[:n_x, :n_x] = h + ji.T @ (sigma[:, None] * ji) + delta * np.eye(n_x)
    kkt[:n_x, n_x:] = je.T
    kkt[n_x:, :n_x] = je
    kkt[n_x:, n_x:] = -1e-10 * np.eye(m_e)
    return kkt


UNIT = {"sf": 1.0, "ge": None, "gi": None}


@pytest.mark.parametrize("case", ["case14test", "case30test", "case118"])
def test_coo_matrix_equals_dense_kkt(data_path, case):
    spec, system = _port_spec(data_path, case)
    kkt = AcKktBbd(spec, 3)
    x, y, z, _, sigma, _ = _iterate(spec, spec.start(system), 0)
    delta = 1e-3
    t = torch.tensor
    vals = k7.kkt_values_ref(kkt.table, spec.arrays, t(x), t(y), t(z),
                             t(sigma), delta, 1.0).numpy()
    coo = np.zeros((kkt.n_aug, kkt.n_aug))
    np.add.at(coo, (kkt.rows, kkt.cols), vals)
    dense = _dense_kkt(spec, x, y, z, sigma, delta)
    assert np.abs(coo - dense).max() < 1e-9 * max(1.0, np.abs(dense).max())


@pytest.mark.parametrize("case", ["case30test", "case118"])
def test_step_matches_dense(data_path, case):
    spec, system = _port_spec(data_path, case)
    kkt = AcKktBbd(spec, 4)
    x, y, z, _, sigma, _ = _iterate(spec, spec.start(system), 1)
    delta = 1e-4
    rng = np.random.default_rng(2)
    rhs_x = rng.standard_normal(spec.n_x)
    rhs_e = rng.standard_normal(spec.m_e)
    t = torch.tensor
    dx, v, lin_res, curv = kkt.solve(t(x), t(y), t(z), t(sigma), delta,
                                     t(rhs_x), t(rhs_e), UNIT)
    dense = _dense_kkt(spec, x, y, z, sigma, delta)
    sol = np.linalg.solve(dense, np.concatenate([rhs_x, rhs_e]))
    scale = max(1.0, np.abs(sol).max())
    assert np.abs(dx.numpy() - sol[:spec.n_x]).max() < 1e-6 * scale
    assert np.abs(v.numpy() - sol[spec.n_x:]).max() < 1e-6 * scale
    assert float(lin_res) < 1e-8
    w = dense[:spec.n_x, :spec.n_x]
    curv_ref = sol[:spec.n_x] @ (w @ sol[:spec.n_x])
    assert abs(float(curv) - curv_ref) < 1e-6 * max(1.0, abs(curv_ref))


def test_pivoted_lu_serves_the_endgame(data_path):
    """The JAX package's f64 LDLᵀ endgame (``solve_f64``: unpivoted, one
    refinement sweep) is not ported. On test_kkt_solve_f64_endgame's system
    (Σ spread over twelve decades, δ = 1e-8, condition ~4e16) the port's
    pivoted f64 LU gives the dense solution as closely as that path does
    (both 1.7e-10 of its scale on this host, in the equality multipliers;
    within 10x of it and 1e-9 here), and a residual well inside the
    interior point's 1e-6 gate (1.9e-8, under 1e-7 here; the refined
    LDLᵀ's 1.1e-10). The JAX package's f32 solve, which the LDLᵀ stands in
    for, fails there (residual 75)."""
    import juliagrid_tpu as jg
    spec, system = _port_spec(data_path, "case118")
    rng = np.random.default_rng(6)
    x, y, _, _, _, _ = _iterate(spec, spec.start(system), 5)
    z = 10.0 ** rng.uniform(-6, 6, spec.m_i)
    s = 10.0 ** rng.uniform(-6, 6, spec.m_i)
    sigma, delta = z / s, 1e-8
    rhs_x = rng.standard_normal(spec.n_x)
    rhs_e = rng.standard_normal(spec.m_e)
    t = torch.tensor
    dx, v, lin_res, _ = AcKktBbd(spec, 4).solve(
        t(x), t(y), t(z), t(sigma), delta, t(rhs_x), t(rhs_e), UNIT)
    jan = jax_acopf.ac_optimal_power_flow(
        jg.power_system(str(data_path / "case118.m")))
    jan._refresh_spec()
    jspec = jan._spec
    pk = {"p": jspec.params, "sf": jnp.asarray(1.0),
          "ge": jnp.ones(spec.m_e), "gi": jnp.ones(spec.m_i)}
    dx_jax, v_jax, _, _ = jax.jit(JaxKktBbd(jspec, 4).solve_f64)(
        *(jnp.asarray(a) for a in (x, y, z, sigma)), delta,
        jnp.asarray(rhs_x), jnp.asarray(rhs_e), pk)
    dense = _dense_kkt(spec, x, y, z, sigma, delta)
    sol = np.linalg.solve(dense, np.concatenate([rhs_x, rhs_e]))
    scale = max(1.0, np.abs(sol).max())
    err = np.abs(np.concatenate([dx.numpy(), v.numpy()]) - sol).max()
    err_jax = np.abs(np.concatenate([np.asarray(dx_jax), np.asarray(v_jax)])
                     - sol).max()
    assert err <= max(10.0 * err_jax, 1e-12 * scale)
    assert err <= 1e-9 * scale
    assert float(lin_res) < 1e-7


@pytest.mark.parametrize("case", ["case14test", "case118"])
def test_row_maxes_match_dense(data_path, case):
    spec, system = _port_spec(data_path, case)
    x = _iterate(spec, spec.start(system), 3)[0]
    rme, rmi = AcKktBbd(spec, 3).row_maxes(torch.tensor(x))
    jac = k6.opf_fill(spec.arrays, torch.tensor(x))
    je = jac.jac_eq.abs().amax(dim=1).numpy()
    ji = jac.jac_ineq.abs().amax(dim=1).numpy()
    # both floor at 1.0: the scale min(1, 100/max) is the same for any
    # max in [1, 100]
    np.testing.assert_allclose(rme.numpy(), np.maximum(je, 1.0), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(rmi.numpy(), np.maximum(ji, 1.0), rtol=1e-9,
                               atol=1e-12)


def _solved(system, blocks, **kw):
    analysis = jgt.ac_optimal_power_flow(system, device="cpu")
    acopf.solve(analysis, kkt_blocks=blocks, **kw)
    return analysis


def _agree(bbd, dense, obj_rtol=1e-6, v_tol=1e-5):
    assert bbd.method.result.status in ("optimal", "acceptable")
    assert abs(bbd.method.objective - dense.method.objective) <= \
        obj_rtol * max(1.0, abs(dense.method.objective))
    assert np.abs(bbd.voltage.magnitude
                  - dense.voltage.magnitude).max() <= v_tol


@pytest.mark.parametrize("case,blocks", [("case14optimal", 3),
                                         ("case118", 4)])
def test_ac_opf_bbd_end_to_end(data_path, case, blocks):
    """The same optimum through the BBD KKT as through the dense KKT."""
    dense = _solved(jgt.power_system(str(data_path / f"{case}.m")), 0)
    assert dense.method.converged
    bbd = _solved(jgt.power_system(str(data_path / f"{case}.m")), blocks)
    _agree(bbd, dense)
    assert isinstance(bbd._kkt_cache[2], AcKktBbd)


def test_synthetic_opf_bbd_path():
    """The shape of the 10,000-bus cell, small: the synthetic lattice with
    costs and voltage bounds through the BBD KKT equals the dense optimum,
    and a live cost edit re-solves on the cached structure, equal to a
    fresh solve of the edited system."""
    dense = _solved(synthetic_grid(6, 6, opf=True), 0)
    assert dense.method.converged
    bbd = _solved(synthetic_grid(6, 6, opf=True), 4)
    _agree(bbd, dense)
    before = bbd._kkt_cache[2]
    update_cost(bbd, 1, active=2, polynomial=[0.05, 25.0, 0.0])
    acopf.solve(bbd, kkt_blocks=4)
    assert bbd._kkt_cache[2] is before
    edited = synthetic_grid(6, 6, opf=True)
    cost_builder(edited, 1, active=2, polynomial=[0.05, 25.0, 0.0])
    _agree(bbd, _solved(edited, 0))


def test_auto_rule_sends_large_grids_to_bbd(data_path, monkeypatch):
    """kkt_blocks unset: the JAX package's rule, max(8, n // 512) blocks
    from _KKT_BBD_AUTO buses (lowered here to reach it on case14)."""
    monkeypatch.setattr(acopf, "_KKT_BBD_AUTO", 10)
    analysis = _solved(
        jgt.power_system(str(data_path / "case14optimal.m")), None,
        max_iter=3)
    assert analysis._kkt_cache[2].k == 8
    assert analysis.method.iteration == 3


def test_singular_interior_block_escalates_delta(data_path, monkeypatch):
    """A singular interior block gives a non-finite step, not a
    LinAlgError: the structured solve, and inside the interior point the
    first step (δ = 0), after which δ escalates and the solve ends at the
    optimum of an undisturbed run. The BBD power flow keeps raising
    (tests/test_torch_bbd.py)."""
    spec, system = _port_spec(data_path, "case14optimal")
    kkt = AcKktBbd(spec, 3)
    real_fill = kkt_bbd.kkt_fill
    calls = []

    def singular_first(*args):
        fill = real_fill(*args)
        delta = args[6]
        calls.append(delta)
        if len(calls) == 1:
            fill.a_ii[0].zero_()
        return fill

    monkeypatch.setattr(kkt_bbd, "kkt_fill", singular_first)
    x, y, z, _, sigma, _ = _iterate(spec, spec.start(system), 4)
    t = torch.tensor
    dx, _, _, _ = kkt.solve(t(x), t(y), t(z), t(sigma), 0.0,
                            t(np.ones(spec.n_x)), t(np.ones(spec.m_e)), UNIT)
    assert not torch.isfinite(dx).all()

    calls.clear()
    stats = []
    real_solve = AcKktBbd.solve

    def solve_logged(self, *args):
        out = real_solve(self, *args)
        stats.append((args[4], bool(torch.isfinite(out[0]).all())))
        return out

    monkeypatch.setattr(AcKktBbd, "solve", solve_logged)
    got = _solved(jgt.power_system(str(data_path / "case14optimal.m")), 3)
    assert stats[0] == (0.0, False)
    assert stats[1][0] > 0.0 and stats[1][1]
    monkeypatch.undo()
    want = _solved(jgt.power_system(str(data_path / "case14optimal.m")), 3)
    _agree(got, want)


def test_structured_step_forms_no_dense_matrix(data_path):
    """The interior point's functions with a structured KKT solve: the
    step, the KKT error and its split call no analytic Jacobian or Hessian
    (every Jᵀ product a vjp), and the step's dx equals the dense step's
    within 1e-8 of its scale (the same system, factored in blocks)."""
    spec, system = _port_spec(data_path, "case30test")
    kkt = AcKktBbd(spec, 4)
    x, y, z, s, _, _ = _iterate(spec, spec.start(system), 7)
    x, y, z, s = (torch.tensor(a) for a in (x, y, z, s))
    mu, delta = 0.1, 1e-6
    ce, ri = spec.eq(x), spec.ineq(x) - s

    def forbidden(*_):
        raise AssertionError("a dense derivative was formed")

    args = (spec.objective, spec.eq, spec.ineq, spec.n_x, spec.m_e,
            spec.m_i)
    bbd = ipm._make_fns(*args, jac_e_fn=forbidden, jac_i_fn=forbidden,
                        hess_fn=forbidden,
                        kkt_solve=lambda *a: kkt.solve(*a, UNIT))
    dense = ipm._make_fns(*args, jac_e_fn=spec.jac_eq,
                          jac_i_fn=spec.jac_ineq, hess_fn=spec.hess)
    mus = torch.tensor([0.0, mu], dtype=torch.float64)
    torch.testing.assert_close(bbd.kkt_error_multi(x, y, z, s, mus),
                               dense.kkt_error_multi(x, y, z, s, mus),
                               rtol=1e-12, atol=0.0)
    bbd.kkt_components(x, y, z, s, mu)
    got = bbd.step(x, y, z, s, mu, delta, ce, ri)
    want = dense.step(x, y, z, s, mu, delta, ce, ri)
    scale = max(1.0, float(want[0].abs().max()))
    assert float((got[0] - want[0]).abs().max()) <= 1e-8 * scale
    assert float(got[4][2]) < 1e-8 and float(got[4][6]) == 1.0
