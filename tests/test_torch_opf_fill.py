"""K6 ``opf_fill`` on the CPU: its plain version against the JAX package's
``jac_eq``/``jac_ineq``/``hess`` and against ``torch.func`` of the port's
own problem functions, and its host tables and mapping, walked in numpy as
``csrc/opf_fill.cu`` walks them, against the plain version.

Tolerances: the plain version repeats the JAX package's arithmetic, and the
walk the kernel's closed forms, so both agree to rounding: 1e-12 relative
(``|a - b| <= 1e-12 max(1, |b|)``). Against ``torch.func`` the tolerances
are those of tests/test_opf_jacobians.py (1e-12, 1e-10, 1e-9 absolute:
forward-mode sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.opf import acopf as jax_acopf
from juliagrid_tpu.system import builders as jax_builders
from juliagrid_tpu_torch.convert import acopf_arrays_from_numpy
from juliagrid_tpu_torch.kernels import opf_fill as k6
from juliagrid_tpu_torch.opf import acopf
from juliagrid_tpu_torch.system import builders

REL_TOL = 1e-12

#: (case, flow class to set on every branch, or 0 to keep the case's)
CASES = [("case14optimal", 0), ("case14edited", 0)] + [
    ("case30test", cls) for cls in (1, 2, 3, 4, 5)]


def _edit(pkg, bld, system):
    """case14optimal (one generator out of service) with a four-point
    active and a three-point reactive piecewise cost (epigraph helpers), a
    fixed generator, a capability curve and an angle-difference limit."""
    gen = system.generator.label
    pkg.cost(system, gen.label(1), active=1,
             piecewise=[[0.0, 2.0], [0.3, 10.0], [0.6, 25.0], [1.0, 60.0]])
    pkg.cost(system, gen.label(2), reactive=1,
             piecewise=[[-0.2, 1.0], [0.0, 0.0], [0.3, 3.0]])
    bld.update_generator(system, gen.label(4), min_active=0.2,
                         max_active=0.2)
    bld.update_generator(system, gen.label(0), low_active=0.5,
                         up_active=2.0, min_low_reactive=-0.4,
                         max_low_reactive=0.4, min_up_reactive=-0.1,
                         max_up_reactive=0.1)
    bld.update_branch(system, system.branch.label.label(3),
                      min_diff_angle=-0.2, max_diff_angle=0.25)


def _systems(data_path, case, cls):
    name = "case14optimal" if case == "case14edited" else case
    js = jg.power_system(str(data_path / f"{name}.m"))
    ts = jgt.power_system(str(data_path / f"{name}.m"))
    if case == "case14edited":
        _edit(jg, jax_builders, js)
        _edit(jgt, builders, ts)
    if cls:
        for pkg_bld, s in ((jax_builders, js), (builders, ts)):
            for k in range(s.branch.number):
                pkg_bld.update_branch(s, s.branch.label.label(k), type=cls)
    return js, ts


def _points(spec, x0, seed=0):
    """Two random points around ``x0`` and the flat start (θ = 0, V = 1),
    each with random duals."""
    rng = np.random.default_rng(seed)
    n = spec.n
    out = []
    for k in range(3):
        x = np.array(x0, dtype=np.float64)
        if k < 2:
            x[:n] += 0.1 * rng.standard_normal(n)
            x[n:2 * n] *= 1.0 + 0.05 * rng.standard_normal(n)
            x[2 * n:] += 0.1 * rng.standard_normal(x.size - 2 * n)
        else:
            x[:n], x[n:2 * n] = 0.0, 1.0
        out.append((x, rng.standard_normal(spec.m_e),
                    rng.standard_normal(spec.m_i)))
    return out


def _close(got, want, tol=REL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    bad = np.abs(got - want) > tol * np.maximum(1.0, np.abs(want))
    assert not bad.any(), (np.argwhere(bad)[:5], got[bad][:5], want[bad][:5])


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def specs(request, data_path):
    case, cls = request.param
    js, ts = _systems(data_path, case, cls)
    jspec = jax_acopf._AcSpec(js)
    tspec = acopf._AcSpec(ts, device="cpu")
    return case, cls, jspec, tspec, tspec.start(ts)


def test_spec_lists_match_jax(specs):
    case, _, jspec, tspec, _ = specs
    for name in ("v_lo", "v_hi", "fix_v", "p_lo", "p_hi", "q_lo", "q_hi",
                 "fix_p", "fix_q", "curve_cuts", "curve_tags", "flows",
                 "angles", "pw_cuts_p", "pw_cuts_q", "pw_gens_p",
                 "pw_gens_q", "ineq_tags"):
        assert getattr(tspec, name) == getattr(jspec, name), name
    assert (tspec.n_x, tspec.m_e, tspec.m_i) == \
        (jspec.n_x, jspec.m_e, jspec.m_i)
    if case == "case14edited":
        assert tspec.pw_cuts_p and tspec.pw_cuts_q and tspec.fix_p \
            and tspec.angles and tspec.curve_cuts


def test_arrays_from_jax_spec_equal_the_ports(specs):
    """``convert.acopf_arrays_from_numpy`` of the JAX package's spec gives
    the port's tensors and K6's tables, field for field."""
    _, _, jspec, tspec, _ = specs
    carried = acopf_arrays_from_numpy(jspec, "cpu")
    for name, a in tspec.arrays._asdict().items():
        b = getattr(carried, name)
        if name == "poly":
            assert len(a) == len(b)
            for (ca, qa), (cb, qb) in zip(a, b):
                assert torch.equal(ca, cb) and torch.equal(qa, qb)
        elif name == "fill":
            for fa, fb in zip(a, b):
                assert (torch.equal(fa, fb) if torch.is_tensor(fa)
                        else fa == fb)
        elif torch.is_tensor(a):
            assert torch.equal(a, b), name
        else:
            assert a == b, name


def test_problem_functions_match_jax(specs):
    _, _, jspec, tspec, x0 = specs
    p = jspec.params
    pts = _points(tspec, x0, seed=4)
    for x, _, _ in pts:
        xj, xt = jnp.asarray(x), torch.tensor(x)
        _close(float(acopf.acopf_objective(tspec.arrays, xt)),
               float(jspec.objective(xj, p)))
        _close(acopf.acopf_eq(tspec.arrays, xt), jspec.eq(xj, p))
        _close(acopf.acopf_ineq(tspec.arrays, xt), jspec.ineq(xj, p))
    # a batch of points evaluates row by row as the single points do
    xb = torch.tensor(np.stack([x for x, _, _ in pts]))
    for fn in (acopf.acopf_objective, acopf.acopf_eq, acopf.acopf_ineq):
        rows = torch.stack([fn(tspec.arrays, x) for x in xb])
        torch.testing.assert_close(fn(tspec.arrays, xb), rows, rtol=1e-15,
                                   atol=1e-13)


def _zero_root_rows(tspec, x):
    """√-class flow rows whose S² or I² is 0 exactly at ``x``."""
    arr = tspec.arrays
    sq = arr._replace(fl_cls=torch.where(arr.fl_cls == 2, 3, torch.where(
        arr.fl_cls == 4, 5, arr.fl_cls)))
    n = tspec.n
    xt = torch.tensor(x)
    val = acopf.flow_values(sq, xt[:n], xt[n:2 * n])
    return int(((val == 0.0) & ((arr.fl_cls == 2) | (arr.fl_cls == 4))).sum())


def test_opf_fill_ref_matches_jax(specs):
    """The plain version against the JAX package's jac_eq, jac_ineq and
    hess at random points and at the flat start, where the √ rows of the
    case's shunt-free lines sit at S² = I² = 0 (their derivatives clamp to
    0)."""
    _, cls, jspec, tspec, x0 = specs
    p = jspec.params
    pts = _points(tspec, x0)
    if cls in (2, 4):
        assert _zero_root_rows(tspec, pts[-1][0]) > 0
    for x, y, z in pts:
        xj, xt = jnp.asarray(x), torch.tensor(x)
        fill = k6.opf_fill(tspec.arrays, xt)
        _close(fill.jac_eq, jspec.jac_eq(xj, p))
        _close(fill.jac_ineq, jspec.jac_ineq(xj, p))
        hess = k6.opf_fill(tspec.arrays, xt, torch.tensor(y),
                           torch.tensor(z)).hess
        _close(hess, jspec.hess(xj, jnp.asarray(y), jnp.asarray(z), p))


def test_opf_fill_ref_matches_torch_func(specs):
    """The plain version is the derivative of the port's own eq, ineq and
    Lagrangian (test_opf_jacobians.py's check, on the port)."""
    _, _, _, tspec, x0 = specs
    x, y, z = (torch.tensor(a) for a in _points(tspec, x0, seed=9)[0])
    arr = tspec.arrays
    fill = k6.opf_fill(arr, x)
    torch.testing.assert_close(
        fill.jac_eq, torch.func.jacfwd(lambda v: acopf.acopf_eq(arr, v))(x),
        rtol=0, atol=1e-12)
    torch.testing.assert_close(
        fill.jac_ineq,
        torch.func.jacfwd(lambda v: acopf.acopf_ineq(arr, v))(x),
        rtol=0, atol=1e-10)

    def lag(v):
        return (acopf.acopf_objective(arr, v) - y @ acopf.acopf_eq(arr, v)
                - z @ acopf.acopf_ineq(arr, v))

    hess = k6.opf_fill(arr, x, y, z).hess
    torch.testing.assert_close(hess, torch.func.hessian(lag)(x), rtol=0,
                               atol=1e-9)
    # symmetric to rounding (torch.func's two halves of a flow block)
    torch.testing.assert_close(hess, hess.T, rtol=1e-14, atol=1e-12)


# ---- the kernel's mapping, walked in numpy ---------------------------------

def _flow_derivs(tab, x, n, f):
    """flow_derivs of csrc/opf_fill.cu: gradient and Hessian of flow row f
    over (θf, θt, Vf, Vt) by the chain rule over the rectangular
    voltages."""
    fb, tb, cls, is_from = (int(tab["fl_idx"][k][f]) for k in range(4))
    gf, bf, gt, bt = tab["fl_y"][:, f]
    sf, cf = np.sin(x[fb]), np.cos(x[fb])
    st, ct = np.sin(x[tb]), np.cos(x[tb])
    u = np.array([x[n + fb] * cf, x[n + fb] * sf, x[n + tb] * ct,
                  x[n + tb] * st])
    a, b = np.array([gf, -bf, gt, -bt]), np.array([bf, gf, bt, gt])
    ire, iim = a @ u, b @ u
    r = 0 if is_from else 2
    er, ei = np.eye(4)[r], np.eye(4)[r + 1]
    vr, vi = u[r], u[r + 1]
    pp, qq = vr * ire + vi * iim, vi * ire - vr * iim
    dp = vr * a + vi * b + ire * er + iim * ei
    dq = vi * a - vr * b + ire * ei - iim * er
    hpp = np.outer(er, a) + np.outer(a, er) + np.outer(ei, b) + \
        np.outer(b, ei)
    hqq = np.outer(ei, a) + np.outer(a, ei) - np.outer(er, b) - \
        np.outer(b, er)
    if cls == 1:
        gu, hu = dp, hpp
    else:
        if cls in (2, 3):
            m = pp * pp + qq * qq
            gu = 2 * pp * dp + 2 * qq * dq
            hu = 2 * (np.outer(dp, dp) + pp * hpp + np.outer(dq, dq)
                      + qq * hqq)
        else:
            m = ire * ire + iim * iim
            gu = 2 * ire * a + 2 * iim * b
            hu = 2 * (np.outer(a, a) + np.outer(b, b))
        if cls in (2, 4):
            w = 1.0 if m > 1e-24 else 0.5 if m == 1e-24 else 0.0
            mm = max(m, 1e-24)
            root = np.sqrt(mm)
            hu = hu * (w / (2 * root)) - np.outer(gu, gu) * (
                w * w / (4 * mm * root))
            gu = gu * (w / (2 * root))
    jac = np.array([[-u[1], 0, cf, 0], [u[0], 0, sf, 0],
                    [0, -u[3], 0, ct], [0, u[2], 0, st]])
    h = jac.T @ hu @ jac
    h[0, 0] -= gu[0] * u[0] + gu[1] * u[1]
    h[1, 1] -= gu[2] * u[2] + gu[3] * u[3]
    h[[0, 2], [2, 0]] += -gu[0] * sf + gu[1] * cf
    h[[1, 3], [3, 1]] += -gu[2] * st + gu[3] * ct
    return gu @ jac, h


def _entry_terms(gy, by, vi, vj, th, yp, yq):
    gc = gy * np.cos(th) + by * np.sin(th)
    gs = gy * np.sin(th) - by * np.cos(th)
    t1, t2 = vi * vj * gc, vi * vj * gs
    return {"tt": -(yp * t1 + yq * t2),
            "tivi": -yp * vj * gs + yq * vj * gc,
            "tivj": -yp * vi * gs + yq * vi * gc,
            "tjvi": yp * vj * gs - yq * vj * gc,
            "tjvj": yp * vi * gs - yq * vi * gc, "vv": yp * gc + yq * gs}


def _walk(tab, spec, x):
    """[J_E; J_I] as csrc/opf_fill.cu's Jacobian mode fills it from the
    tables, each element written at most once (asserted)."""
    n, g, n_x = spec.n, spec.g, spec.n_x
    yg, yb = spec.yg, spec.yb
    out = np.zeros((spec.m_e + spec.m_i, n_x))
    seen = np.zeros(out.shape, dtype=bool)

    def put(r, c, v):
        assert not seen[r, c], ("two writers", r, c)
        seen[r, c] = True
        out[r, c] = v

    for k in range(n):
        vk, tk = x[n + k], x[k]
        p = q = 0.0
        for e in range(tab["row_ptr"][k], tab["row_ptr"][k + 1]):
            j = tab["ycol"][e]
            th = tk - x[j]
            gc = yg[e] * np.cos(th) + yb[e] * np.sin(th)
            gs = yg[e] * np.sin(th) - yb[e] * np.cos(th)
            t1, t2 = vk * x[n + j] * gc, vk * x[n + j] * gs
            p, q = p + t1, q + t2
            if j != k:
                put(k, j, -t2)
                put(k, n + j, -vk * gc)
                put(n + k, j, t1)
                put(n + k, n + j, -vk * gs)
        for s in range(tab["gen_ptr"][k], tab["gen_ptr"][k + 1]):
            gi = tab["gen_idx"][s]
            put(k, 2 * n + gi, tab["gen_on"][gi])
            put(n + k, 2 * n + g + gi, tab["gen_on"][gi])
        d = tab["diag"][k]
        gii, bii = (yg[d], yb[d]) if d >= 0 else (0.0, 0.0)
        put(k, k, q + bii * vk * vk)
        put(k, n + k, -(p / vk + gii * vk))
        put(n + k, k, -(p - gii * vk * vk))
        put(n + k, n + k, -(q / vk - bii * vk))
    for row in range(2 * n, out.shape[0]):
        d = row - 2 * n
        c1, c2 = tab["row_col"][:, d]
        v1, v2 = tab["row_val"][:, d]
        if tab["row_kind"][d] == k6.LINEAR:
            if c2 == c1:
                put(row, c1, v1 + v2)
            else:
                put(row, c1, v1)
                if c2 >= 0:
                    put(row, c2, v2)
            continue
        fb, tb = tab["fl_idx"][0][c1], tab["fl_idx"][1][c1]
        gz, _ = _flow_derivs(tab, x, n, c1)
        for col, val in ((fb, v1 * gz[0]), (tb, v1 * gz[1]),
                         (n + fb, v1 * gz[2]), (n + tb, v1 * gz[3])):
            if seen[row, col]:
                out[row, col] += val
            else:
                put(row, col, val)
    return out


def _slot_values(tab, spec, x, y, whz, k, s):
    """What pass 2 of the Hessian mode sums for slot s of bus k: its four
    off-diagonal elements and its part of the bus's four diagonal ones."""
    n, yg, yb = spec.n, spec.yg, spec.yb
    vk, tk = x[n + k], x[k]
    j, ekj, ejk = tab["pair"][:, s]
    diag = np.zeros(4)              # tt, tv, vt, vv
    off = np.zeros(4)
    if j != k:
        if ekj >= 0:
            c = _entry_terms(yg[ekj], yb[ekj], vk, x[n + j], tk - x[j], y[k],
                             y[n + k])
            diag += [c["tt"], c["tivi"], c["tivi"], 0.0]
            off += [-c["tt"], c["tivj"], c["tjvi"], c["vv"]]
        if ejk >= 0:
            c = _entry_terms(yg[ejk], yb[ejk], x[n + j], vk, x[j] - tk, y[j],
                             y[n + j])
            diag += [c["tt"], c["tjvj"], c["tjvj"], 0.0]
            off += [-c["tt"], c["tjvi"], c["tivj"], c["vv"]]
    elif ekj >= 0:
        diag[3] += y[k] * 2.0 * yg[ekj] - y[n + k] * 2.0 * yb[ekj]
    for q in range(tab["pair_fptr"][s], tab["pair_fptr"][s + 1]):
        f = tab["pair_flow"][q]
        ends = (tab["fl_idx"][0][f], tab["fl_idx"][1][f])
        for a in range(2):
            if ends[a] != k:
                continue
            for c in range(4):
                acc = diag if ends[c & 1] == k else off
                col = 0 if c < 2 else 1
                acc[col] += whz[q][a, c]
                acc[2 + col] += whz[q][2 + a, c]
    return off, diag


def _hess_walk(tab, spec, x, y, z):
    """H as csrc/opf_fill.cu's Hessian mode fills it: a weighted 4x4 block
    per flow entry of the pair lists, a thread's sums per pair slot, each
    bus's diagonal added slot after slot, the tail rows' cost terms; then
    every element stored once, window by window of the plan (asserted)."""
    n, n_x = spec.n, spec.n_x
    pair_ptr = tab["pair_ptr"]
    whz = []
    for f in tab["pair_flow"]:
        lo, hi = tab["fl_idx"][4][f], tab["fl_idx"][5][f]
        w = 0.0
        if lo >= 0:
            w = w + -z[lo]
        if hi >= 0:
            w = w + z[hi]
        whz.append(w * _flow_derivs(tab, x, n, f)[1])
    values = {}                     # absolute element of H -> value
    for k in range(n):
        dsum = []
        for s in range(pair_ptr[k], pair_ptr[k + 1]):
            off, part = _slot_values(tab, spec, x, y, whz, k, s)
            dsum.append(part)
            j = tab["pair"][0, s]
            if j != k:
                for c in range(4):
                    row = k if c < 2 else n + k
                    values[row * n_x + (n + j if c & 1 else j)] = off[c]
        for c in range(4):
            d = 0.0
            for part in dsum:       # slot order, one addition at a time
                d = d + part[c]
            row = k if c < 2 else n + k
            values[row * n_x + (n + k if c & 1 else k)] = d
    for row in range(2 * n, n_x):
        d = row - 2 * n
        total, any_term = 0.0, False
        for s in range(tab["term_ptr"][d], tab["term_ptr"][d + 1]):
            deg, o = tab["term"][:, s]
            acc = 0.0
            for jj in range(deg - 1):
                kk = deg - jj
                acc = acc * x[row] + tab["term_co"][o + jj] * kk * (kk - 1)
            total, any_term = total + acc, True
        if any_term:
            values[row * n_x + row] = total
    at = tab["item_at"]
    tails = [r * n_x + r for r in range(2 * n, n_x) if r * n_x + r in values]
    assert sorted(values) == sorted(at[at >= 0].tolist() + tails)
    bus_units, row_units, _, _ = tab["hess_plan"]
    blocks = {unit: b for b, unit in enumerate(
        k6.hess_blocks(tab["hess_plan"], n, n_x))}

    def block_of(row):
        if row < 2 * n:
            return blocks["bus", (row % n) // bus_units]
        return blocks["tail", (row - 2 * n) // row_units]

    at = np.array(sorted(values), dtype=np.int64)
    out = np.zeros(n_x * n_x)
    seen = np.zeros(n_x * n_x, dtype=bool)
    for blk, a, b, base in k6.hess_windows(tab["hess_plan"], n, n_x):
        assert block_of(a // n_x) == blk == block_of((b - 1) // n_x)
        stage = np.zeros(b - base)
        for i in at[(at >= a) & (at < b)]:
            stage[i - base] = values[i]
        assert not seen[a:b].any(), ("two windows store", a, b)
        seen[a:b] = True
        out[a:b] = stage[a - base:]
    assert seen.all()
    return out.reshape(n_x, n_x)


def test_kernel_walk_matches_ref(specs):
    """The tables, walked as the kernel walks them (one writer per element,
    closed-form flow derivatives; the Hessian by flow entry, pair slot and
    the diagonal slot after slot, stored window by window), give the plain
    version's matrices, with the case's plan and with one of three-bus
    blocks, two-row tail blocks and six-double windows, which cut every
    row."""
    _, _, _, tspec, x0 = specs
    tab = k6.opf_fill_table(tspec)
    grp, unit_group = k6.hess_groups(tab["pair_ptr"], tab["pair_fptr"],
                                     tspec.n, 3, blocks=4)
    small = dict(tab, hess_plan=np.array([3, 2, 6, grp.shape[1]]),
                 hess_group=grp, unit_group=unit_group)
    k6.check_fill_table(small, tspec.rows, tspec.cols)
    for x, y, z in _points(tspec, x0, seed=2):
        xt = torch.tensor(x)
        ref = k6.opf_fill_ref(tspec.arrays, xt)
        jac = _walk(tab, tspec, x)
        _close(jac[:tspec.m_e], ref.jac_eq)
        _close(jac[tspec.m_e:], ref.jac_ineq)
        hess = k6.opf_fill_ref(tspec.arrays, xt, torch.tensor(y),
                               torch.tensor(z)).hess
        for t in (tab, small):
            _close(_hess_walk(t, tspec, x, y, z), hess)


@pytest.mark.parametrize("n, n_x", [(14, 54), (14, 55), (1354, 3228),
                                    (9000, 24001)],
                         ids=["even", "odd", "pegase", "wide-odd"])
def test_hess_plan_covers_every_element_once(n, n_x):
    """The Hessian mode's windows store every element of every row of H
    exactly once, each from an even element and at most HESS_WINDOW
    doubles (the bitmap's reach), and no window crosses from one block's
    rows into another's."""
    units = k6.hess_units(n, n_x)
    plan = k6.HessPlan(*units, k6.HESS_WINDOW, min(n, k6.HESS_VALUE_BLOCKS))
    k6.check_hess_plan(plan, n, n_x)
    if n_x == 3228:        # pegase: a bus a block, two tail rows a block
        assert units == (1, 2)
    wins = np.array([w for w in k6.hess_windows(plan, n, n_x)])
    blk, first, last, base = wins.T
    assert np.all(base % 2 == 0) and np.all(last - base <= plan.window)
    kinds = k6.hess_blocks(plan, n, n_x)
    units = -(-n // plan.bus_units)
    groups = plan.groups
    tails = -(-(n_x - 2 * n) // plan.row_units)
    assert sorted(kinds) == sorted(
        [("bus", i) for i in range(units)]
        + [("value", i) for i in range(groups)]
        + [("tail", i) for i in range(tails)])
    # the value groups and tail units first, so that they start in the
    # first wave, then the bus units
    assert kinds[-units:] == [("bus", i) for i in range(units)]
    number = {unit: b for b, unit in enumerate(kinds)}
    rows = np.stack([first // n_x, (last - 1) // n_x])
    owner = [[number["bus", (r % n) // plan.bus_units] if r < 2 * n
              else number["tail", (r - 2 * n) // plan.row_units]
              for r in rr] for rr in rows]
    assert np.all(np.asarray(owner) == blk)
    if n_x * n_x <= 10 ** 7:
        count = np.zeros(n_x * n_x, dtype=np.int8)
        for a, b in zip(first, last):
            count[a:b] += 1
        assert np.all(count == 1)
    else:
        order = np.argsort(first)
        assert first[order][0] == 0 and last[order][-1] == n_x * n_x
        assert np.all(first[order][1:] == last[order][:-1])


def test_check_fill_table_refuses_a_broken_plan(data_path, monkeypatch):
    spec = acopf._AcSpec(jgt.power_system(str(data_path / "case30test.m")),
                         device="cpu")
    good = k6.opf_fill_table(spec)
    groups = good["hess_plan"][3]
    for plan in ([1, 1, 7, groups], [1, 1, 2 * k6.HESS_WINDOW, groups],
                 [0, 1, 64, groups], [1, 0, 64, groups],
                 [1, k6.HESS_TAIL_ROOM + 1, 64, groups], [1, 1, 64, 0]):
        with pytest.raises(ValueError, match="Hessian plan"):
            k6.check_fill_table(dict(good, hess_plan=np.array(plan)),
                                spec.rows, spec.cols)
    windows = k6.hess_windows

    def lose_one(plan, n, n_x):
        wins = list(windows(plan, n, n_x))
        return wins[:1] + wins[2:]

    def overlap(plan, n, n_x):
        wins = list(windows(plan, n, n_x))
        blk, a, b, base = wins[1]
        return wins[:1] + [(blk, a - 2, b, base - 2)] + wins[2:]

    for broken in (lose_one, overlap):
        monkeypatch.setattr(k6, "hess_windows", broken)
        with pytest.raises(ValueError, match="exactly once"):
            k6.check_fill_table(good, spec.rows, spec.cols)


def test_check_fill_table_refuses_two_writers(data_path):
    spec = acopf._AcSpec(jgt.power_system(str(data_path / "case30test.m")),
                         device="cpu")
    rows, cols = spec.rows, spec.cols
    good = k6.opf_fill_table(spec)
    k6.check_fill_table(good, rows, cols)

    def broken(edit):
        tab = {k: v.copy() for k, v in good.items()}
        edit(tab)
        return tab

    def dup_col(tab):
        tab["ycol"][1] = tab["ycol"][0]

    def dup_pair(tab):
        tab["pair"][0, 1] = tab["pair"][0, 0]

    def lost_entry(tab):
        tab["pair"][1, np.flatnonzero(tab["pair"][1] >= 0)[0]] = -1

    def lost_flow(tab):
        tab["pair_flow"][0] = tab["pair_flow"][1]

    def far_column(tab):
        tab["row_col"][0, 0] = spec.n_x

    def other_descriptor(tab):
        tab["pf_y"][0, 0] += 1.0

    def short_group(tab):
        tab["hess_group"][1, -1] -= 1

    for edit, match in ((dup_col, "column twice"), (dup_pair, "bus twice"),
                        (lost_entry, "claimed once"),
                        (lost_flow, "once at each end"),
                        (far_column, "outside the state"),
                        (other_descriptor, "descriptor"),
                        (short_group, "value groups")):
        with pytest.raises(ValueError, match=match):
            k6.check_fill_table(broken(edit), rows, cols)
    with pytest.raises(ValueError, match="entry list"):
        k6.check_fill_table(good, rows, np.r_[cols[:1], cols[:-1]])


def test_opf_fill_checks_inputs_and_never_launches_on_the_cpu(data_path):
    spec = acopf._AcSpec(jgt.power_system(str(data_path / "case14optimal.m")),
                         device="cpu")
    arr = spec.arrays
    x = torch.zeros(spec.n_x, dtype=torch.float64)
    before = k6.opf_fill.launches
    fill = k6.opf_fill(arr, x + 1.0)
    assert fill.hess is None and fill.jac_eq.shape == (spec.m_e, spec.n_x)
    assert k6.opf_fill.launches == before
    with pytest.raises(ValueError, match="shape"):
        k6.opf_fill(arr, x[:-1])
    with pytest.raises(TypeError, match="float64"):
        k6.opf_fill(arr, x + 1.0, torch.zeros(spec.m_e, dtype=torch.float32),
                    torch.zeros(spec.m_i, dtype=torch.float32))
    with pytest.raises(ValueError, match="both y and z"):
        k6.opf_fill(arr, x + 1.0, torch.zeros(spec.m_e, dtype=torch.float64))
