"""K2 ``fleet_solve`` on the CPU: its plain versions against the JAX
package's solves, its planner, its wrappers' refusals, the call sites'
bits, and a numpy walk of the kernel's block-cyclic layout.

Tolerances: the JAX package's NR step is an f32 LU refined three times in
f64 (``ops/linalg.py:147-162``), good to about 1e-12 of max|x| at these
condition numbers (up to ~3e3), so 1e-9 of max|x|; its SE increment forms
and factors the gain in f32 and refines (test_torch_se.py: ~1e-12), so
1e-9; an f64 LU against JAX's f64 ``lu_factor`` (LAPACK on both sides)
1e-12 of the factors' scale, pivots equal. The walk repeats the kernel's
operations in another grouping, so it is held to 1e-10 of the scale (the
factors) and 1e-9 of max|x|, and its pivots must be getrf's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.ops.linalg import lu_factor32, lu_solve_refined
from juliagrid_tpu_torch.estimation import acse as torch_acse
from juliagrid_tpu_torch.kernels import fleet_solve as k2
from juliagrid_tpu_torch.kernels.nr_fill import nr_fill_ref
from juliagrid_tpu_torch.kernels.se_fill import se_fill_ref
from juliagrid_tpu_torch.powerflow.ac import _nr_update

CASES = ("case14test", "case30test", "case118")
JAX_TOL = 1e-9
FACTOR_TOL = 1e-12
WALK_TOL = 1e-10


def _nr_inputs(data_path, case, batch, seed=0):
    """NR Jacobians and mismatches ``[B, 2n, 2n]``, ``[B, 2n]`` of
    ``case`` at states perturbed from its stored start (numpy, seeded)."""
    analysis = jgt.newton_raphson(jgt.power_system(
        str(data_path / f"{case}.m")), device="cpu")
    arr = analysis.arrays
    vm0, va0 = (x.numpy() for x in analysis._state())
    rng = np.random.default_rng(seed)
    vm = torch.tensor(vm0 * (1 + 0.02 * rng.standard_normal((batch,
                                                             len(vm0)))))
    va = torch.tensor(va0 + 0.02 * rng.standard_normal((batch, len(va0))))
    res = nr_fill_ref(arr, vm, va, arr.p_sched.expand(batch, -1),
                      arr.q_sched.expand(batch, -1), jacobian=True)
    return arr, vm, va, res


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("case", CASES)
def test_plain_lu_solve_matches_jax_refined_step(data_path, case, batch):
    _, _, _, res = _nr_inputs(data_path, case, batch)
    a = res.jac.contiguous()
    b = torch.cat([res.mp, res.mq], -1)
    x, info = k2.fleet_lu_solve(a, b)
    assert info.dtype == torch.int32 and not info.any()
    step = jax.vmap(lambda m, v: lu_solve_refined(*lu_factor32(m), m, v))
    want = np.asarray(step(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(x.numpy() - want) / scale).max() <= JAX_TOL


@pytest.mark.parametrize("case", CASES)
def test_plain_lu_factors_match_jax_lu_factor(data_path, case):
    _, _, _, res = _nr_inputs(data_path, case, 2, seed=1)
    a = res.jac.contiguous()
    lu = torch.empty_like(a)
    piv = torch.empty(a.shape[:2], dtype=torch.int32)
    k2.fleet_lu_solve(a, torch.ones(a.shape[:2], dtype=torch.float64),
                      lu=lu, piv=piv)
    for k in range(a.shape[0]):
        jlu, jpiv = jax.scipy.linalg.lu_factor(jnp.asarray(a[k].numpy()))
        np.testing.assert_array_equal(piv[k].numpy() - 1, np.asarray(jpiv))
        jlu = np.asarray(jlu)
        assert np.abs(lu[k].numpy() - jlu).max() <= \
            FACTOR_TOL * np.abs(jlu).max()


def _se_pair(data_path, case, pmu_every):
    """The same SCADA + polar PMU set (every ``pmu_every``-th bus) compiled
    by the JAX package and carried to the port, and a state perturbed from
    the power flow's (numpy, seeded)."""
    from juliagrid_tpu.estimation.acse import compile_se_arrays
    from juliagrid_tpu_torch.convert import (ac_arrays_from_numpy,
                                             se_arrays_from_numpy)

    system = jg.power_system(str(data_path / f"{case}.m"))
    pf = jg.newton_raphson(system)
    jg.power_flow(pf, power=True)
    mon = jg.measurement(system)
    for add in (jg.add_voltmeter, jg.add_wattmeter, jg.add_varmeter):
        add(mon, analysis=pf, noise=False)
    for b in range(0, system.bus.number, pmu_every):
        jg.add_pmu(mon, bus=system.bus.label.label(b),
                   magnitude=float(pf.voltage.magnitude[b]),
                   angle=float(pf.voltage.angle[b]), polar=True, noise=False)
    jarr, _, _, host = compile_se_arrays(system, mon, return_host=True)
    jnet = jg.powerflow.ac.compile_ac_arrays(system)
    tarr = se_arrays_from_numpy(host, "cpu")
    tnet = ac_arrays_from_numpy(
        **{f: np.asarray(getattr(jnet, f)) for f in jnet._fields},
        device="cpu")
    rng = np.random.default_rng(7)
    n = system.bus.number
    vm = np.asarray(pf.voltage.magnitude) * (1 + 0.01 *
                                             rng.standard_normal(n))
    va = np.asarray(pf.voltage.angle) + 0.01 * rng.standard_normal(n)
    return jarr, jnet, tarr, tnet, vm, va


@pytest.mark.parametrize("case,pmu_every", [("case14test", 3),
                                            ("case118", 10)])
def test_plain_cholesky_solve_matches_jax_gn_increment(data_path, case,
                                                       pmu_every):
    from juliagrid_tpu.estimation.acse import gn_increment

    jarr, jnet, tarr, tnet, vm, va = _se_pair(data_path, case, pmu_every)
    want = np.asarray(gn_increment(jarr, jnet, jnp.asarray(vm),
                                   jnp.asarray(va), "LU")[0])
    res = se_fill_ref(tarr, tnet, torch.tensor(vm)[None],
                      torch.tensor(va)[None], tarr.mean[None],
                      jacobian=True)
    gain, rhs = torch_acse._normal_equations(tarr, res)
    x, info = k2.fleet_cholesky_solve(gain.contiguous(), rhs)
    assert not info.any()
    dx = (x * torch_acse._col_mask(tarr, len(vm), x))[0].numpy()
    assert np.abs(want).max() > 1e-4
    np.testing.assert_allclose(dx, want, rtol=0, atol=JAX_TOL)


@pytest.mark.parametrize("n,plan", [
    (28, (1, 16, 29, 29, 10520)),
    (60, (1, 16, 61, 61, 34072)),
    (236, (4, 16, 237, 64, 158800)),
    (256, (4, 16, 257, 65, 173976)),
])
def test_fleet_plan(n, plan):
    """The fewest blocks whose columns, a panel's copy and the vector fit
    an H100 block's 227 KB: case14, case30 in one block, case118 and the
    cap in four."""
    assert tuple(k2.fleet_plan(n)) == plan
    assert k2.shared_bytes(n, plan[0]) == plan[4]
    assert sum(k2.block_columns(n, plan[0], r)
               for r in range(plan[0])) == n + 1


def test_fleet_plan_refuses_above_the_cap_and_unfit_rooms():
    with pytest.raises(ValueError, match="orders 1 to 256, not 257"):
        k2.fleet_plan(257)
    with pytest.raises(ValueError, match="cannot hold an order-236"):
        k2.fleet_plan(236, room=90_000)
    with pytest.raises(ValueError, match="not 3"):
        k2.fleet_plan(28, cluster=3)
    assert k2.fleet_plan(236, cluster=8).shared_bytes == 98_128


def _good():
    return (torch.eye(4, dtype=torch.float64).expand(2, 4, 4).contiguous(),
            torch.ones(2, 4, dtype=torch.float64))


@pytest.mark.parametrize("bad,error,match", [
    (lambda a, b: (a.float(), b), TypeError, "matrices must be float64"),
    (lambda a, b: (a, b.float()), TypeError,
     "right-hand sides must be float64"),
    (lambda a, b: (a.mT, b), ValueError, "matrices must be contiguous"),
    (lambda a, b: (a, b[:, :3]), ValueError, "must be \\[2, 4\\]"),
    (lambda a, b: (a[0], b[0]), ValueError, "must be \\[B, N, N\\]"),
    (lambda a, b: (a.to("meta"), b.to("meta")), ValueError,
     "runs on cuda or cpu tensors, not meta"),
    (lambda a, b: (torch.eye(257, dtype=torch.float64)[None].contiguous(),
                   torch.ones(1, 257, dtype=torch.float64)), ValueError,
     "above K2's cap of 256"),
])
@pytest.mark.parametrize("wrapper", [k2.fleet_lu_solve,
                                     k2.fleet_cholesky_solve])
def test_wrappers_refuse(wrapper, bad, error, match):
    with pytest.raises(error, match=match):
        wrapper(*bad(*_good()))


def test_lu_wrapper_refuses_bad_factor_buffers():
    a, b = _good()
    with pytest.raises(ValueError, match="lu must be torch.float64"):
        k2.fleet_lu_solve(a, b, lu=torch.empty(2, 4, 4))
    with pytest.raises(ValueError, match="piv must be torch.int32"):
        k2.fleet_lu_solve(a, b, piv=torch.empty(2, 4, dtype=torch.int64))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    a, b = _good()
    before = (k2.fleet_lu_solve.launches, k2.fleet_cholesky_solve.launches)
    for fn, ref in ((k2.fleet_lu_solve, k2.fleet_lu_solve_ref),
                    (k2.fleet_cholesky_solve, k2.fleet_cholesky_solve_ref)):
        got, want = fn(a * 2, b), ref(a * 2, b)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (k2.fleet_lu_solve.launches,
            k2.fleet_cholesky_solve.launches) == before


@pytest.mark.parametrize("case", ["case14test", "case118"])
def test_nr_update_keeps_its_cpu_bits(data_path, case):
    """``_nr_update`` on the CPU: the bits of the route before K2
    (``lu_factor`` + ``lu_solve``), for a fleet and a single state."""
    arr, vm, va, res = _nr_inputs(data_path, case, 4, seed=2)
    lu, piv = torch.linalg.lu_factor(res.jac)
    rhs = torch.cat([res.mp, res.mq], -1)
    dx = torch.linalg.lu_solve(lu, piv, rhs[..., None])[..., 0]
    n = vm.shape[1]
    not_slack = torch.arange(n) != arr.slack
    want_va = va - torch.where(not_slack, dx[:, :n], 0.0)
    want_vm = vm - torch.where(arr.bus_type == 1, dx[:, n:], 0.0)
    for check in (True, False):
        got_vm, got_va = _nr_update(arr, vm, va, res, "LU", check)
        assert torch.equal(got_vm, want_vm) and torch.equal(got_va, want_va)


def test_nr_update_raises_on_a_singular_jacobian_when_checked(data_path):
    arr, vm, va, res = _nr_inputs(data_path, "case14test", 3)
    res.jac[1, :, 5] = 0.0
    with pytest.raises(torch.linalg.LinAlgError,
                       match="scenario 1 is singular: U\\[5,5\\] is zero"):
        _nr_update(arr, vm, va, res, "LU")
    state = torch.cat(_nr_update(arr, vm, va, res, "LU", check=False), -1)
    assert torch.isfinite(state[[0, 2]]).all()
    assert not torch.isfinite(state[1]).all()


def test_solve_normal_keeps_its_cpu_bits(data_path):
    _, _, tarr, tnet, vm, va = _se_pair(data_path, "case118", 10)
    vm2 = torch.tensor(np.stack([vm, vm * 1.001]))
    va2 = torch.tensor(np.stack([va, va + 0.001]))
    res = se_fill_ref(tarr, tnet, vm2, va2, tarr.mean.expand(2, -1),
                      jacobian=True)
    gain, rhs = torch_acse._normal_equations(tarr, res)
    chol, info = torch.linalg.cholesky_ex(gain)
    want = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
    want = want * torch_acse._col_mask(tarr, len(vm), want)
    dx, maxinc, rel = torch_acse._solve_normal(tarr, gain, rhs)
    assert torch.equal(dx, want) and torch.equal(maxinc,
                                                 want.abs().amax(-1))
    assert (rel < 1e-10).all()
    bad = gain.clone()
    bad[1] = -bad[1]
    assert torch.isinf(torch_acse._solve_normal(tarr, bad, rhs)[2][1])


# --------------------------------------------------------------------------
# A numpy walk of csrc/fleet_solve.cu: each block's columns, the panels
# dealt block-cyclically, the owner's factorization, the copies, swaps,
# U12 and trailing updates, the back substitution's holder.
# --------------------------------------------------------------------------

W = k2.PANEL


def _global_col(lc, cluster, rank):
    return ((lc // W) * cluster + rank) * W + lc % W


def _local_col(g, cluster):
    return (g // W // cluster) * W + g % W


def _cols_before(p, cluster, rank):
    return (0 if p <= rank else (p - rank + cluster - 1) // cluster) * W


def _cols_through(p, cluster, rank):
    return (0 if p < rank else (p - rank) // cluster + 1) * W


def _factor_panel(o, n, k0, nf, lc0, chol):
    """The owner's panel steps; returns the pivot rows, the 1/s values and
    the first bad pivot (1-based) or 0."""
    wp = min(W, n + 1 - k0)
    panel = o[:, lc0:lc0 + wp]
    piv, rd, info = [], [], 0
    for jj in range(nf):
        j = k0 + jj
        q = j
        if not chol:
            key = np.abs(panel[j:, jj])
            q = j + int(np.argmax(np.where(np.isnan(key), np.inf, key)))
        pr, jr = panel[q].copy(), panel[j].copy()
        pivot = pr[jj]
        root = np.sqrt(pivot) if chol else pivot
        with np.errstate(divide="ignore", invalid="ignore"):
            rcp = 1.0 / root
        piv.append(q)
        rd.append(rcp if chol else 1.0)
        if (not pivot > 0 if chol else pivot == 0) and not info:
            info = j + 1
        top = pr.copy()
        if chol:
            top[jj + 1:] *= rcp
            top[jj] = root
        if q != j:
            panel[q] = jr
        panel[j] = top
        below = panel[j + 1:, jj] * rcp if chol or pivot != 0 else \
            panel[j + 1:, jj].copy()
        panel[j + 1:, jj] = below
        u = pr[jj + 1:] * rcp if chol else pr[jj + 1:]
        panel[j + 1:, jj + 1:] -= np.outer(below, u)
    o[:, lc0:lc0 + wp] = panel
    return piv, rd, info


def _walk(a, b, cluster, chol=False, factors=False):
    """What one K2 launch computes for one scenario with a cluster of
    ``cluster`` blocks: ``(x, info, lu, piv)`` (pivots 1-based)."""
    n = len(b)
    full = np.concatenate([a, b[:, None]], 1)
    ncols = [k2.block_columns(n, cluster, r) for r in range(cluster)]
    col = [full[:, [_global_col(lc, cluster, r) for lc in range(ncols[r])]]
           for r in range(cluster)]
    info = [0] * cluster
    pivots = np.zeros(n, dtype=np.int64)
    panels = -(-n // W)
    for p in range(panels):
        k0, owner = p * W, p % cluster
        nf = min(W, n - k0)
        lc0 = _cols_before(p, cluster, owner)
        pv, rd, bad = _factor_panel(col[owner], n, k0, nf, lc0, chol)
        info[owner] = info[owner] or bad
        pivots[k0:k0 + nf] = np.asarray(pv) + 1
        L = col[owner][:, lc0:lc0 + nf].copy()
        for r in range(cluster):
            c = col[r]
            before = _cols_before(p, cluster, r)
            right = min(_cols_through(p, cluster, r), ncols[r])
            for cc in range(ncols[r]):
                if chol or (cc < right and not (factors and cc < before)):
                    continue
                for t in range(nf):
                    c[[k0 + t, pv[t]], cc] = c[[pv[t], k0 + t], cc]
            for cc in range(right, ncols[r]):
                u = c[k0:k0 + nf, cc].copy()
                for t in range(nf):
                    if chol:
                        u[t] *= rd[t]
                    u[t + 1:] -= L[k0 + t + 1:k0 + nf, t] * u[t]
                c[k0:k0 + nf, cc] = u
                c[k0 + nf:, cc] -= L[k0 + nf:] @ u
    lu = np.zeros((n, n))
    for r in range(cluster):
        for lc in range(ncols[r]):
            g = _global_col(lc, cluster, r)
            if g < n:
                lu[:, g] = col[r][:, lc]
    holder = (n // W) % cluster
    y = {holder: col[holder][:, _local_col(n, cluster)].copy()}
    x = np.zeros(n)
    for p in range(panels - 1, -1, -1):
        owner, k0 = p % cluster, p * W
        vec = y[holder].copy()
        u = col[owner][:, _local_col(k0, cluster):]
        for jj in range(min(W, n - k0) - 1, -1, -1):
            j = k0 + jj
            with np.errstate(divide="ignore", invalid="ignore"):
                x[j] = vec[j] / u[j, jj]
                vec[:j] -= u[:j, jj] * x[j]
        y[owner], holder = vec, owner
    return x, min([f for f in info if f], default=0), lu, pivots


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 28, 60, 236])
def test_walk_of_the_kernel_layout_lu(data_path, n, cluster):
    """At panel and cluster boundaries and the fleets' orders: getrf's
    pivots, its factors and the solution, with the factors' row swaps
    applied to the columns left of each panel."""
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n))
    if n == 236:
        a = _nr_inputs(data_path, "case118", 1)[3].jac[0].numpy()
    b = rng.standard_normal(n)
    lu, piv, info = (t[0].numpy() for t in torch.linalg.lu_factor_ex(
        torch.tensor(a)[None]))
    want = np.linalg.solve(a, b)
    x, got_info, got_lu, got_piv = _walk(a, b, cluster, factors=True)
    assert got_info == info == 0
    np.testing.assert_array_equal(got_piv, piv)
    assert np.abs(got_lu - lu).max() <= WALK_TOL * np.abs(lu).max()
    assert np.abs(x - want).max() <= JAX_TOL * np.abs(want).max()


@pytest.mark.parametrize("cluster", [1, 4])
@pytest.mark.parametrize("n", [17, 60, 236])
def test_walk_of_the_kernel_layout_cholesky(n, cluster):
    rng = np.random.default_rng(n)
    m = rng.standard_normal((n, n))
    g = m @ m.T / n + np.eye(n)
    b = rng.standard_normal(n)
    want, info = k2.fleet_cholesky_solve_ref(torch.tensor(g)[None],
                                             torch.tensor(b)[None])
    x, got_info, _, _ = _walk(g, b, cluster, chol=True)
    assert got_info == int(info) == 0
    want = want[0].numpy()
    assert np.abs(x - want).max() <= JAX_TOL * np.abs(want).max()


def test_walk_reports_the_plain_versions_info():
    """A zero column (LU) and an indefinite gain (Cholesky) stop no
    scenario: info is the plain version's, x is not finite."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((28, 28))
    a[:, 5] = 0.0
    b = rng.standard_normal(28)
    info = int(torch.linalg.lu_factor_ex(torch.tensor(a)[None])[2])
    x, got, _, _ = _walk(a, b, 2)
    assert got == info == 6 and not np.isfinite(x).all()
    g = np.diag(np.r_[np.ones(20), -1.0, np.ones(19)])
    info = int(torch.linalg.cholesky_ex(torch.tensor(g)[None])[1])
    assert _walk(g, np.ones(40), 2, chol=True)[1] == info == 21
