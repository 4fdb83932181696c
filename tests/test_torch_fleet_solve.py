"""K2 ``fleet_solve`` on the CPU: its plain versions against the JAX
package's solves, its planner, its wrappers' refusals, the call sites'
bits, and a numpy walk of the kernel's layout (a block a scenario, the
working matrix in device memory, a panel in shared memory).

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
from juliagrid_tpu_torch.powerflow.ac import (_masked_jacobian, _nr_rhs,
                                              _nr_update)

CASES = ("case14test", "case30test", "case118")
JAX_TOL = 1e-9
FACTOR_TOL = 1e-12
WALK_TOL = 1e-10


def _nr_inputs(data_path, case, batch, seed=0):
    """The network, the states and K1's plain output at them: the NR
    Jacobians ``[B, N, N]`` at the unknowns' order and the mismatches of
    ``case`` at states perturbed from its stored start (numpy, seeded);
    ``_nr_rhs`` gathers the right-hand sides ``[B, N]``."""
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
    arr, _, _, res = _nr_inputs(data_path, case, batch)
    a = res.jac.contiguous()
    b = _nr_rhs(arr, res)
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


#: an H100 SM's shared memory (228 KB) and what each resident block
#: reserves of it: how many blocks of a plan fit an SM by shared memory
#: (the card's answer also counts registers: ``k2.blocks_per_sm``)
H100_SM_SHARED, BLOCK_RESERVED = 233472, 1024


@pytest.mark.parametrize("n,plan,blocks", [
    (1, (1, 8600, False), 24),
    (28, (29, 16308, False), 13),
    (60, (61, 25140, True), 8),
    (236, (237, 73716, True), 3),
    (256, (257, 79236, True), 2),
])
def test_fleet_plan(n, plan, blocks):
    """A block a scenario: the panel's 32 columns of ``n | 1`` doubles, the
    region of the pivot step and the warps' U12 blocks (1,024 doubles),
    the right-hand side, 1 / U's diagonal, the permutation and the
    pivots. Three case118 blocks fit an H100 SM's 228 KB (396 scenarios
    in flight); case14 needs no working matrix in device memory."""
    got = k2.fleet_plan(n)
    assert tuple(got) == plan
    assert got.shared_bytes == k2.shared_bytes(n)
    assert H100_SM_SHARED // (got.shared_bytes + BLOCK_RESERVED) == blocks


@pytest.mark.parametrize("args,match", [
    ((257,), "orders 1 to 256, not 257"),
    ((0,), "orders 1 to 256, not 0"),
    ((236, 70_000), "cannot hold an order-236 block \\(73716 bytes"),
])
def test_fleet_plan_refuses_above_the_cap_and_unfit_rooms(args, match):
    with pytest.raises(ValueError, match=match):
        k2.fleet_plan(*args)


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
    (``lu_factor`` + ``lu_solve``) on the Newton system at the unknowns'
    order, the step taken at the unknowns and 0.0 at the fixed variables,
    for a fleet and a single state."""
    arr, vm, va, res = _nr_inputs(data_path, case, 4, seed=2)
    lu, piv = torch.linalg.lu_factor(res.jac)
    rhs = torch.cat([res.mp, res.mq], -1)[:, arr.unknowns]
    dx = torch.linalg.lu_solve(lu, piv, rhs[..., None])[..., 0]
    n = vm.shape[1]
    step = torch.zeros(4, 2 * n, dtype=dx.dtype)
    step[:, arr.unknowns] = dx
    want_va, want_vm = va - step[:, :n], vm - step[:, n:]
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
# A numpy walk of csrc/fleet_solve.cu: a block a scenario, panel by panel
# from the working matrix (panel 0 from A); the LU's pivot step by warp
# candidates, the panel's row permutation, the right-hand side carried
# through the column steps; the Cholesky's column steps on the lower
# triangle only; the warps'
# column groups (the LU's U12 gathered through the permutation and solved
# with L11, the rows below updated), the factors' left swaps, and the back
# substitution a panel at a time from the last.
# --------------------------------------------------------------------------

ORDERS = [1, 15, 16, 17, 28, 31, 32, 33, 60, 64, 65, 127, 128, 129, 236, 256]


def _pivot(col, j):
    """The LU's pivot row of a panel column: each warp's largest |a| of its
    rows (thread t holds rows t, t + THREADS, ...; NaN as the largest,
    ties to the lowest row), then the largest of the warps' candidates."""
    n = len(col)
    key = np.where(np.isnan(col), np.inf, np.abs(col))
    cands = []
    for warp in range(k2.THREADS // 32):
        rows = [r for r in range(j, n) if (r % k2.THREADS) // 32 == warp]
        if rows:
            best = max(rows, key=lambda r: (key[r], -r))
            cands.append((key[best], -best))
    return -max(cands)[1]


def _factor_panel_lu(ls, y, src, k0, nf):
    """The LU's column steps on the staged panel ``ls`` (rows 0 .. n - 1 of
    the panel's columns; rows k0 .. n - 1 are its), the right-hand side
    carried along: each step's column, final after it, goes to ``out`` at
    its row's panel-start position (``org``), and ``ls`` ends as ``out``
    with its rows in pivot order (new row r is panel-start row ``src[r]``).
    Returns the pivot rows, 1 / each pivot and the first zero pivot
    (1-based) or 0."""
    n = ls.shape[0]
    piv, rcps, info = [], [], 0
    org = np.arange(n)
    out = np.full_like(ls, np.nan)
    for jj in range(nf):
        j = k0 + jj
        with np.errstate(divide="ignore", invalid="ignore"):
            p = _pivot(ls[:, jj], j)
            prow, jrow = ls[p].copy(), ls[j].copy()
            pivot = prow[jj]
            rcp = 1.0 / pivot
            piv.append(p)
            rcps.append(rcp)
            if pivot == 0 and not info:
                info = j + 1
            y[[j, p]] = y[[p, j]]
            src[[j, p]] = src[[p, j]]
            org[[j, p]] = org[[p, j]]
            for r in range(j, n):
                if r == j:
                    ls[r] = prow
                    continue
                if r == p:
                    ls[r] = jrow
                l = ls[r, jj] * rcp if pivot != 0 else ls[r, jj]
                ls[r, jj] = l
                ls[r, jj + 1:nf] -= l * prow[jj + 1:nf]
                y[r] -= l * y[j]
        out[org[k0:], jj] = ls[k0:, jj]
    ls[k0:] = out[src[k0:]]
    return piv, np.asarray(rcps), info


def _factor_panel_cholesky(ls, y, k0, nf):
    """The Cholesky's column steps on the staged panel, the lower triangle
    only: step j publishes column j of the diagonal block's rows from row j
    down and row j's right-hand side; row j takes s = a_jj / sqrt(a_jj),
    every row below scales its column j by 1 / sqrt(a_jj) and updates its
    later columns up to its own diagonal and its right-hand side. Returns 1
    / sqrt of each pivot and the first pivot that is not positive (1-based)
    or 0."""
    rcps, info = [], 0
    lo = k0 + nf  # the first row below the diagonal block
    with np.errstate(divide="ignore", invalid="ignore"):
        for jj in range(nf):
            j = k0 + jj
            pub = ls[j:lo, jj].copy()  # column j from row j, unscaled
            pivot = pub[0]
            rcp = 1.0 / np.sqrt(pivot)
            rcps.append(rcp)
            if not pivot > 0 and not info:
                info = j + 1
            ls[j, jj] = pivot * rcp
            y[j] *= rcp
            u = pub[1:] * rcp  # L's column j below row j, in the block
            for r in range(j + 1, lo):  # the block's rows: to the diagonal
                l = ls[r, jj] * rcp
                ls[r, jj] = l
                ls[r, jj + 1:r - k0 + 1] -= l * u[:r - j]
                y[r] -= l * y[j]
            l = ls[lo:, jj] * rcp  # the rows below the block
            ls[lo:, jj] = l
            ls[lo:, jj + 1:nf] -= np.outer(l, u)
            y[lo:] -= l * y[j]
    return np.asarray(rcps), info


def _walk(a, b, chol=False, factors=False):
    """What one launch computes for one scenario: ``(x, info, w, piv)``,
    ``w`` the working matrix (the factors when asked for) and the pivots
    1-based."""
    n, panel = len(b), k2.PANEL
    w = np.full((n, n), np.nan)
    y = b.astype(float).copy()
    urcp = np.zeros(n)
    pivots = np.zeros(n, dtype=np.int64)
    info = 0
    panels = -(-n // panel)
    for p in range(panels):
        k0 = p * panel
        nf = min(panel, n - k0)
        frm = a if p == 0 else w.copy()
        ls = np.full((n, nf), np.nan)
        ls[k0:] = frm[k0:, k0:k0 + nf]  # staged
        src = np.arange(n)
        if chol:
            rcps, bad = _factor_panel_cholesky(ls, y, k0, nf)
            piv = list(range(k0, k0 + nf))
        else:
            piv, rcps, bad = _factor_panel_lu(ls, y, src, k0, nf)
        info = info or bad
        urcp[k0:k0 + nf] = rcps
        pivots[k0:k0 + nf] = np.asarray(piv) + 1
        rend = n if chol or factors else k0 + nf
        w[k0:rend, k0:k0 + nf] = ls[k0:rend]
        # the warps' groups of 8 trailing columns
        for c0 in range(k0 + nf, n, k2.COLUMNS):
            cols = slice(c0, min(c0 + k2.COLUMNS, n))
            if chol:
                lt = ls[cols].T  # U12 = L21ᵀ, rows c of the panel
                w[c0:, cols] = frm[c0:, cols] - ls[c0:] @ lt
                continue
            u = frm[src[k0:k0 + panel], cols].copy()
            for t in range(panel):
                u[t + 1:] -= np.outer(ls[k0 + t + 1:k0 + panel, t], u[t])
            w[k0 + panel:, cols] = frm[src[k0 + panel:], cols] - \
                ls[k0 + panel:] @ u
            w[k0:k0 + panel, cols] = u
        if factors and not chol:
            for t in range(nf):
                w[[k0 + t, piv[t]], :k0] = w[[piv[t], k0 + t], :k0]
    x = np.zeros(n)
    for p in range(panels - 1, -1, -1):
        k0 = p * panel
        nf = min(panel, n - k0)
        cols = range(k0, k0 + nf)
        # U[:, c] for the LU, Lᵀ[:, c] = L[c, :] for the Cholesky
        col = (lambda c: w[c, :c]) if chol else (lambda c: w[:c, c])
        with np.errstate(divide="ignore", invalid="ignore"):
            for c in reversed(cols):
                x[c] = y[c] * urcp[c]
                y[k0:c] -= col(c)[k0:c] * x[c]
            for c in reversed(cols):
                y[:k0] -= col(c)[:k0] * x[c]
    return x, info, w, pivots


def _lu_input(data_path, n, kind, rng):
    """A general N(0, 1) matrix, ``2 I + N(0, 1/n)`` with its rows shuffled
    (every column pivots, each by a wide margin), or case118's NR
    Jacobian: at the unknowns' order (181, what the fleets solve) or in the
    JAX package's masked 2n x 2n layout (236)."""
    if kind == "normal":
        return rng.standard_normal((n, n))
    if kind == "dominant":
        a = rng.standard_normal((n, n)) / np.sqrt(n) + 2 * np.eye(n)
        return a[rng.permutation(n)]
    arr, _, _, res = _nr_inputs(data_path, "case118", 1)
    jac = res.jac if n == arr.order else _masked_jacobian(arr, res.jac)
    assert jac.shape[-1] == n
    return jac[0].numpy()


@pytest.mark.parametrize("n,kind", [(n, kind) for n in ORDERS
                                    for kind in ("normal", "dominant")]
                         + [(236, "case118"), (181, "case118")])
def test_walk_of_the_kernel_layout_lu(data_path, n, kind):
    """Below, at and above the panel's and the one-row kernel's edges and
    at the fleets' orders: getrf's pivots, its factors and the solution,
    with each panel's swaps applied to the columns left of it."""
    rng = np.random.default_rng(n)
    a = _lu_input(data_path, n, kind, rng)
    b = rng.standard_normal(n)
    lu, piv, info = (t[0].numpy() for t in torch.linalg.lu_factor_ex(
        torch.tensor(a)[None]))
    want = np.linalg.solve(a, b)
    x, got_info, got_lu, got_piv = _walk(a, b, factors=True)
    assert got_info == info == 0
    np.testing.assert_array_equal(got_piv, piv)
    assert np.abs(got_lu - lu).max() <= WALK_TOL * np.abs(lu).max()
    assert np.abs(x - want).max() <= JAX_TOL * np.abs(want).max()


@pytest.mark.parametrize("n", [1, 17, 31, 32, 33, 60, 128, 129, 236, 256])
def test_walk_of_the_kernel_layout_cholesky(n):
    """The one-triangle Cholesky: NaN above the diagonal is never read, the
    factor is the plain version's and so is the solution."""
    rng = np.random.default_rng(n)
    m = rng.standard_normal((n, n))
    g = m @ m.T / n + np.eye(n)
    b = rng.standard_normal(n)
    chol, info = torch.linalg.cholesky_ex(torch.tensor(g)[None])
    want, _ = k2.fleet_cholesky_solve_ref(torch.tensor(g)[None],
                                          torch.tensor(b)[None])
    g[np.triu_indices(n, 1)] = np.nan
    x, got_info, w, _ = _walk(g, b, chol=True)
    assert got_info == int(info) == 0
    low = np.tril_indices(n)
    chol = chol[0].numpy()
    assert np.abs(w[low] - chol[low]).max() <= WALK_TOL * np.abs(chol).max()
    want = want[0].numpy()
    assert np.abs(x - want).max() <= JAX_TOL * np.abs(want).max()


@pytest.mark.parametrize("chol,n,bad", [
    (False, 40, 5),     # the first panel
    (False, 70, 40),    # a later panel
    (False, 200, 150),  # two rows a thread
    (True, 40, 20),     # the first diagonal block
    (True, 150, 100),   # a later one, rows below it
])
def test_walk_reports_the_plain_versions_info(chol, n, bad):
    """A zero column (LU) and an indefinite gain (Cholesky) stop no
    scenario: info is the plain version's, x is not finite."""
    rng = np.random.default_rng(n)
    b = rng.standard_normal(n)
    if chol:
        m = rng.standard_normal((n, n))
        a = m @ m.T / n + np.eye(n)
        a[bad] = a[:, bad] = 0.0
        a[bad, bad] = -1.0
        info = int(torch.linalg.cholesky_ex(torch.tensor(a)[None])[1])
    else:
        a = rng.standard_normal((n, n))
        a[:, bad] = 0.0
        info = int(torch.linalg.lu_factor_ex(torch.tensor(a)[None])[2])
    x, got, _, _ = _walk(a, b, chol=chol)
    assert got == info == bad + 1 and not np.isfinite(x).all()


def test_walk_pivot_step_takes_nan_as_largest_and_ties_low():
    """getrf's choice across warps: a NaN outranks every number, and of two
    equal |a| in rows of different warps the lower row wins."""
    col = np.zeros(200)
    col[[40, 150]] = [-3.0, 3.0]  # warps 1 and 0 (rows 150 = 22 + 128)
    assert _pivot(col, 0) == 40
    col[170] = np.nan
    assert _pivot(col, 0) == 170
    assert _pivot(col, 171) == 171
