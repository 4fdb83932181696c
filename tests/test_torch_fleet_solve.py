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
factors) and 1e-9 of max|x|, and its pivots must be getrf's.

The tests marked ``card`` run K2 itself; the JAX package is imported only
inside the tests that compare with it, so that they also run where JAX is
not installed::

    python -m pytest tests/test_torch_fleet_solve.py --noconftest -m card"""

import pathlib
import types

import numpy as np
import pytest
import torch

import juliagrid_tpu_torch as jgt
from juliagrid_tpu_torch.estimation import acse as torch_acse
from juliagrid_tpu_torch.kernels import fleet_solve as k2
from juliagrid_tpu_torch.kernels.gain_fill import gain_fill_ref
from juliagrid_tpu_torch.kernels.nr_fill import nr_fill_ref
from juliagrid_tpu_torch.kernels.se_fill import se_fill_entries_ref
from juliagrid_tpu_torch.parallel import batched_nr_solve
from juliagrid_tpu_torch.powerflow.ac import (_masked_jacobian, _nr_rhs,
                                              _nr_update)

DATA = pathlib.Path(__file__).parent / "data"
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
    import jax
    import jax.numpy as jnp
    from juliagrid_tpu.ops.linalg import lu_factor32, lu_solve_refined

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
    import jax
    import jax.numpy as jnp

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
    import juliagrid_tpu as jg
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
    import jax.numpy as jnp
    from juliagrid_tpu.estimation.acse import gn_increment

    jarr, jnet, tarr, tnet, vm, va = _se_pair(data_path, case, pmu_every)
    want = np.asarray(gn_increment(jarr, jnet, jnp.asarray(vm),
                                   jnp.asarray(va), "LU")[0])
    gain, rhs = torch_acse._gain_equations(
        tarr, tnet, torch.tensor(vm)[None], torch.tensor(va)[None],
        tarr.mean[None], se_fill_entries_ref, gain_fill_ref)
    x, info = k2.fleet_cholesky_solve(gain, rhs)
    assert not info.any()
    dx = (x * torch_acse._col_mask(tarr, len(vm), x))[0].numpy()
    assert np.abs(want).max() > 1e-4
    np.testing.assert_allclose(dx, want, rtol=0, atol=JAX_TOL)


#: an H100 SM's shared memory (228 KB) and what each resident block
#: reserves of it: how many blocks of a plan fit an SM by shared memory
#: (the card's answer also counts registers: ``k2.blocks_per_sm``)
H100_SM_SHARED, BLOCK_RESERVED = 233472, 1024


@pytest.mark.parametrize("n,plan,blocks", [
    (1, (1, 8600, False, 1), 24),
    (28, (29, 16308, False, 1), 13),
    (60, (61, 25140, True, 2), 8),
    (181, (181, 219048, True, 1), 1),
    (236, (237, 209908, True, 3), 1),
    (256, (257, 153732, True, 4), 1),
])
def test_fleet_plan(n, plan, blocks):
    """A block a scenario. Up to order 128: the panel's 32 columns of ``n |
    1`` doubles, the region of the pivot step and the warps' U12 blocks
    (1,024 doubles), the right-hand side, 1 / U's diagonal, the permutation
    and the pivots; case14 needs no working matrix in device memory. Above
    128 the LU (256 threads, its region 2,048 doubles) keeps the trailing
    matrix in shared memory from the first panel at which it fits: at
    case118's 181 after one streamed panel (the 149 x 149 trailing
    matrix), at 236 after three, at 256 after four, one block an SM."""
    got = k2.fleet_plan(n)
    assert tuple(got) == plan
    assert got.shared_bytes == (
        k2.shared_bytes(n) if n <= k2.THREADS
        else k2.on_chip_bytes(n, got.first_on_chip))
    assert H100_SM_SHARED // (got.shared_bytes + BLOCK_RESERVED) == blocks


@pytest.mark.parametrize("n,first", [(129, 0), (160, 0), (161, 0),
                                     (165, 1), (181, 1), (200, 2), (236, 3),
                                     (256, 4)])
def test_first_on_chip_panel(n, first):
    """The LU above 128: the first panel whose trailing matrix, at a padded
    leading dimension, fits an H100 block beside the region, the right-hand
    side, 1 / U's diagonal and the ints (the whole matrix up to 161); a
    launch without factors needs device memory only to stream the panels
    before it. A smaller room moves it later."""
    plan = k2.fleet_plan(n)
    assert plan.first_on_chip == first and plan.scratch == (first > 0)
    m = n - k2.PANEL * first
    least = (8 * (m * (m | 1) + k2.WIDE_REGION + 2 * n)
             + 4 * (n + k2.PANEL + 1))
    assert least <= plan.shared_bytes <= k2.H100_ROOM
    if first:
        assert k2.on_chip_bytes(n, first - 1) > k2.H100_ROOM
    smaller = k2.fleet_plan(n, plan.shared_bytes - 1)
    assert smaller.first_on_chip > first
    assert smaller.shared_bytes < plan.shared_bytes


def test_panel_layout_plans_are_unchanged():
    """The Cholesky at every order and the LU up to 128 keep the panel
    layout: no panel on chip, the bytes of one staged panel."""
    for n in range(1, k2.CAP + 1):
        panels = -(-n // k2.PANEL)
        want = (n | 1, 8 * (k2.PANEL * (n | 1) + 1024 + 2 * n)
                + 4 * (n + k2.PANEL + 1), n > k2.PANEL, panels)
        assert tuple(k2.fleet_plan(n, cholesky=True)) == want
        if n <= k2.THREADS:
            assert tuple(k2.fleet_plan(n)) == want
    assert k2.fleet_plan(236, cholesky=True).shared_bytes == 73716


@pytest.mark.parametrize("args,match", [
    ((257,), "orders 1 to 256, not 257"),
    ((0,), "orders 1 to 256, not 0"),
    ((236, 70_000), "cannot hold an order-236 block \\(81908 bytes"),
    ((181, 50_000), "cannot hold an order-181 block \\(66472 bytes"),
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
])
@pytest.mark.parametrize("wrapper", [k2.fleet_lu_solve,
                                     k2.fleet_cholesky_solve])
def test_wrappers_refuse(wrapper, bad, error, match):
    with pytest.raises(error, match=match):
        wrapper(*bad(*_good()))


@pytest.mark.parametrize("n", [0, k2.CAP + 1])
@pytest.mark.parametrize("wrapper,ref", [
    (k2.fleet_lu_solve, k2.fleet_lu_solve_ref),
    (k2.fleet_cholesky_solve, k2.fleet_cholesky_solve_ref)])
def test_orders_outside_the_cap_take_the_plain_versions(wrapper, ref, n):
    """An order K2 does not take (no unknowns, or above ``CAP``) gives the
    plain version's bits and launches nothing, on any device: a CUDA fleet
    goes to K2 at orders 1 to ``CAP`` only."""
    rng = np.random.default_rng(n)
    m = torch.tensor(rng.standard_normal((2, n, n)))
    a = (m @ m.mT + n * torch.eye(n, dtype=torch.float64)).contiguous()
    b = torch.tensor(rng.standard_normal((2, n)))
    before = (k2.fleet_lu_solve.launches, k2.fleet_cholesky_solve.launches)
    got, want = wrapper(a, b), ref(a, b)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (k2.fleet_lu_solve.launches,
            k2.fleet_cholesky_solve.launches) == before
    on_card = [k2._launches_k2(types.SimpleNamespace(
        device=torch.device("cuda"), shape=(2, order, order)))
        for order in (n, 1, k2.CAP)]
    assert on_card == [False, True, True]


def test_lu_wrapper_refuses_bad_factor_buffers():
    a, b = _good()
    with pytest.raises(ValueError, match="lu must be torch.float64"):
        k2.fleet_lu_solve(a, b, lu=torch.empty(2, 4, 4))
    with pytest.raises(ValueError, match="piv must be torch.int32"):
        k2.fleet_lu_solve(a, b, piv=torch.empty(2, 4, dtype=torch.int64))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    a, b = _good()
    def counts():
        return (k2.fleet_lu_solve.launches, k2.fleet_lu_solve.on_chip,
                k2.fleet_cholesky_solve.launches)

    before = counts()
    for fn, ref in ((k2.fleet_lu_solve, k2.fleet_lu_solve_ref),
                    (k2.fleet_cholesky_solve, k2.fleet_cholesky_solve_ref)):
        got, want = fn(a * 2, b), ref(a * 2, b)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert counts() == before


@pytest.mark.parametrize("case", ["case14test", "case118", "case300"])
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


def test_nr_update_raises_on_a_singular_jacobian_above_the_cap(data_path):
    """Above ``CAP`` (case300's order) the library route's ``info`` is read
    as K2's is: checked, a singular scenario raises; unchecked, it alone
    comes out non-finite."""
    arr, vm, va, res = _nr_inputs(data_path, "case300", 3)
    assert arr.order > k2.CAP
    res.jac[1, :, 5] = 0.0
    with pytest.raises(torch.linalg.LinAlgError,
                       match="scenario 1 is singular: U\\[5,5\\] is zero"):
        _nr_update(arr, vm, va, res, "LU")
    state = torch.cat(_nr_update(arr, vm, va, res, "LU", check=False), -1)
    assert torch.isfinite(state[[0, 2]]).all()
    assert not torch.isfinite(state[1]).all()


def test_solve_normal_above_the_cap_keeps_the_library_bits(data_path):
    """Gains above ``CAP`` (order 262 here) get ``cholesky_ex`` +
    ``cholesky_solve``'s bits, the slack column masked, and ``rel`` inf
    where the factorization fails."""
    _, _, tarr, _, _, _ = _se_pair(data_path, "case14test", 3)
    n = k2.CAP + 6
    rng = np.random.default_rng(5)
    m = torch.tensor(rng.standard_normal((2, n, n)))
    gain = (m @ m.mT + n * torch.eye(n, dtype=torch.float64)).contiguous()
    rhs = torch.tensor(rng.standard_normal((2, n)))
    chol, _ = torch.linalg.cholesky_ex(gain)
    want = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
    want = want * torch_acse._col_mask(tarr, n // 2, want)
    dx, maxinc, rel = torch_acse._solve_normal(tarr, gain, rhs)
    assert torch.equal(dx, want) and torch.equal(maxinc,
                                                 want.abs().amax(-1))
    assert (rel < 1e-10).all()
    bad = gain.clone()
    bad[1] = -bad[1]
    assert torch.isinf(torch_acse._solve_normal(tarr, bad, rhs)[2][1])


def test_solve_normal_keeps_its_cpu_bits(data_path):
    _, _, tarr, tnet, vm, va = _se_pair(data_path, "case118", 10)
    vm2 = torch.tensor(np.stack([vm, vm * 1.001]))
    va2 = torch.tensor(np.stack([va, va + 0.001]))
    gain, rhs = torch_acse._gain_equations(
        tarr, tnet, vm2, va2, tarr.mean.expand(2, -1), se_fill_entries_ref,
        gain_fill_ref)
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


def _walk(a, b, chol=False, factors=False, first=None):
    """What one launch computes for one scenario: ``(x, info, w, piv)``,
    ``w`` the working matrix (the factors when asked for) and the pivots
    1-based. ``first`` is the LU above 128's first panel factored in shared
    memory (``fleet_plan(n).first_on_chip``; None: none, the panel
    layout): the on-chip matrix ``chip`` holds rows and columns ``ks = 32
    first`` on (NaN elsewhere), the last streamed panel's update writes the
    rows below it there, the panels from ``first`` on are staged from it and
    updated in place, the back substitution reads their U there, and the
    factors take its part at the end."""
    n, panel = len(b), k2.PANEL
    panels = -(-n // panel)
    first = panels if first is None else first
    ks = panel * first
    w = np.full((n, n), np.nan)
    chip = np.full((n, n), np.nan)
    if first == 0:
        chip[:] = a
    y = b.astype(float).copy()
    urcp = np.zeros(n)
    pivots = np.zeros(n, dtype=np.int64)
    info = 0
    for p in range(panels):
        k0 = p * panel
        nf = min(panel, n - k0)
        on = p >= first
        frm = (chip if on else a if p == 0 else w).copy()
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
        if on:
            chip[k0:, k0:k0 + nf] = ls[k0:]
        else:
            rend = n if chol or factors else k0 + nf
            w[k0:rend, k0:k0 + nf] = ls[k0:rend]
        top = chip if on else w
        low = chip if on or p == first - 1 else w
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
            low[k0 + panel:, cols] = frm[src[k0 + panel:], cols] - \
                ls[k0 + panel:] @ u
            top[k0:k0 + panel, cols] = u
        if factors and not chol:
            for t in range(nf):
                rows = [k0 + t, piv[t]]
                w[rows, :min(k0, ks)] = w[rows[::-1], :min(k0, ks)]
                chip[rows, ks:k0] = chip[rows[::-1], ks:k0]
    if factors:
        w[ks:, ks:] = chip[ks:, ks:]
    x = np.zeros(n)
    for p in range(panels - 1, -1, -1):
        k0 = p * panel
        nf = min(panel, n - k0)
        cols = range(k0, k0 + nf)

        def col(c):
            """U[:c, c] for the LU (its rows from ks on, of a column from ks
            on, in the on-chip matrix), Lᵀ[:c, c] = L[c, :c] for the
            Cholesky."""
            if chol:
                return w[c, :c]
            if c < ks:
                return w[:c, c]
            return np.concatenate([w[:ks, c], chip[ks:c, c]])

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


@pytest.mark.parametrize("n,kind,room", [
    (n, kind, k2.H100_ROOM) for n in ORDERS
    for kind in ("normal", "dominant")] + [
    (n, kind, room) for n, kind in ((181, "case118"), (236, "case118"),
                                    (181, "singular"), (200, "singular"),
                                    (200, "normal"))
    for room in (k2.H100_ROOM, 150_000)])
def test_walk_on_chip_phase_gives_the_panel_walks_bits(data_path, n, kind,
                                                       room):
    """The LU above 128 with its working matrix in shared memory from
    ``fleet_plan(n, room).first_on_chip`` on (an H100's room, and a smaller
    one that streams more panels; up to 128 no panel is on chip): x, info,
    the pivots and the factors are the panel layout's, bit for bit."""
    rng = np.random.default_rng(n)
    singular = kind == "singular"
    a = _lu_input(data_path, n, "normal" if singular else kind, rng)
    if singular:
        a[:, n // 2] = 0.0
    b = rng.standard_normal(n)
    first = k2.fleet_plan(n, room).first_on_chip
    assert (first < -(-n // k2.PANEL)) == (n > k2.THREADS)
    for factors in (False, True):
        want = _walk(a, b, factors=factors)
        got = _walk(a, b, factors=factors, first=first)
        assert got[1] == want[1] == (n // 2 + 1 if singular else 0)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[3], want[3])
        if factors:
            np.testing.assert_array_equal(got[2], want[2])


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


# --------------------------------------------------------------------------
# On the card: the LU above 128 factors on chip
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_lu_input(kind, batch, card):
    """case118's NR Jacobians at the unknowns' order (181) at ``batch``
    perturbed states, or ``batch`` random order-236 matrices ``2 I + N(0,
    1/n)`` with their rows shuffled, the second with a zero column (numpy,
    seeded); and right-hand sides."""
    if kind == "case118":
        arr, _, _, res = _nr_inputs(DATA, "case118", batch, seed=5)
        a, b = res.jac.contiguous(), _nr_rhs(arr, res)
    else:
        rng = np.random.default_rng(236)
        n = 236
        m = rng.standard_normal((batch, n, n)) / np.sqrt(n) + 2 * np.eye(n)
        a = torch.tensor(np.stack([x[rng.permutation(n)] for x in m]))
        a[1, :, 100] = 0.0
        b = torch.tensor(rng.standard_normal((batch, n)))
    return a.to(card), b.to(card)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["case118", "random236"])
def test_card_wide_lu_takes_the_on_chip_path(card, kind):
    """K2's LU above 128 at 64 scenarios counts each launch in
    ``fleet_lu_solve.on_chip``; x is the plain version's to the parity
    tolerance, info and the pivots are getrf's, the factors within the
    walk's tolerance of its scale, and writing the factors leaves x's
    bits."""
    a, b = _card_lu_input(kind, 64, card)
    n = a.shape[1]
    assert k2.fleet_plan(n).first_on_chip < -(-n // k2.PANEL)
    before = (k2.fleet_lu_solve.launches, k2.fleet_lu_solve.on_chip)
    x, info = k2.fleet_lu_solve(a, b)
    lu = torch.empty_like(a)
    piv = torch.empty(a.shape[:2], dtype=torch.int32, device=card)
    again, info2 = k2.fleet_lu_solve(a, b, lu=lu, piv=piv)
    after = (k2.fleet_lu_solve.launches, k2.fleet_lu_solve.on_chip)
    assert after[0] - before[0] == after[1] - before[1] == 2
    rlu = torch.empty_like(a, device="cpu")
    rpiv = torch.empty(a.shape[:2], dtype=torch.int32)
    want, rinfo = k2.fleet_lu_solve_ref(a.cpu(), b.cpu(), lu=rlu, piv=rpiv)
    assert torch.equal(info.cpu(), rinfo) and torch.equal(info2, info)
    assert bool((rinfo != 0).any()) == (kind == "random236")
    good = rinfo == 0
    x = x.cpu()
    scale = want[good].abs().amax(-1)
    assert float(((x[good] - want[good]).abs().amax(-1) / scale).max()) \
        <= JAX_TOL
    assert torch.equal(x.view(torch.int64), again.cpu().view(torch.int64))
    assert torch.equal(piv.cpu()[good], rpiv[good])
    ferr = ((lu.cpu()[good] - rlu[good]).abs().amax((-2, -1))
            / rlu[good].abs().amax((-2, -1)))
    assert float(ferr.max()) <= WALK_TOL


@pytest.mark.card
def test_card_case118_fleet_launches_every_lu_on_chip(card):
    """``batched_nr_solve`` on case118 (64 scenarios, each bus's P and Q
    scaled by 1 + 0.05 N(0, 1)): every K2 launch of the call factors on
    chip, and every scenario converges."""
    analysis = jgt.newton_raphson(jgt.power_system(str(DATA / "case118.m")),
                                  device=card)
    arr = analysis.arrays
    vm, va = (x.expand(64, -1).contiguous() for x in analysis._state())
    rng = np.random.default_rng(118)
    factor = torch.tensor(1.0 + 0.05 * rng.standard_normal(vm.shape),
                          device=card)
    before = (k2.fleet_lu_solve.launches, k2.fleet_lu_solve.on_chip)
    out = batched_nr_solve(arr, vm, va, arr.p_sched * factor,
                           arr.q_sched * factor)
    launches = k2.fleet_lu_solve.launches - before[0]
    assert launches > 0
    assert k2.fleet_lu_solve.on_chip - before[1] == launches
    assert bool(out[3].all())
