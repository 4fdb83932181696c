"""The port's BBD Newton-Raphson and BBD fast decoupled power flow against
the JAX package's: the host routing tables (equal), K1's routed mode as
its plain version against ``_quadrant_values`` and the four routing
scatters with their masks, and every case of ``tests/test_newton_bbd.py``
and the non-slow case of ``tests/test_scale_25k_path.py`` against both the
JAX BBD path and the port's dense path. The CUDA kernel itself is held to
its plain version on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.powerflow import fast_decoupled as jax_fd
from juliagrid_tpu.powerflow import newton_bbd as jax_nb
from juliagrid_tpu.system.builders import update_branch as jax_update_branch
from juliagrid_tpu.utils.synthetic import synthetic_grid as jax_grid
from juliagrid_tpu_torch.convert import nr_bbd_arrays_from_numpy
from juliagrid_tpu_torch.kernels import nr_fill as k1
from juliagrid_tpu_torch.powerflow import fast_decoupled as torch_fd
from juliagrid_tpu_torch.powerflow import newton_bbd as torch_nb
from juliagrid_tpu_torch.system.builders import update_branch
from juliagrid_tpu_torch.utils.synthetic import synthetic_grid

#: states of the BBD solves against the JAX package's and the dense path's
#: (tests/test_newton_bbd.py holds the JAX BBD to the dense path at 1e-9;
#: both packages factor to f64 accuracy here)
STATE_TOL = 1e-10
#: the fast decoupled BBD states (tests/test_newton_bbd.py's 1e-9 / 1e-8)
FDPF_TOL = 1e-9
#: K1's routed values against the JAX package's (same formulas in f64)
K1_TOL = 1e-13


def _systems(data_path, case, off_branch=None):
    if case.startswith("grid"):
        rows, cols = map(int, case[4:].split("x"))
        jsys, tsys = jax_grid(rows, cols), synthetic_grid(rows, cols)
    else:
        path = str(data_path / case)
        jsys, tsys = jg.power_system(path), jgt.power_system(path)
    if off_branch is not None:
        jax_update_branch(jsys, off_branch, status=0)
        update_branch(tsys, off_branch, status=0)
    return jsys, tsys


CASES = [("case30test.m", 3, None), ("grid10x12", 4, None),
         ("grid6x8", 4, 10), ("case118.m", 4, None)]


@pytest.mark.parametrize("case,k,off", CASES)
def test_compile_nr_bbd_tables_match_jax(data_path, case, k, off):
    """Every routing table, mask and local border map equal, the
    out-of-service branch's dropped structural zero included."""
    jsys, tsys = _systems(data_path, case, off)
    want, layout = jax_nb.compile_nr_bbd(jsys, k)
    got = torch_nb.nr_bbd_tables(tsys, k)
    for name in want._fields[:-1]:          # all but the static n_blocks
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    _, tlayout = nr_bbd_arrays_from_numpy(**got, device="cpu")
    assert tlayout == torch_nb._BbdLayout(**vars(layout))


def _carried(jarr):
    """The port's NrBbdArrays from the JAX package's fields."""
    return nr_bbd_arrays_from_numpy(
        **{f: np.asarray(getattr(jarr, f)) for f in jarr._fields[:-1]},
        device="cpu")


def _jax_blocks(jarr, lay, vm, va):
    """The JAX package's routed and masked blocks (newton_bbd.py:287-319)."""
    vals, _, _ = jax_nb._quadrant_values(jarr, vm, va)
    k, ni, mb, mbl = lay.k, lay.ni, lay.mb, lay.mbl
    a_ii = jnp.zeros((k, 2 * ni, 2 * ni)).at[
        jarr.ii_blk, jarr.ii_row, jarr.ii_col].add(vals[jarr.ii_sel])
    a_ib = jnp.zeros((k, 2 * ni, 2 * mbl)).at[
        jarr.ib_blk, jarr.ib_row, jarr.ib_col].add(vals[jarr.ib_sel])
    a_bi = jnp.zeros((k, 2 * mbl, 2 * ni)).at[
        jarr.bi_blk, jarr.bi_row, jarr.bi_col].add(vals[jarr.bi_sel])
    a_bb = jnp.zeros((2 * mb, 2 * mb)).at[jarr.bb_row, jarr.bb_col].add(
        vals[jarr.bb_sel])
    mi, mbd = jarr.mask_int, jarr.mask_bdr
    mloc = jnp.concatenate([mbd, jnp.zeros(1)])[jarr.bsel] * jarr.bmask
    a_ii = mi[:, :, None] * a_ii * mi[:, None, :] \
        + jnp.eye(2 * ni)[None] * (1.0 - mi)[:, :, None]
    a_ib = mi[:, :, None] * a_ib * mloc[:, None, :]
    a_bi = mloc[:, :, None] * a_bi * mi[:, None, :]
    a_bb = mbd[:, None] * a_bb * mbd[None, :] + jnp.diag(1.0 - mbd)
    return a_ii, a_ib, a_bi, a_bb


@pytest.mark.parametrize("case,k,off", [CASES[0], CASES[2]])
def test_routed_twin_matches_jax_blocks(data_path, case, k, off):
    """K1's routed plain version at random states against
    ``_quadrant_values`` + the four scatters + the family masks."""
    jsys, _ = _systems(data_path, case, off)
    jarr, lay = jax_nb.compile_nr_bbd(jsys, k)
    tarr, tlay = _carried(jarr)
    n = len(np.asarray(jarr.bus_block))
    rng = np.random.default_rng(8)
    for _ in range(2):
        vm = 1.0 + 0.05 * rng.standard_normal(n)
        va = 0.2 * rng.standard_normal(n)
        res = k1.nr_fill_routed(tarr.net, tarr.route, torch.tensor(vm),
                                torch.tensor(va))
        got = torch_nb._blocks(res.buf, tlay)
        want = _jax_blocks(jarr, lay, jnp.asarray(vm), jnp.asarray(va))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=K1_TOL)
        _, mq, _, _ = (np.asarray(x) for x in jg.powerflow.ac._mismatch(
            jarr, jnp.asarray(vm), jnp.asarray(va)))
        np.testing.assert_allclose(res.mq.numpy(), mq, rtol=0, atol=K1_TOL)


def test_routed_wrapper_checks_and_counts(data_path):
    tsys = jgt.power_system(str(data_path / "case30test.m"))
    arr, _ = torch_nb.compile_nr_bbd(tsys, 3, "cpu")
    vm = torch.ones(tsys.bus.number, dtype=torch.float64)
    before = k1.nr_fill_routed.launches
    k1.nr_fill_routed(arr.net, arr.route, vm, vm * 0)
    assert k1.nr_fill_routed.launches == before   # the CPU runs the twin
    with pytest.raises(ValueError, match="shape"):
        k1.nr_fill_routed(arr.net, arr.route, vm[:-1], vm[:-1])
    bad = arr.route._replace(off=arr.route.off[:, :-1])
    with pytest.raises(ValueError, match="route.off"):
        k1.nr_fill_routed(arr.net, bad, vm, vm * 0)


def test_check_route_needs_one_writer():
    off = np.array([[0, 3, -1], [5, -1, -1], [-1, -1, 1], [2, 4, -1]])
    k1.check_route(off, np.array([6]), 7)
    with pytest.raises(ValueError, match="share"):
        k1.check_route(off, np.array([3]), 7)
    with pytest.raises(ValueError, match="outside"):
        k1.check_route(off, np.array([7]), 7)


def _solve_both(data_path, case, k, off):
    jsys, tsys = _systems(data_path, case, off)
    jbbd = jax_nb.newton_raphson_bbd(jsys, n_blocks=k)
    jax_nb.power_flow_bbd(jbbd)
    tbbd = jgt.newton_raphson_bbd(tsys, n_blocks=k, device="cpu")
    jgt.power_flow_bbd(tbbd)
    _, dsys = _systems(data_path, case, off)
    dense = jgt.newton_raphson(dsys, device="cpu")
    jgt.power_flow(dense)
    return jbbd, tbbd, dense


def _close(a, b, tol):
    np.testing.assert_allclose(a.voltage.magnitude, b.voltage.magnitude,
                               rtol=0, atol=tol)
    np.testing.assert_allclose(a.voltage.angle, b.voltage.angle, rtol=0,
                               atol=tol)


@pytest.mark.parametrize("case,k,off", CASES[:3])
def test_bbd_nr_matches_jax_and_dense(data_path, case, k, off):
    """test_bbd_nr_matches_dense_case30, test_bbd_nr_synthetic_grid and
    test_bbd_nr_off_branch_cross_interior: equal iteration counts, states
    within 1e-10 of the JAX BBD and of the port's dense path."""
    jbbd, tbbd, dense = _solve_both(data_path, case, k, off)
    assert tbbd.method.converged
    assert (tbbd.method.iteration == jbbd.method.iteration
            == dense.method.iteration)
    _close(tbbd, jbbd, STATE_TOL)
    _close(tbbd, dense, STATE_TOL)


def test_bbd_nr_case118_matches_dense(data_path):
    """tests/test_scale_25k_path.py's non-slow case: case118 at k=4 equal
    to the dense path to 1e-12 in the same iterations."""
    jbbd, tbbd, dense = _solve_both(data_path, "case118.m", 4, None)
    assert tbbd.method.converged
    assert tbbd.method.iteration == dense.method.iteration \
        == jbbd.method.iteration
    assert np.max(np.abs(tbbd.voltage.magnitude
                         - dense.voltage.magnitude)) < 1e-12


def test_bbd_nr_on_carried_tables(data_path):
    """The port's loop on the JAX package's own tables reproduces the JAX
    BBD solve."""
    jsys = jg.power_system(str(data_path / "case30test.m"))
    jbbd = jax_nb.newton_raphson_bbd(jsys, n_blocks=3)
    tarr, tlay = _carried(jbbd.arrays)
    vm, va = (torch.tensor(x) for x in jg.powerflow.ac
              .initialize_ac_power_flow(jg.power_system(
                  str(data_path / "case30test.m"))))
    jax_nb.power_flow_bbd(jbbd)
    vm, va, it, _, _, conv = torch_nb._nr_bbd_solve(tarr, tlay, vm, va,
                                                    1e-8, 20)
    assert conv and it == jbbd.method.iteration
    np.testing.assert_allclose(vm.numpy(), jbbd.voltage.magnitude, rtol=0,
                               atol=STATE_TOL)
    np.testing.assert_allclose(va.numpy(), jbbd.voltage.angle, rtol=0,
                               atol=STATE_TOL)


def test_bbd_nr_refresh_after_update():
    """test_bbd_nr_refresh_after_update: an update after construction
    reaches the BBD solve through the signature protocol."""
    system = synthetic_grid(6, 8)
    bbd = jgt.newton_raphson_bbd(system, n_blocks=4, device="cpu")
    jgt.power_flow_bbd(bbd)
    update_branch(system, 5, status=0)
    jgt.power_flow_bbd(bbd)

    fresh = jgt.newton_raphson(system, device="cpu")
    jgt.power_flow(fresh)
    jsys = jax_grid(6, 8)
    jbbd = jax_nb.newton_raphson_bbd(jsys, n_blocks=4)
    jax_nb.power_flow_bbd(jbbd)
    jax_update_branch(jsys, 5, status=0)
    jax_nb.power_flow_bbd(jbbd)
    assert bbd.method.converged
    assert bbd.method.iteration == jbbd.method.iteration
    _close(bbd, fresh, 1e-9)     # a warm start: test_newton_bbd.py's 1e-9
    _close(bbd, jbbd, STATE_TOL)
    assert jgt.mismatch(bbd)[0] < 1e-8


@pytest.mark.parametrize("case,k,bx,cap", [("case30test.m", 3, True, 40),
                                           ("case30test.m", 3, False, 40),
                                           ("grid20x20", 4, True, 60)])
def test_fnr_bbd_matches_jax_and_dense(data_path, case, k, bx, cap):
    """test_fnr_bbd_matches_plain and test_fnr_bbd_synthetic: the JAX
    package's counts, and the port's dense fast decoupled path's."""
    jsys, tsys = _systems(data_path, case)
    jbbd = jax_fd.fast_newton_raphson_bbd(jsys, bx=bx, n_blocks=k)
    jax_fd.power_flow_fnr_bbd(jbbd, iteration=cap)
    tbbd = torch_fd.fast_newton_raphson_bbd(tsys, bx=bx, n_blocks=k,
                                            device="cpu")
    torch_fd.power_flow_fnr_bbd(tbbd, iteration=cap)
    _, dsys = _systems(data_path, case)
    dense = (jgt.fast_newton_raphson_bx if bx
             else jgt.fast_newton_raphson_xb)(dsys, device="cpu")
    jgt.power_flow(dense, iteration=cap)
    assert tbbd.method.converged
    assert (tbbd.method.iteration == jbbd.method.iteration
            == dense.method.iteration)
    _close(tbbd, jbbd, FDPF_TOL)
    _close(tbbd, dense, FDPF_TOL)


def test_fnr_bbd_refresh_after_update():
    """test_fnr_bbd_refresh_after_update: the B'/B'' factors are rebuilt
    when the system moves past the captured revision."""
    system = synthetic_grid(6, 8)
    bbd = torch_fd.fast_newton_raphson_bbd(system, bx=True, n_blocks=4,
                                           device="cpu")
    torch_fd.power_flow_fnr_bbd(bbd)
    update_branch(system, 5, status=0)
    torch_fd.power_flow_fnr_bbd(bbd, iteration=60)

    system2 = synthetic_grid(6, 8)
    update_branch(system2, 5, status=0)
    fresh = jgt.fast_newton_raphson_bx(system2, device="cpu")
    jgt.power_flow(fresh, iteration=60)
    jsys = jax_grid(6, 8)
    jbbd = jax_fd.fast_newton_raphson_bbd(jsys, bx=True, n_blocks=4)
    jax_fd.power_flow_fnr_bbd(jbbd)
    jax_update_branch(jsys, 5, status=0)
    jax_fd.power_flow_fnr_bbd(jbbd, iteration=60)
    assert bbd.method.converged
    assert bbd.method.iteration == jbbd.method.iteration
    _close(bbd, fresh, 1e-8)
    _close(bbd, jbbd, 1e-8)


def test_bbd_entry_points_default_to_the_card(data_path):
    """Without ``device=`` the BBD analyses ask for ``config.device``
    ("cuda"), which raises on a host without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    system = jgt.power_system(str(data_path / "case14test.m"))
    for build in (jgt.newton_raphson_bbd,
                  torch_fd.fast_newton_raphson_bbd):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(system, n_blocks=2)
