"""The port's BBD Gauss-Newton state estimation against the JAX package's:
the host routing tables (equal), K3's routed mode as its plain version
against the per-block H of ``_gains_block`` (in f64) and ``h_entries``,
and the three cases of ``tests/test_se_bbd.py`` against both the JAX BBD
path and the port's dense path. The CUDA kernel itself is held to its
plain version on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.estimation import acse as jax_acse
from juliagrid_tpu.estimation import acse_bbd as jax_sb
from juliagrid_tpu.system.builders import update_branch as jax_update_branch
from juliagrid_tpu_torch.convert import se_bbd_arrays_from_numpy
from juliagrid_tpu_torch.estimation import acse_bbd as torch_sb
from juliagrid_tpu_torch.estimation.acse import compile_se_arrays
from juliagrid_tpu_torch.kernels import se_fill as k3
from juliagrid_tpu_torch.powerflow.ac import compile_ac_arrays
from juliagrid_tpu_torch.system.builders import update_branch
from juliagrid_tpu_torch.utils.errors import MethodError_

#: states against the JAX BBD and the dense path (tests/test_se_bbd.py)
STATE_TOL = 1e-10
#: K3's routed values against the JAX package's (same formulas in f64)
K3_TOL = 1e-12
#: the SeBbdArrays routing fields (the JAX package's pb_* tables serve its
#: per-block streaming and are not ported)
ROUTING = ("ent_rows", "hi_sel", "hi_blk", "hi_row", "hi_col", "hb_sel",
           "hb_blk", "hb_row", "hb_col", "rows_idx", "row_mask", "lb_gidx",
           "bus_block", "bus_slot", "mask_int", "mask_bdr")


def _scada_pmu(pkg, path, pmu_every, **device):
    """tests/test_se_bbd.py's set: zero-noise SCADA and polar PMUs on every
    ``pmu_every``-th bus, from each package's own power flow."""
    system = pkg.power_system(path)
    pf = pkg.newton_raphson(system, **device)
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


def _both(data_path, case, pmu_every):
    path = str(data_path / case)
    return (_scada_pmu(jg, path, pmu_every),
            _scada_pmu(jgt, path, pmu_every, device="cpu"))


@pytest.mark.parametrize("case,k,every", [("case14test.m", 2, 5),
                                          ("case118.m", 4, 10)])
def test_compile_se_bbd_tables_match_jax(data_path, case, k, every):
    (jsys, jmon), (tsys, tmon) = _both(data_path, case, every)
    want, layout, _, _ = jax_sb.compile_se_bbd(jsys, jmon, k)
    arr, _, _ = compile_se_arrays(tsys, tmon, device="cpu")
    got = torch_sb.se_bbd_tables(tsys, arr, compile_ac_arrays(tsys, "cpu"),
                                 k)
    assert set(got) == set(ROUTING)
    for name in ROUTING:
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    bb = jgt.estimation.gauss_newton_bbd(tmon, n_blocks=k, device="cpu")
    assert bb._bbd_layout == torch_sb._SeBbdLayout(**vars(layout))


def _carried(jsys, jmon, k):
    """The JAX package's SeBbdArrays, and the port's from its tables."""
    sb, layout, _, _ = jax_sb.compile_se_bbd(jsys, jmon, k)
    _, _, _, host = jax_acse.compile_se_arrays(jsys, jmon, return_host=True)
    net = {f: np.asarray(getattr(sb.net, f)) for f in sb.net._fields}
    tsb, tlay = se_bbd_arrays_from_numpy(
        base=host, net=net, device="cpu",
        **{f: np.asarray(getattr(sb, f)) for f in ROUTING})
    return sb, layout, tsb, tlay


def _jax_blocks(sb, lay, vm, va):
    """The per-block W½H of the JAX package's ``_gains_block``
    (acse_bbd.py:286-295) in f64: h_entries times the row status, masked,
    times √w, scattered into [k, mr, 2ni | 2lb]; and h."""
    arr = sb.base
    vals, h = jax_acse.h_entries(arr, sb.net, vm, va)
    vals = np.asarray(vals * arr.status[sb.ent_rows])
    sqw = np.sqrt(np.asarray(arr.w))
    rows = np.asarray(sb.ent_rows)
    mask_lb = np.append(np.asarray(sb.mask_bdr), 0.0)[np.asarray(sb.lb_gidx)]
    out = np.zeros((lay.k, lay.mr, 2 * lay.ni + 2 * lay.lb))
    for pre, mask, col0 in (("hi", np.asarray(sb.mask_int), 0),
                            ("hb", mask_lb, 2 * lay.ni)):
        sel, blk, row, col = (np.asarray(getattr(sb, f"{pre}_{x}"))
                              for x in ("sel", "blk", "row", "col"))
        np.add.at(out, (blk, row, col0 + col),
                  vals[sel] * mask[blk, col] * sqw[rows[sel]])
    return out, np.asarray(h)


@pytest.mark.parametrize("case,k,every", [("case14test.m", 2, 5),
                                          ("case118.m", 4, 10)])
def test_routed_twin_matches_gains_block(data_path, case, k, every):
    """K3's routed plain version at random states: the per-block H, h and
    the residuals."""
    (jsys, jmon), _ = _both(data_path, case, every)
    sb, lay, tsb, tlay = _carried(jsys, jmon, k)
    n = jsys.bus.number
    rng = np.random.default_rng(11)
    vm = 1.0 + 0.05 * rng.standard_normal(n)
    va = 0.2 * rng.standard_normal(n)
    want, h = _jax_blocks(sb, lay, jnp.asarray(vm), jnp.asarray(va))
    res = k3.se_fill_routed(tsb.base, tsb.net, tsb.route, torch.tensor(vm),
                            torch.tensor(va), tsb.base.w.sqrt())
    np.testing.assert_allclose(res.jac.numpy(), want, rtol=0, atol=K3_TOL)
    np.testing.assert_allclose(res.h.numpy(), h, rtol=0, atol=K3_TOL)
    np.testing.assert_allclose(res.r.numpy(), np.asarray(sb.base.mean) - h,
                               rtol=0, atol=K3_TOL)
    part = k3.se_fill_routed(tsb.base, tsb.net, tsb.route, torch.tensor(vm),
                             torch.tensor(va), tsb.base.w.sqrt(), 1, k)
    assert torch.equal(part.jac, res.jac[1:])
    with pytest.raises(ValueError, match="outside"):
        k3.se_fill_routed(tsb.base, tsb.net, tsb.route, torch.tensor(vm),
                          torch.tensor(va), tsb.base.w.sqrt(), 2, k + 1)


@pytest.mark.parametrize("case,k,every", [("case14test.m", 2, 5),
                                          ("case118.m", 4, 10)])
def test_routed_slot_rows_invert_the_row_map(data_path, case, k, every):
    """K3's routed mode gives a warp to each (block, slot) row: the
    host-built inverse names every measurement row on exactly one slot,
    the slot of its block that the row map gives it, and -1 on the pad
    slots, as the JAX package's rows_idx and row_mask say."""
    (jsys, jmon), _ = _both(data_path, case, every)
    sb, lay, tsb, tlay = _carried(jsys, jmon, k)
    route = tsb.route
    slot_row = route.slot_row.numpy()
    assert route.slot_row.dtype == torch.int32
    assert slot_row.shape == (tlay.k * tlay.mr,)
    m = tsb.base.mean.numel()
    real = slot_row[slot_row >= 0]
    assert np.array_equal(np.sort(real), np.arange(m))
    flat = route.row_block.numpy().astype(np.int64) * tlay.mr \
        + route.row_slot.numpy()
    assert np.array_equal(slot_row[flat], np.arange(m))
    want = np.where(np.asarray(sb.row_mask) != 0, np.asarray(sb.rows_idx),
                    -1).ravel()
    assert np.array_equal(slot_row, want)
    with pytest.raises(ValueError, match="slot of its own"):
        k3.slot_rows(np.zeros(2, dtype=np.int64), np.zeros(2, dtype=np.int64),
                     tlay.k, tlay.mr)


def test_se_bbd_matches_jax_and_dense_118(data_path):
    """test_se_bbd_matches_dense_118: the dense path's and the JAX BBD's
    iteration count, states within 1e-10 of both; and the port's loop on
    the JAX package's own tables, in chunks of one block, equal too."""
    (jsys, jmon), (tsys, tmon) = _both(data_path, "case118.m", 10)
    dense = jgt.gauss_newton(tmon, device="cpu")
    jgt.state_estimation(dense)
    bb = jgt.estimation.gauss_newton_bbd(tmon, n_blocks=4, device="cpu")
    jgt.estimation.se_bbd_solve(bb)
    jbb = jax_sb.gauss_newton_bbd(jmon, n_blocks=4)
    jax_sb.se_bbd_solve(jbb)
    assert bb.method.converged
    assert (bb.method.iteration == dense.method.iteration
            == jbb.method.iteration)
    for other in (dense, jbb):
        np.testing.assert_allclose(bb.voltage.magnitude,
                                   other.voltage.magnitude, rtol=0,
                                   atol=STATE_TOL)
        np.testing.assert_allclose(bb.voltage.angle, other.voltage.angle,
                                   rtol=0, atol=STATE_TOL)

    _, _, tsb, tlay = _carried(jsys, jmon, 4)
    n = tsys.bus.number
    start = [torch.tensor(x.array[:n].copy())
             for x in (tsys.bus.voltage.magnitude, tsys.bus.voltage.angle)]
    vm, va, it, _, conv = torch_sb._se_bbd_solve(tsb, tlay, *start, 1e-8,
                                                 40, chunk=1)
    assert conv and it == jbb.method.iteration
    np.testing.assert_allclose(vm.numpy(), jbb.voltage.magnitude, rtol=0,
                               atol=STATE_TOL)
    np.testing.assert_allclose(va.numpy(), jbb.voltage.angle, rtol=0,
                               atol=STATE_TOL)


def test_se_bbd_staleness_refresh(data_path):
    """test_se_bbd_staleness_refresh: a system edit after construction
    rebuilds the BBD snapshot."""
    (jsys, jmon), (tsys, tmon) = _both(data_path, "case14test.m", 5)
    bb = jgt.estimation.gauss_newton_bbd(tmon, n_blocks=2, device="cpu")
    jgt.estimation.se_bbd_solve(bb)
    before = bb.voltage.magnitude.copy()

    update_branch(tsys, 4, status=0)
    n = tsys.bus.number
    bb.voltage.magnitude = tsys.bus.voltage.magnitude.array[:n].copy()
    bb.voltage.angle = tsys.bus.voltage.angle.array[:n].copy()
    jgt.estimation.se_bbd_solve(bb)
    fresh = jgt.estimation.gauss_newton_bbd(tmon, n_blocks=2, device="cpu")
    jgt.estimation.se_bbd_solve(fresh)
    np.testing.assert_allclose(bb.voltage.magnitude,
                               fresh.voltage.magnitude, rtol=0,
                               atol=STATE_TOL)
    assert not np.allclose(bb.voltage.magnitude, before, atol=1e-12)

    jbb = jax_sb.gauss_newton_bbd(jmon, n_blocks=2)
    jax_update_branch(jsys, 4, status=0)
    jax_sb.se_bbd_solve(jbb)
    assert bb.method.iteration == jbb.method.iteration
    np.testing.assert_allclose(bb.voltage.magnitude, jbb.voltage.magnitude,
                               rtol=0, atol=STATE_TOL)


def test_se_bbd_correlated_raises(data_path):
    """test_se_bbd_correlated_raises: correlated PMU pairs are refused."""
    system, mon = _scada_pmu(jgt, str(data_path / "case14test.m"), 10,
                             device="cpu")
    pf = jgt.newton_raphson(system, device="cpu")
    jgt.power_flow(pf)
    jgt.add_pmu(mon, bus=system.bus.label.label(2),
                magnitude=float(pf.voltage.magnitude[2]),
                angle=float(pf.voltage.angle[2]), correlated=True,
                noise=False)
    with pytest.raises(MethodError_, match="non-diagonal precision"):
        jgt.estimation.gauss_newton_bbd(mon, n_blocks=2, device="cpu")
    assert issubclass(MethodError_, ValueError)
