"""K3 ``se_fill``: its plain PyTorch version against the JAX package's
``h_entries``/``build_h`` (and ``gn_increment``'s masks) on identical
measurement sets carried across with ``se_arrays_from_numpy``; the
descriptor table and its class order, the wrapper's CPU dispatch, input
checks and build. The CUDA kernel itself is held to the plain version on
the card by ``chip_smoke.py``.

Tolerance: 1e-12 relative to max(1, |value|) — the same arithmetic in
another summation order (the injection rows' segment sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
from juliagrid_tpu.estimation import acse as jax_acse
from juliagrid_tpu.powerflow import ac as jax_ac
from juliagrid_tpu_torch.convert import (ac_arrays_from_numpy,
                                         se_arrays_from_numpy)
from juliagrid_tpu_torch.estimation import acse as torch_acse
from juliagrid_tpu_torch.kernels import _build
from juliagrid_tpu_torch.kernels.se_fill import (row_classes, se_fill,
                                                 se_fill_ref, se_fill_table)

TOL = dict(rtol=1e-12, atol=1e-12)
ALL_TYPES = set(range(1, 22))


def every_row_type(pkg, system, pf):
    """A measurement set holding all 21 row types, correlated PMU pairs
    and two inactive rows, built through ``pkg``'s public API from the
    solved power flow ``pf`` (power and currents post-processed)."""
    mon = pkg.measurement(system)
    pkg.add_voltmeter(mon, analysis=pf)                            # 1
    pkg.add_ammeter(mon, analysis=pf)                              # 2, 3
    pkg.add_ammeter(mon, analysis=pf, square=True)                 # 4, 5
    pkg.add_wattmeter(mon, analysis=pf)                            # 6, 7, 8
    pkg.add_varmeter(mon, analysis=pf)                             # 9-11
    pkg.add_pmu(mon, analysis=pf, polar=True)                      # 12-15
    pkg.add_pmu(mon, analysis=pf, polar=True, square=True,
                status_bus=-1)                                     # 4, 5
    pkg.add_pmu(mon, analysis=pf)                                  # 16-21
    pkg.add_pmu(mon, analysis=pf, correlated=True, status_from=-1)
    pkg.update_voltmeter(mon, mon.voltmeter.label.label(3), status=0)
    pkg.update_wattmeter(mon, mon.wattmeter.label.label(5), status=0)
    return mon


@pytest.fixture(scope="module")
def carried(data_path):
    """case14test (three phase-shifting transformers) with every row type,
    compiled by the JAX package and carried into the port."""
    system = jg.power_system(str(data_path / "case14test.m"))
    pf = jg.newton_raphson(system)
    jg.power_flow(pf, power=True, current=True)
    mon = every_row_type(jg, system, pf)
    jarr, types, _, host = jax_acse.compile_se_arrays(system, mon,
                                                      return_host=True)
    jnet = jax_ac.compile_ac_arrays(system)
    tarr = se_arrays_from_numpy(host, "cpu")
    tnet = ac_arrays_from_numpy(
        **{f: np.asarray(getattr(jnet, f)) for f in jnet._fields},
        device="cpu")
    return dict(jarr=jarr, jnet=jnet, tarr=tarr, tnet=tnet, types=types,
                host=host, vm=np.asarray(pf.voltage.magnitude),
                va=np.asarray(pf.voltage.angle))


def _states(c, batch, seed):
    """Random states around the power-flow state, from a numpy seed."""
    rng = np.random.default_rng(seed)
    n = len(c["vm"])
    vm = c["vm"] + 0.02 * rng.standard_normal((batch, n))
    va = c["va"] + 0.05 * rng.standard_normal((batch, n))
    return vm, va


def test_set_covers_every_row_type_and_a_phase_shifter(carried):
    assert set(carried["types"].tolist()) == ALL_TYPES
    assert carried["host"].pair_r1.size > 0
    assert np.any(carried["host"].status == 0)
    # to-side phasor rows (which shift theta_i) on phase-shifting
    # transformers
    for code, grp in zip((15, 19, 21), (carried["host"].branch[9],
                                        carried["host"].branch[11],
                                        carried["host"].branch[13])):
        assert np.any(grp.phi != 0), code


@pytest.mark.parametrize("mask_slack", [False, True])
def test_se_fill_ref_matches_jax_build_h(carried, mask_slack):
    """B = 1: H (unmasked as build_h gives it, or with the slack column
    masked as gn_increment uses it), h and r."""
    c = carried
    vm, va = _states(c, 1, seed=3)
    H, h = jax_acse.build_h(c["jarr"], c["jnet"], jnp.asarray(vm[0]),
                            jnp.asarray(va[0]))
    H = np.array(H)
    if mask_slack:
        H[:, int(c["jarr"].slack)] = 0.0
    got = se_fill_ref(c["tarr"], c["tnet"], torch.from_numpy(vm),
                      torch.from_numpy(va), c["tarr"].mean[None],
                      mask_slack=mask_slack)
    np.testing.assert_allclose(got.jac[0].numpy(), H, **TOL)
    np.testing.assert_allclose(got.h[0].numpy(), np.asarray(h), **TOL)
    np.testing.assert_allclose(got.r[0].numpy(),
                               np.asarray(c["jarr"].mean) - np.asarray(h),
                               **TOL)
    assert np.array_equal(got.jac[0].numpy() != 0, H != 0)


def test_se_fill_ref_matches_vmapped_jax(carried):
    """B = 8 scenarios with their own states and means."""
    c = carried
    vm, va = _states(c, 8, seed=5)
    rng = np.random.default_rng(6)
    means = (np.asarray(c["jarr"].mean)[None]
             + 0.01 * rng.standard_normal((8, len(c["types"]))))
    H, h = jax.vmap(lambda x, y: jax_acse.build_h(c["jarr"], c["jnet"], x,
                                                  y))(jnp.asarray(vm),
                                                      jnp.asarray(va))
    got = se_fill_ref(c["tarr"], c["tnet"], torch.from_numpy(vm),
                      torch.from_numpy(va), torch.from_numpy(means),
                      mask_slack=False)
    np.testing.assert_allclose(got.jac.numpy(), np.asarray(H), **TOL)
    np.testing.assert_allclose(got.h.numpy(), np.asarray(h), **TOL)
    np.testing.assert_allclose(got.r.numpy(), means - np.asarray(h), **TOL)


def test_h_entries_match_jax_in_pattern_order(carried):
    c = carried
    vm, va = _states(c, 1, seed=7)
    jvals, jh = jax_acse.h_entries(c["jarr"], c["jnet"], jnp.asarray(vm[0]),
                                   jnp.asarray(va[0]))
    tvals, th = torch_acse.h_entries(c["tarr"], c["tnet"],
                                     torch.from_numpy(vm[0]),
                                     torch.from_numpy(va[0]))
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    n = len(c["vm"])
    jrows, jcols = jax_acse.h_entry_pattern(c["host"], c["jnet"], n, xp=np)
    trows, tcols = torch_acse.h_entry_pattern(c["tarr"], c["tnet"], n)
    assert np.array_equal(trows.numpy(), jrows)
    assert np.array_equal(tcols.numpy(), jcols)


def test_weighting_matches_jax(carried):
    """W (diagonal plus the correlated 2x2 blocks) applied to H and r."""
    c = carried
    vm, va = _states(c, 1, seed=9)
    H, h = jax_acse.build_h(c["jarr"], c["jnet"], jnp.asarray(vm[0]),
                            jnp.asarray(va[0]))
    r = c["jarr"].mean - h
    jwh, jwr = jax_acse._weighted(c["jarr"], H, r)
    twh, twr = torch_acse._weighted(c["tarr"], torch.tensor(np.asarray(H)),
                                    torch.tensor(np.asarray(r)))
    np.testing.assert_allclose(twh.numpy(), np.asarray(jwh), **TOL)
    np.testing.assert_allclose(twr.numpy(), np.asarray(jwr), **TOL)


def test_descriptor_table_follows_the_row_types(carried):
    c = carried
    idx, coef = se_fill_table(c["host"])
    types = c["types"].astype(np.int32)
    assert np.array_equal(idx[0], np.where(types == 12, 1, types))
    assert np.array_equal(c["tarr"].desc.idx.numpy(), idx)
    assert np.array_equal(c["tarr"].desc.coef.numpy(), coef)
    for grp in c["host"].branch:
        assert np.array_equal(idx[1, grp.rows], grp.f)
        assert np.array_equal(idx[2, grp.rows], grp.t)
        assert np.array_equal(coef[:, grp.rows],
                              np.stack([grp.a, grp.b, grp.c, grp.d, grp.phi]))
    bus_rows = np.concatenate([c["host"].vm_rows, c["host"].p_rows])
    assert np.all(idx[2, bus_rows] == -1)


def test_row_classes_are_a_bijection_that_keeps_rows(carried):
    """Without the Jacobian K3 gives a thread to each closed-form row and a
    warp to each injection row, taking rows from the class order: a
    permutation with every closed-form row first, each class ascending,
    and each unit writing h and r at its own row index, so the values come
    out where the row-ordered launch puts them."""
    c = carried
    idx, _ = se_fill_table(c["host"])
    order, closed = row_classes(idx)
    m = idx.shape[1]
    assert order.dtype == np.int32
    assert np.array_equal(np.sort(order), np.arange(m))
    inj = np.isin(idx[0], (6, 9))
    assert closed == np.count_nonzero(~inj) and 0 < closed < m
    assert not inj[order[:closed]].any() and inj[order[closed:]].all()
    assert np.all(np.diff(order[:closed]) > 0)
    assert np.all(np.diff(order[closed:]) > 0)
    assert np.array_equal(c["tarr"].desc.order.numpy(), order)
    assert c["tarr"].desc.closed == closed
    # the units in class order, each writing its own row
    vm, va = (torch.from_numpy(x) for x in _states(c, 2, seed=4))
    mean = c["tarr"].mean.expand(2, -1)
    ref = se_fill_ref(c["tarr"], c["tnet"], vm, va, mean, jacobian=False)
    h, r = torch.full_like(ref.h, np.nan), torch.full_like(ref.r, np.nan)
    rows = torch.from_numpy(order).long()
    h[:, rows], r[:, rows] = ref.h[:, rows], ref.r[:, rows]
    assert torch.equal(h, ref.h) and torch.equal(r, ref.r)


def test_descriptor_table_refuses_a_row_with_two_writers(carried):
    """K3 writes each H element once: a branch row joining a bus to itself,
    or a row in two groups, is refused on the host."""
    host = carried["host"]
    grp = host.branch[4]                                   # P_ij rows
    loop = grp._replace(t=grp.f.copy())
    branch = host.branch[:4] + (loop,) + host.branch[5:]
    with pytest.raises(ValueError, match="itself"):
        se_fill_table(host._replace(branch=branch))
    twice = host._replace(va_rows=np.append(host.va_rows, host.vm_rows[0]),
                          va_bus=np.append(host.va_bus, host.vm_bus[0]))
    with pytest.raises(ValueError, match="exactly one"):
        se_fill_table(twice)


def test_cpu_tensors_take_the_plain_version(carried):
    """A CPU tensor goes to se_fill_ref and launches no kernel; without the
    Jacobian flag no Jacobian is formed."""
    c = carried
    vm, va = (torch.from_numpy(x) for x in _states(c, 2, seed=1))
    mean = c["tarr"].mean.expand(2, -1)
    before = se_fill.launches
    got = se_fill(c["tarr"], c["tnet"], vm, va, mean)
    assert se_fill.launches == before
    ref = se_fill_ref(c["tarr"], c["tnet"], vm, va, mean)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    lean = se_fill(c["tarr"], c["tnet"], vm, va, mean, jacobian=False)
    assert lean.jac is None
    assert torch.equal(lean.r, ref.r)


def test_se_fill_rejects_bad_inputs(carried):
    c = carried
    m = len(c["types"])
    x = torch.ones((2, 14), dtype=torch.float64)
    mean = torch.zeros((2, m), dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        se_fill(c["tarr"], c["tnet"], x.float(), x, mean)
    with pytest.raises(ValueError, match="shape"):
        se_fill(c["tarr"], c["tnet"], x[:, :13], x, mean)
    with pytest.raises(ValueError, match="shape"):
        se_fill(c["tarr"], c["tnet"], x, x, mean[:1])
    with pytest.raises(ValueError, match="shape"):
        se_fill(c["tarr"], c["tnet"], x, x, mean[:, :-1])


def test_k3_build_raises_without_nvcc(monkeypatch, tmp_path):
    """K3 builds like K1, for sm_90a; without the CUDA toolkit the build
    raises instead of handing the call to the plain version."""
    assert _build.library_path("se_fill").parent == _build.BUILD_DIR
    assert (_build.CSRC / "se_fill.cu").is_file()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("se_fill")
    assert not (tmp_path / "build").exists()
