"""K4 ``gs_sweep``: its plain PyTorch version against the JAX package's
``_gs_sweep``, ``_gs_mismatch`` and ``_gs_solve`` on identical network
state carried across with ``gs_arrays_from_numpy``; the level schedule K4
walks; the wrapper's CPU dispatch, input checks, cluster layout and build.
The CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py`` (phases 8-9)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
from juliagrid_tpu.powerflow import gauss_seidel as jax_gs
from juliagrid_tpu.system import builders as jax_builders
from juliagrid_tpu.system import load as jax_load
from juliagrid_tpu.utils.synthetic import synthetic_grid
from juliagrid_tpu_torch.convert import gs_arrays_from_numpy
from juliagrid_tpu_torch.kernels import _build
from juliagrid_tpu_torch.kernels.gs_sweep import (MAX_CLUSTER, _cdiv,
                                                  cluster_layout, gs_sweep,
                                                  gs_sweep_ref)
from juliagrid_tpu_torch.powerflow import gauss_seidel as torch_gs
from juliagrid_tpu_torch.powerflow.ac import ac_entry_host
from juliagrid_tpu_torch.system import builders as torch_builders
from juliagrid_tpu_torch.system import load as torch_load

# |port - JAX| <= 1e-12 max(1, |JAX|): the row current sums its terms in
# another order than XLA does
TOL = dict(rtol=1e-12, atol=1e-12)
# the level-by-level sweep against the bus-by-bus one: the same arithmetic
# per bus, a row current summed along a batch of rows instead of alone
LEVEL_TOL = dict(rtol=1e-14, atol=1e-14)

#: PQ levels, PV levels and the widest level of each grid (buses of a
#: level are never adjacent in the Y pattern; case14test's out-of-service
#: branches 2-3 and 10-11 keep zero entries in it, which order their ends
#: too, so that no two buses of a level touch one voltage)
LEVELS = {"case14test": (5, 2, 3), "case30test": (12, 2, 4),
          "case118": (5, 10, 33), "case300": (17, 3, 60),
          "synthetic_37x37": (72, 14, 212)}


def _hub_grid(load, builders, leaves=150, seed=5):
    """A slack, a PQ hub tied to it and to ``leaves`` buses on a ring
    (every 7th a PV bus): the hub's Y row has leaves + 2 entries."""
    rng = np.random.default_rng(seed)
    system = load.power_system()
    builders.add_bus(system, label=1, type=3, magnitude=1.0, angle=0.0)
    builders.add_bus(system, label=2, type=1, active=0.02, reactive=0.01)
    for k in range(leaves):
        pv = k % 7 == 3
        builders.add_bus(system, label=k + 3, type=2 if pv else 1,
                         active=0.0 if pv else float(rng.uniform(0.002, 0.01)),
                         reactive=0.0 if pv else float(
                             rng.uniform(0.0005, 0.003)))
    builders.add_branch(system, from_bus=1, to_bus=2, resistance=0.001,
                        reactance=0.01)
    for k in range(leaves):
        builders.add_branch(system, from_bus=2, to_bus=k + 3,
                            resistance=float(rng.uniform(0.01, 0.03)),
                            reactance=float(rng.uniform(0.05, 0.15)),
                            susceptance=0.01)
        builders.add_branch(system, from_bus=k + 3,
                            to_bus=(k + 1) % leaves + 3,
                            resistance=float(rng.uniform(0.02, 0.05)),
                            reactance=float(rng.uniform(0.1, 0.2)))
    builders.add_generator(system, bus=1, active=0.5, magnitude=1.0)
    for k in range(3, leaves, 7):
        builders.add_generator(system, bus=k + 3, active=0.01,
                               magnitude=1.01)
    return system


def _carried(data_path, case):
    """The JAX package's GsArrays and the same fields on the port (CPU)."""
    if case.startswith("synthetic_"):
        rows, cols = (int(x) for x in case.split("_")[1].split("x"))
        system = synthetic_grid(rows, cols)
    elif case == "hub":
        system = _hub_grid(jax_load, jax_builders)
    else:
        system = jg.power_system(str(data_path / f"{case}.m"))
    jarr = jax_gs.compile_gs_arrays(system)
    tarr = gs_arrays_from_numpy(
        **{f: np.asarray(getattr(jarr, f)) for f in jarr._fields},
        device="cpu")
    return jarr, tarr


def _state(n, seed):
    """A state around the flat start, from a seed."""
    rng = np.random.default_rng(seed)
    vm = 1.0 + 0.05 * rng.standard_normal(n)
    va = 0.1 * rng.standard_normal(n)
    return vm * np.cos(va), vm * np.sin(va)


def _levels(order, ptr):
    """Each listed bus's level, as a dict."""
    order, ptr = order.tolist(), ptr.tolist()
    return {bus: lv for lv in range(len(ptr) - 1)
            for bus in order[ptr[lv]:ptr[lv + 1]]}


def _level_sweep(arr, vre, vim):
    """One sweep level by level: the buses of a level updated together,
    each with the arithmetic of ``gs_sweep_ref``."""
    vre, vim = vre.clone(), vim.clone()
    for order, ptr, pv in ((arr.pq_order, arr.pq_ptr, False),
                           (arr.pv_order, arr.pv_ptr, True)):
        ptr = ptr.tolist()
        for a, b in zip(ptr[:-1], ptr[1:]):
            bus = order[a:b].long()
            nb = arr.nb[bus].long()
            yr, yi = arr.yre[bus], arr.yim[bus]
            vr, vi = vre[nb], vim[nb]
            ire = torch.sum(yr * vr - yi * vi, dim=1)
            iim = torch.sum(yr * vi + yi * vr, dim=1)
            if pv:
                q = vre[bus] * iim - vim[bus] * ire
                cr, ci = _cdiv(arr.p_sched[bus], q, vre[bus], -vim[bus])
            else:
                cr, ci = _cdiv(arr.p_sched[bus], -arr.q_sched[bus],
                               vre[bus], -vim[bus])
            dr, di = _cdiv(cr - ire, ci - iim, arr.dre[bus], arr.dim[bus])
            vre[bus] += dr
            vim[bus] += di
    mag = torch.sqrt(vre**2 + vim**2)
    scale = torch.where(arr.bus_type == 2, arr.vg / mag, 1.0)
    return vre * scale, vim * scale


@pytest.mark.parametrize("case", ["case14test", "case30test", "case118",
                                  "synthetic_10x10"])
def test_gs_sweep_ref_matches_jax(data_path, case):
    """One sweep and the mismatch at its result, and the mismatch alone at
    the start, from a random state."""
    jarr, tarr = _carried(data_path, case)
    n = tarr.bus_type.numel()
    vre, vim = _state(n, seed=3)
    want_re, want_im = jax_gs._gs_sweep_jit(jarr, jnp.asarray(vre),
                                            jnp.asarray(vim))
    want_mis = jax_gs._gs_mismatch_jit(jarr, want_re, want_im)
    got = gs_sweep_ref(tarr, torch.from_numpy(vre), torch.from_numpy(vim))
    np.testing.assert_allclose(got.vre.numpy(), np.asarray(want_re), **TOL)
    np.testing.assert_allclose(got.vim.numpy(), np.asarray(want_im), **TOL)
    np.testing.assert_allclose(got.mismatch.numpy(),
                               np.asarray(want_mis), **TOL)

    start = gs_sweep_ref(tarr, torch.from_numpy(vre), torch.from_numpy(vim),
                         max_sweeps=0)
    assert np.array_equal(start.vre.numpy(), vre)
    np.testing.assert_allclose(
        start.mismatch.numpy(),
        np.asarray(jax_gs._gs_mismatch_jit(jarr, jnp.asarray(vre),
                                           jnp.asarray(vim))), **TOL)


def test_bus_lists_are_the_passes(data_path):
    """The plain version walks the PQ buses, then the PV buses, each in
    ascending order; the slack is in neither list."""
    _, tarr = _carried(data_path, "case118")
    types = tarr.bus_type.numpy()
    assert np.array_equal(tarr.pq.numpy(), np.flatnonzero(types == 1))
    assert np.array_equal(tarr.pv.numpy(), np.flatnonzero(types == 2))
    assert tarr.slack not in set(tarr.pq.tolist() + tarr.pv.tolist())
    assert tarr.nb.shape == (118, 10)


@pytest.mark.parametrize("case", sorted(LEVELS))
def test_level_tables(data_path, case):
    """Every PQ and PV bus sits at exactly one level, each same-type
    neighbour pair j < i of the Y pattern (the padding left out) at levels
    level(j) < level(i), and the level counts are the grid's. The port's
    own build gives the tables carried from the JAX package, and the row
    counts read off the padded table are the pattern's."""
    _, tarr = _carried(data_path, case)
    types = tarr.bus_type.numpy()
    nb = tarr.nb.numpy()
    counts = torch_gs.row_counts(nb)
    rows, pos = np.nonzero(np.arange(nb.shape[1]) < counts[:, None])
    pairs = list(zip(rows.tolist(), nb[rows, pos].tolist()))
    assert all(len(set(nb[i, :c])) == c for i, c in enumerate(counts))
    for kind, order, ptr in ((1, tarr.pq_order, tarr.pq_ptr),
                             (2, tarr.pv_order, tarr.pv_ptr)):
        assert sorted(order.tolist()) == np.flatnonzero(types == kind).tolist()
        assert ptr[0] == 0 and ptr[-1] == order.numel()
        assert torch.all(ptr[1:] > ptr[:-1])
        level = _levels(order, ptr)
        for i, j in pairs:
            if j < i and types[i] == kind and types[j] == kind:
                assert level[j] < level[i], (kind, i, j)
    widest = max(np.diff(tarr.pq_ptr.numpy()).max(),
                 np.diff(tarr.pv_ptr.numpy()).max())
    assert (tarr.pq_ptr.numel() - 1, tarr.pv_ptr.numel() - 1,
            widest) == LEVELS[case]
    assert tarr.widest == widest
    if not case.startswith("synthetic_"):
        system = torch_load.power_system(str(data_path / f"{case}.m"))
        own = torch_gs.compile_gs_arrays(system, "cpu")
        for name in ("pq_order", "pq_ptr", "pv_order", "pv_ptr"):
            assert torch.equal(getattr(own, name), getattr(tarr, name))
        entry_rows = ac_entry_host(system)[0]
        assert np.array_equal(counts, np.bincount(entry_rows,
                                                  minlength=len(types)))


@pytest.mark.parametrize("case", ["case118", "synthetic_37x37"])
def test_level_order_sweep_matches(data_path, case):
    """A sweep level by level equals the bus-by-bus plain version, and the
    JAX package's sequential ``_gs_sweep``."""
    jarr, tarr = _carried(data_path, case)
    vre, vim = _state(tarr.bus_type.numel(), seed=4)
    got = _level_sweep(tarr, torch.from_numpy(vre), torch.from_numpy(vim))
    ref = gs_sweep_ref(tarr, torch.from_numpy(vre), torch.from_numpy(vim))
    want = jax_gs._gs_sweep_jit(jarr, jnp.asarray(vre), jnp.asarray(vim))
    for g, r, w in zip(got, ref[:2], want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **LEVEL_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("case", ["case14test", "case30test"])
def test_sweep_loop_equals_repeated_sweeps(data_path, case):
    """k sweeps in one call of the plain version equal k one-sweep calls
    bit for bit; ``max_sweeps=0`` is the mismatch alone."""
    _, tarr = _carried(data_path, case)
    vre, vim = (torch.from_numpy(x)
                for x in _state(tarr.bus_type.numel(), seed=5))
    k = 4
    once = gs_sweep_ref(tarr, vre, vim, max_sweeps=k)
    step = gs_sweep_ref(tarr, vre, vim, max_sweeps=0)
    assert step.info[2:].tolist() == [0.0, 0.0]
    for _ in range(k):
        step = gs_sweep_ref(tarr, step.vre, step.vim, max_sweeps=1)
        assert step.info[2:].tolist() == [1.0, 0.0]
    assert torch.equal(once.vre, step.vre) and torch.equal(once.vim,
                                                          step.vim)
    assert torch.equal(once.mismatch, step.mismatch)
    assert once.info[2:].tolist() == [float(k), 0.0]


@pytest.mark.parametrize("max_iter", [1000, 100])
def test_sweep_loop_stops_as_jax(data_path, max_iter):
    """``_gs_solve`` (one call of the plain version) on case14test: 281
    sweeps to 1e-8 as the JAX package's while loop, or stopped at the cap
    unconverged, with the JAX package's mismatch pair and state."""
    path = str(data_path / "case14test.m")
    jpf = jg.gauss_seidel(jg.power_system(path))
    tpf = torch_gs.gauss_seidel(torch_load.power_system(path), device="cpu")
    vm, va = tpf._state()
    got = torch_gs._gs_solve(tpf.arrays, vm, va, 1e-8, max_iter)
    want = jax_gs._gs_solve(jpf.arrays, jnp.asarray(jpf.voltage.magnitude),
                            jnp.asarray(jpf.voltage.angle), 1e-8, max_iter)
    assert got[2] == int(want[2]) == min(281, max_iter)
    assert got[5] == bool(want[5]) == (max_iter > 281)
    # a maximum of |P - P_sched|, where P ~ 1 is summed in another order:
    # a few ulps of 1 apart
    np.testing.assert_allclose(got[3:5], [float(want[3]), float(want[4])],
                               rtol=1e-9, atol=1e-13)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-10)


def test_nan_never_converges(data_path):
    """A NaN state runs to the cap and is not converged, as in jnp."""
    _, tarr = _carried(data_path, "case14test")
    vre = torch.full((14,), float("nan"), dtype=torch.float64)
    got = gs_sweep_ref(tarr, vre, vre.clone(), max_sweeps=3, tol=1e-8)
    assert torch.isnan(got.mismatch).all()
    assert got.info[2:].tolist() == [3.0, 0.0]


def test_wide_rows_match_jax(data_path):
    """A hub bus with a Y row of 152 entries, built the same way in both
    packages: equal ``GsArrays``, and one plain sweep as the JAX
    package's."""
    jarr, tarr = _carried(data_path, "hub")
    own = torch_gs.compile_gs_arrays(
        _hub_grid(torch_load, torch_builders), "cpu")
    assert own.nb.shape == tarr.nb.shape and own.nb.shape[1] == 152
    for name in tarr._fields:
        a, b = getattr(own, name), getattr(tarr, name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), name
    vre, vim = _state(152, seed=6)
    got = gs_sweep_ref(tarr, torch.from_numpy(vre), torch.from_numpy(vim))
    want = jax_gs._gs_sweep_jit(jarr, jnp.asarray(vre), jnp.asarray(vim))
    np.testing.assert_allclose(got.vre.numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got.vim.numpy(), np.asarray(want[1]), **TOL)
    level = _level_sweep(tarr, torch.from_numpy(vre), torch.from_numpy(vim))
    np.testing.assert_allclose(level[0].numpy(), got.vre.numpy(),
                               **LEVEL_TOL)


#: a block's room on the H100: 227 KB less K4's 304 bytes of static
#: shared memory (``nvcc -Xptxas -v``)
ROOM = 232_448 - 304


@pytest.mark.parametrize("shape, want", [
    ((14, 4, 5), (1, False)),
    ((118, 33, 15), (3, False)),
    ((10_000, 80, 221), (5, False)),
    ((24_964, 3_971, 376), (16, True)),
    ((24_964, 20, 376), (2, True)),
])
def test_cluster_layout(shape, want):
    """(n, widest level, levels) -> (cluster, distributed): a warp for each
    bus of the widest level up to 16 blocks; the voltage replicated while
    16 n bytes and the level offsets fit one block, else split over enough
    blocks to hold it."""
    assert cluster_layout(*shape, ROOM) == want


def test_cluster_layout_overrides_and_cap():
    """The overrides are taken as given; past 16 blocks full of voltage the
    call raises naming the cap."""
    assert cluster_layout(10_000, 80, 221, ROOM, cluster=8,
                          distributed=True) == (8, True)
    assert cluster_layout(118, 33, 15, ROOM, cluster=1) == (1, False)
    cap = MAX_CLUSTER * ((ROOM - 4 * 301) // 16)
    assert cluster_layout(cap, 10, 300, ROOM) == (MAX_CLUSTER, True)
    with pytest.raises(ValueError, match=f"at most {cap} buses"):
        cluster_layout(cap + MAX_CLUSTER, 10, 300, ROOM)
    with pytest.raises(ValueError, match="this grid has 20000"):
        cluster_layout(20_000, 10, 300, ROOM, distributed=False)
    with pytest.raises(ValueError, match="1 to 16 blocks"):
        cluster_layout(100, 10, 30, ROOM, cluster=17)


def test_cpu_tensors_take_the_plain_version(data_path):
    """A CPU tensor goes to gs_sweep_ref and launches no kernel; the input
    state is left as it was."""
    _, tarr = _carried(data_path, "case14test")
    vre, vim = (torch.from_numpy(x) for x in _state(14, seed=1))
    keep = vre.clone()
    before = gs_sweep.launches
    got = gs_sweep(tarr, vre, vim)
    assert gs_sweep.launches == before
    assert torch.equal(vre, keep)
    for a, b in zip(got, gs_sweep_ref(tarr, vre, vim)):
        assert torch.equal(a, b)
    for a, b in zip(gs_sweep(tarr, vre, vim, max_sweeps=3, tol=1e-3),
                    gs_sweep_ref(tarr, vre, vim, max_sweeps=3, tol=1e-3)):
        assert torch.equal(a, b)


def test_gs_sweep_rejects_bad_inputs(data_path):
    _, tarr = _carried(data_path, "case14test")
    x = torch.ones(14, dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        gs_sweep(tarr, x.float(), x)
    with pytest.raises(ValueError, match="shape"):
        gs_sweep(tarr, x[:13], x)
    with pytest.raises(ValueError, match="shape"):
        gs_sweep(tarr, x, x[None])
    with pytest.raises(ValueError, match="max_sweeps"):
        gs_sweep(tarr, x, x, max_sweeps=-1)


def test_build_rounds_as_the_plain_version(monkeypatch, tmp_path):
    """K4 is compiled for sm_90a without fused multiply-add, like K3; without
    the CUDA toolkit the build raises instead of handing the call to the
    plain version."""
    flags = _build.nvcc_flags("gs_sweep")
    assert "arch=compute_90a,code=sm_90a" in " ".join(flags)
    assert "-fmad=false" in flags
    assert (_build.CSRC / "gs_sweep.cu").is_file()
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("gs_sweep")
