"""The port's BBD substrate against the JAX package's: the host
partitioners (copies, bit for bit), the Schur solves (``ops/bbd.py``) on
``tests/test_bbd.py``'s 8x12 DC system, and K5 ``schur_gather``'s plain
version and per-slot lists against the JAX padded scatter-add. The CUDA
kernel itself is held to its plain version on the card by
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.ops import bbd as jax_bbd
from juliagrid_tpu.ops import linalg as jax_linalg
from juliagrid_tpu.ops.partition import nd_partition as jax_nd_partition
from juliagrid_tpu.utils.synthetic import synthetic_grid as jax_grid
from juliagrid_tpu_torch.kernels.schur_gather import (schur_gather,
                                                      schur_gather_lists,
                                                      schur_gather_ref,
                                                      schur_route,
                                                      schur_route_host)
from juliagrid_tpu_torch.ops import bbd as torch_bbd
from juliagrid_tpu_torch.ops import linalg as torch_linalg
from juliagrid_tpu_torch.ops.partition import nd_partition
from juliagrid_tpu_torch.utils.synthetic import synthetic_grid

#: the Schur solves are f64 in both packages' results here (the JAX
#: package's f32 factors are refined to f64 accuracy on this system)
SOLVE_TOL = 1e-12


def _pattern(system, gain=False):
    nodal = system.model.ac.nodal.tocsr()
    pat = sp.csr_matrix((np.ones(nodal.nnz), nodal.indices, nodal.indptr),
                        shape=nodal.shape)
    return (pat @ pat).tocsr() if gain else pat


def _systems(data_path, case):
    if case == "grid10x12":
        return jax_grid(10, 12), synthetic_grid(10, 12)
    path = str(data_path / case)
    return jg.power_system(path), jgt.power_system(path)


@pytest.mark.parametrize("case,k", [("case118.m", 4), ("case30test.m", 3),
                                    ("grid10x12", 4)])
@pytest.mark.parametrize("gain", [False, True])
def test_nd_partition_copy_matches_jax(data_path, case, k, gain):
    """The same blocks and border, bit for bit, on the nodal pattern (NR)
    and its square (SE)."""
    jsys, tsys = _systems(data_path, case)
    jg.ac_model(jsys)
    jgt.ac_model(tsys)
    jblock, jborder = jax_nd_partition(_pattern(jsys, gain), k)
    tblock, tborder = nd_partition(_pattern(tsys, gain), k)
    np.testing.assert_array_equal(tblock, jblock)
    np.testing.assert_array_equal(tborder, jborder)


@pytest.mark.parametrize("case,k", [("case118.m", 4), ("grid10x12", 4)])
def test_bbd_partition_copy_matches_jax(data_path, case, k):
    jsys, tsys = _systems(data_path, case)
    jg.dc_model(jsys)
    jgt.dc_model(tsys)
    jb, jbd = jax_bbd.bbd_partition(jsys.model.dc.nodal.tocsr(), k)
    tb, tbd = torch_bbd.bbd_partition(tsys.model.dc.nodal.tocsr(), k)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tbd, jbd)


@pytest.mark.parametrize("case,k,bound", [("case118.m", 4, 0.25),
                                          ("case1354pegase.h5", 8, 0.12)])
def test_nd_partition_invariants(case, k, bound, data_path):
    """tests/test_se_bbd.py's invariants on the copy: no edge joins two
    interiors, the border is small, every bus is accounted for."""
    system = jgt.power_system(str(data_path / case))
    jgt.ac_model(system)
    pat = _pattern(system)
    block_of, border = nd_partition(pat, k)
    n = pat.shape[0]
    assert len(border) < bound * n
    coo = pat.tocoo()
    bi, bj = block_of[coo.row], block_of[coo.col]
    assert not np.any((bi >= 0) & (bj >= 0) & (bi != bj))
    assert np.all((block_of >= 0) | np.isin(np.arange(n), border))


@pytest.fixture(scope="module")
def dc_system():
    """tests/test_bbd.py's masked DC nodal system of an 8x12 grid and its
    BFS partition into 4 blocks."""
    system = synthetic_grid(8, 12)
    jgt.dc_model(system)
    n = system.bus.number
    b = np.asarray(system.model.dc.nodal.todense())
    m = np.ones(n)
    m[system.bus.layout.slack] = 0.0
    a = m[:, None] * b * m[None, :] + np.diag(1 - m)
    rhs = (system.bus.supply.active.array[:n]
           - system.bus.demand.active.array[:n]) * m
    adj = system.model.dc.nodal.copy()
    adj.eliminate_zeros()
    block_of, border = torch_bbd.bbd_partition(adj, 4)
    return a, rhs, block_of, border


def _jax_arrays(a, block_of, border):
    return jax_bbd.build_bbd_arrays(a, block_of, border)


def test_build_bbd_arrays_matches_jax(dc_system):
    a, _, block_of, border = dc_system
    got = torch_bbd.build_bbd_arrays(a, block_of, border, "cpu")
    want = _jax_arrays(a, block_of, border)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    sparse = torch_bbd.build_bbd_arrays(sp.csr_matrix(a), block_of, border,
                                        "cpu")
    for name in got._fields:
        assert torch.equal(getattr(sparse, name), getattr(got, name))


def test_bbd_solve_and_matvec(dc_system):
    a, rhs, block_of, border = dc_system
    arr = torch_bbd.build_bbd_arrays(a, block_of, border, "cpu")
    x = torch_bbd.bbd_solve(arr, torch.tensor(rhs)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(a, rhs), rtol=0,
                               atol=SOLVE_TOL)
    x_jax = np.asarray(jax_bbd.bbd_solve(_jax_arrays(a, block_of, border),
                                         jnp.asarray(rhs)))
    np.testing.assert_allclose(x, x_jax, rtol=0, atol=SOLVE_TOL)
    v = np.random.default_rng(4).standard_normal(len(rhs))
    np.testing.assert_allclose(
        torch_bbd.bbd_matvec(arr, torch.tensor(v)).numpy(), a @ v,
        rtol=0, atol=SOLVE_TOL)


def test_bbd_presolved_solve(dc_system):
    a, rhs, block_of, border = dc_system
    factors = torch_bbd.bbd_precompute(
        torch_bbd.build_bbd_arrays(sp.csr_matrix(a), block_of, border,
                                   "cpu"))
    x = torch_bbd.bbd_presolved_solve(factors, torch.tensor(rhs)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(a, rhs), rtol=0,
                               atol=SOLVE_TOL)
    x_jax = np.asarray(jax_bbd.bbd_presolved_solve(
        jax_bbd.bbd_precompute(_jax_arrays(a, block_of, border)),
        jnp.asarray(rhs)))
    np.testing.assert_allclose(x, x_jax, rtol=0, atol=SOLVE_TOL)


def _local_layout(arr):
    """The locality-compressed layout of a BbdArrays (numpy): each block
    keeps the border columns its couplings touch."""
    a_ib, a_bi = np.asarray(arr.a_ib), np.asarray(arr.a_bi)
    k, ni, mb = a_ib.shape
    touched = [np.flatnonzero(np.any(a_ib[b] != 0, axis=0)
                              | np.any(a_bi[b] != 0, axis=1))
               for b in range(k)]
    mbl = max(max(len(t) for t in touched), 1)
    bsel = np.full((k, mbl), mb, dtype=np.int64)
    bmask = np.zeros((k, mbl))
    l_ib = np.zeros((k, ni, mbl))
    l_bi = np.zeros((k, mbl, ni))
    for b, t in enumerate(touched):
        bsel[b, :len(t)] = t
        bmask[b, :len(t)] = 1.0
        l_ib[b, :, :len(t)] = a_ib[b][:, t]
        l_bi[b, :len(t), :] = a_bi[b][t, :]
    return l_ib, l_bi, bsel, bmask


def test_bbd_solve_local(dc_system):
    a, rhs, block_of, border = dc_system
    jarr = _jax_arrays(a, block_of, border)
    l_ib, l_bi, bsel, bmask = _local_layout(jarr)
    mb = len(border)
    common = dict(a_ii=np.asarray(jarr.a_ii), a_ib=l_ib, a_bi=l_bi,
                  a_bb=np.asarray(jarr.a_bb), bsel=bsel, bmask=bmask,
                  interior_idx=np.asarray(jarr.interior_idx),
                  interior_mask=np.asarray(jarr.interior_mask),
                  border_idx=np.asarray(jarr.border_idx))
    tarr = torch_bbd.BbdLocalArrays(
        route=schur_route(bsel, mb, "cpu"),
        **{k: torch.tensor(v) for k, v in common.items()})
    x = torch_bbd.bbd_solve_local(tarr, torch.tensor(rhs)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(a, rhs), rtol=0,
                               atol=SOLVE_TOL)
    x_jax = np.asarray(jax_bbd.bbd_solve_local(
        jax_bbd.BbdLocalArrays(**{
            k: jnp.asarray(v.astype(np.int32) if k == "bsel" else v)
            for k, v in common.items()}), jnp.asarray(rhs)))
    np.testing.assert_allclose(x, x_jax, rtol=0, atol=SOLVE_TOL)


def test_batched_lu_solve2_matches_numpy():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 9, 9)) + 9 * np.eye(9)
    r1 = rng.standard_normal((3, 9))
    r2 = rng.standard_normal((3, 9, 4))
    y1, y2 = torch_linalg.batched_lu_solve2(*map(torch.tensor, (a, r1, r2)))
    np.testing.assert_allclose(y1.numpy(), np.linalg.solve(a, r1[..., None])
                               [..., 0], rtol=0, atol=1e-14)
    np.testing.assert_allclose(y2.numpy(), np.linalg.solve(a, r2), rtol=0,
                               atol=1e-14)
    j1, j2 = jax_linalg.batched_lu_solve2(*map(jnp.asarray, (a, r1, r2)))
    np.testing.assert_allclose(y1.numpy(), np.asarray(j1), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(y2.numpy(), np.asarray(j2), rtol=0,
                               atol=1e-12)


def test_lu_factor_blocks_raises_on_a_singular_block():
    """A singular interior block raises, naming the block, instead of
    turning the solve into inf/NaN."""
    a = np.stack([np.eye(4) * 2.0] * 3)
    a[1, 2] = 0.0
    with pytest.raises(torch.linalg.LinAlgError, match="block 1 is singular"):
        torch_linalg.lu_factor_blocks(torch.tensor(a))


def test_stage_marks_do_nothing_outside_device_stages():
    """The solvers' stage marks record nothing unless a device_stages()
    block is open, so a CPU solve runs as before and leaves no marks."""
    from juliagrid_tpu_torch.utils import profiling
    profiling.mark("interior LU")
    assert profiling._marks is None
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 5, 5)) + 5 * np.eye(5)
    y, _ = torch_linalg.batched_lu_solve2(
        torch.tensor(a), torch.tensor(rng.standard_normal((2, 5))),
        torch.tensor(rng.standard_normal((2, 5, 2))))
    assert profiling._marks is None and y.shape == (2, 5)


def _schur_case(seed, k=5, width=7, nb=11):
    """Random contributions and a local-to-global map with pad slots (the
    sentinel nb) and border positions that several blocks share."""
    rng = np.random.default_rng(seed)
    bsel = np.full((k, width), nb, dtype=np.int64)
    for b in range(k):
        used = rng.choice(nb, size=rng.integers(1, width + 1), replace=False)
        bsel[b, rng.permutation(width)[:len(used)]] = used
    return (bsel, rng.standard_normal((k, width, width)),
            rng.standard_normal((k, width)), rng.standard_normal((nb, nb)),
            rng.standard_normal(nb))


@pytest.mark.parametrize("scale", [-1.0, 1.0])
def test_schur_gather_ref_matches_jax_scatter(scale):
    """The JAX package's padded scatter-add (newton_bbd.py:341-348 with
    -contrib; acse_bbd.py:331-336 with +contrib and no base)."""
    bsel, contrib, parts, a_bb, r_bb = _schur_case(1)
    nb = a_bb.shape[0]
    route = schur_route(bsel, nb, "cpu")
    s_pad = jnp.zeros((nb + 1, nb + 1)).at[
        bsel[:, :, None], bsel[:, None, :]].add(scale * contrib)
    r_pad = jnp.zeros(nb + 1).at[bsel].add(scale * parts)
    base = scale < 0
    schur, rhs = schur_gather(route, torch.tensor(contrib),
                              torch.tensor(parts),
                              torch.tensor(a_bb) if base else None,
                              torch.tensor(r_bb) if base else None, scale)
    want_s = np.asarray(s_pad[:nb, :nb]) + (a_bb if base else 0.0)
    want_r = np.asarray(r_pad[:nb]) + (r_bb if base else 0.0)
    np.testing.assert_allclose(schur.numpy(), want_s, rtol=0, atol=1e-14)
    np.testing.assert_allclose(rhs.numpy(), want_r, rtol=0, atol=1e-14)


def _walk_lists(host, contrib, parts, a_bb, r_bb, scale):
    """K5's per-slot lists walked as the kernel walks them: element (i, j)
    merges the two ascending lists and sums the common blocks'
    contributions in ascending block order from 0.0, then base + scale *
    sum; the right-hand side sums each slot's own list."""
    ptr, blk, loc = host["slot_ptr"], host["slot_blk"], host["slot_loc"]
    nb = len(ptr) - 1
    schur, rhs = a_bb.copy(), r_bb.copy()
    for j in range(nb):
        q0, q1 = ptr[j], ptr[j + 1]
        for i in range(nb):
            p, pe, q = ptr[i], ptr[i + 1], q0
            acc, reached = 0.0, False
            while p < pe and q < q1:
                if blk[p] == blk[q]:
                    acc += contrib[blk[p], loc[p], loc[q]]
                    reached = True
                    p, q = p + 1, q + 1
                elif blk[p] < blk[q]:
                    p += 1
                else:
                    q += 1
            if reached:
                schur[i, j] = schur[i, j] + scale * acc
        if q1 > q0:
            rhs[j] = rhs[j] + scale * sum(parts[blk[q], loc[q]]
                                          for q in range(q0, q1))
    return schur, rhs


@pytest.mark.parametrize("seed", [1, 2])
def test_schur_route_gather_equals_ref(seed):
    """K5's per-slot lists, walked as the kernel walks them (one element at
    a time, the two lists merged in ascending block order, base + scale *
    sum), reproduce the plain version; pad slots are never named and each
    list is ascending."""
    bsel, contrib, parts, a_bb, r_bb = _schur_case(seed)
    nb = a_bb.shape[0]
    host = schur_route_host(bsel, nb)
    k, width = bsel.shape
    for name in ("slot_ptr", "slot_blk", "slot_loc"):
        assert host[name].dtype == np.int32
    ptr, blk, loc = host["slot_ptr"], host["slot_blk"], host["slot_loc"]
    assert ptr[0] == 0 and ptr[-1] == np.count_nonzero(bsel < nb)
    for g in range(nb):
        lst = slice(ptr[g], ptr[g + 1])
        assert np.all(np.diff(blk[lst]) > 0)
        assert np.all(bsel[blk[lst], loc[lst]] == g)
    schur, rhs = _walk_lists(host, contrib, parts, a_bb, r_bb, -1.0)
    ref = schur_gather_ref(schur_route(bsel, nb, "cpu"),
                           torch.tensor(contrib), torch.tensor(parts),
                           torch.tensor(a_bb), torch.tensor(r_bb), -1.0)
    np.testing.assert_allclose(schur, ref[0].numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(rhs, ref[1].numpy(), rtol=0, atol=1e-14)


@pytest.mark.parametrize("scale", [-1.0, 1.0, 0.3])
@pytest.mark.parametrize("base", [True, False])
@pytest.mark.parametrize("seed", [1, 2, 4])
def test_schur_gather_lists_is_the_list_walk(seed, base, scale):
    """``schur_gather_lists``, the check K5 is held to bit for bit on the
    card, is the kernel's list walk bit for bit, and the plain version
    within rounding (with and without a base, at any scale)."""
    bsel, contrib, parts, a_bb, r_bb = _schur_case(seed)
    nb = a_bb.shape[0]
    if not base:
        a_bb, r_bb = np.zeros_like(a_bb), np.zeros_like(r_bb)
    route = schur_route(bsel, nb, "cpu")
    args = (torch.tensor(contrib), torch.tensor(parts),
            torch.tensor(a_bb) if base else None,
            torch.tensor(r_bb) if base else None, scale)
    got = schur_gather_lists(route, *args)
    walk = _walk_lists(schur_route_host(bsel, nb), contrib, parts, a_bb,
                       r_bb, scale)
    assert np.array_equal(got[0].numpy(), walk[0])
    assert np.array_equal(got[1].numpy(), walk[1])
    ref = schur_gather_ref(route, *args)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-14)


def test_schur_gather_lists_on_the_10k_layout():
    """The 10k grid's NR border at k = 16 (the layout phase 13 holds K5 to
    on the card): lists of at most a few blocks, no pad slot listed, and
    the list walk equal to the plain version."""
    arr, lay = jgt.powerflow.newton_bbd.compile_nr_bbd(
        synthetic_grid(100, 100), 16, "cpu")
    route = arr.schur
    k, width = route.bsel.shape
    nb = route.nb
    assert (k, width, nb) == (16, 202, 1220)
    count = (route.slot_ptr[1:] - route.slot_ptr[:-1]).numpy()
    assert count.sum() == int((route.bsel < nb).sum())
    assert 1 <= count.max() <= 4
    assert not route.by_rows                # the output outweighs the rest
    gen = torch.Generator().manual_seed(5)
    contrib = torch.randn((k, width, width), generator=gen,
                          dtype=torch.float64)
    parts = torch.randn((k, width), generator=gen, dtype=torch.float64)
    a_bb = torch.randn((nb, nb), generator=gen, dtype=torch.float64)
    r_bb = torch.randn(nb, generator=gen, dtype=torch.float64)
    got = schur_gather_lists(route, contrib, parts, a_bb, r_bb, -1.0)
    ref = schur_gather_ref(route, contrib, parts, a_bb, r_bb, -1.0)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-13)


def test_by_rows_weighs_contributions_against_the_border():
    """K5 streams contribution rows when the real contributions are at
    least as many as the border's elements, and merges lists otherwise."""
    few = np.array([[0, 1, 4], [2, 3, 4]])            # 2 x 2^2 < 4^2
    many = np.array([[0, 1, 2, 3], [0, 1, 2, 3]])     # 2 x 4^2 >= 4^2
    assert not schur_route(few, 4, "cpu").by_rows
    assert schur_route(many, 4, "cpu").by_rows
    assert not schur_route_host(few, 4)["by_rows"]


def test_schur_route_refuses_a_slot_named_twice():
    """One block naming one border slot at two local slots would need two
    contributions summed into one element from one list entry: refused."""
    bsel = np.array([[0, 1, 3], [1, 1, 3]])
    with pytest.raises(ValueError, match="twice"):
        schur_route_host(bsel, 3)


def test_schur_gather_checks_inputs():
    bsel, contrib, parts, a_bb, _ = _schur_case(3)
    route = schur_route(bsel, a_bb.shape[0], "cpu")
    with pytest.raises(ValueError, match="contrib must have shape"):
        schur_gather(route, torch.tensor(contrib[:, :2]), torch.tensor(parts))
    with pytest.raises(TypeError, match="float64"):
        schur_gather(route, torch.tensor(contrib).float(),
                     torch.tensor(parts))
    with pytest.raises(ValueError, match="int32"):
        schur_route_host(np.zeros((2, 40000), dtype=np.int64), 50000)
