"""The port's fixed-order sums (``juliagrid_tpu_torch/ops/segments.py``) on
the CPU: ``segment_sum`` against a sequential sum in ascending position,
its host table, its ``torch.func`` compositions against ``index_add``, the
AC OPF's problem functions and their vector-Jacobian products against the
JAX package's ``eq``/``ineq`` and ``jac_eq(x).T @ y``/``jac_ineq(x).T @
z``, and the BBD KKT's residual.

Tolerances: the helper is held to the sequential sum bit for bit (it is
one); compositions against ``index_add`` to 1e-14 (gradients accumulated
in another order); the problem functions and products against the JAX
package to 1e-12 relative (``|a - b| <= 1e-12 max(1, |b|)``,
tests/test_torch_opf_fill.py's: the same arithmetic, the sums in another
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from juliagrid_tpu.opf import acopf as jax_acopf
from juliagrid_tpu_torch.opf import acopf
from juliagrid_tpu_torch.opf.kkt_bbd import AcKktBbd
from juliagrid_tpu_torch.ops.segments import segment_sum, segment_table

from .test_torch_opf_fill import _close, _points, _systems


def _sequential(src, index, size):
    """Each group's entries added one after another in ascending position,
    from 0.0."""
    out = np.zeros(src.shape[:-1] + (size,))
    for p, j in enumerate(index):
        out[..., j] = out[..., j] + src[..., p]
    return out


def _data(seed, m, size, lead=()):
    rng = np.random.default_rng(seed)
    index = rng.integers(0, size, m)
    # magnitudes over sixteen decades, so that the order shows in the bits
    src = rng.standard_normal(lead + (m,)) * 10.0 ** rng.integers(
        -8, 8, lead + (m,))
    return index, src


@pytest.mark.parametrize("forward_ad", [True, False],
                         ids=["columns", "one-kernel"])
@pytest.mark.parametrize("lead", [(), (3,), (2, 4)])
def test_segment_sum_is_the_sequential_sum(lead, forward_ad):
    index, src = _data(0, 700, 53, lead)
    index[:5] = 52                      # a long group, and empty ones below
    index[index == 7] = 8
    got = segment_sum(torch.tensor(src), torch.tensor(index), 60,
                      forward_ad=forward_ad)
    assert np.array_equal(got.numpy(), _sequential(src, index, 60))
    assert np.all(got.numpy()[..., 53:] == 0.0)


def test_segment_table_lists_each_group_in_order():
    index = np.array([2, 0, 2, 1, 2, 0])
    np.testing.assert_array_equal(segment_table(index, 4),
                                  [[1, 5, 6], [3, 6, 6], [0, 2, 4],
                                   [6, 6, 6]])
    assert segment_table(np.zeros(0, dtype=np.int64), 3).shape == (3, 0)
    with pytest.raises(ValueError, match="outside"):
        segment_sum(torch.zeros(3, dtype=torch.float64),
                    torch.tensor([0, 1, 9]), 9)


def test_compositions_match_index_add():
    """grad, vjp, jvp over grad, vmap over grad, hessian, jacfwd and a
    batch of a function with fixed-order sums agree with the same function
    written with index_add, each index met for the first time inside the
    transform."""
    rng = np.random.default_rng(3)
    n = 11

    def fns():
        idx = torch.tensor(rng.integers(0, n, 40))

        def ours(v):
            g = v[..., idx]
            return (g * g * g).sum(-1) + segment_sum(torch.sin(g), idx,
                                                     n).pow(2).sum(-1)

        def plain(v):
            g = v[..., idx]
            s = torch.zeros(v.shape[:-1] + (n,), dtype=v.dtype).index_add(
                -1, idx, torch.sin(g))
            return (g * g * g).sum(-1) + s.pow(2).sum(-1)

        return ours, plain

    x = torch.tensor(rng.standard_normal(n))
    t = torch.tensor(rng.standard_normal(n))
    xb = torch.tensor(rng.standard_normal((3, n)))
    f = torch.func
    for make in (
            lambda g: f.grad(g)(x),
            lambda g: f.vjp(g, x)[1](torch.tensor(1.5, dtype=x.dtype))[0],
            lambda g: f.jvp(f.grad(g), (x,), (t,))[1],
            lambda g: f.vmap(f.grad(g))(xb),
            lambda g: f.hessian(g)(x),
            lambda g: f.jacfwd(f.jacrev(g))(x),
            lambda g: g(xb)):
        ours, plain = fns()
        torch.testing.assert_close(make(ours), make(plain), rtol=1e-14,
                                   atol=1e-14)


@pytest.mark.parametrize("case", ["case14optimal", "case30test", "case118"])
def test_problem_functions_and_vjps_match_jax(data_path, case):
    """acopf_eq/acopf_ineq, with their bus sums in a fixed order, and
    their vector-Jacobian products (the structured step's r_d) against
    the JAX package's eq/ineq and jac_eq(x).T @ y, jac_ineq(x).T @ z."""
    js, ts = _systems(data_path, case, 0)
    jspec = jax_acopf._AcSpec(js)
    tspec = acopf._AcSpec(ts, device="cpu")
    p, arr = jspec.params, tspec.arrays
    for x, y, z in _points(tspec, tspec.start(ts), seed=5):
        xj, xt = jnp.asarray(x), torch.tensor(x)
        eq, pull_e = torch.func.vjp(lambda v: acopf.acopf_eq(arr, v), xt)
        ineq, pull_i = torch.func.vjp(lambda v: acopf.acopf_ineq(arr, v),
                                      xt)
        _close(eq, jspec.eq(xj, p))
        _close(ineq, jspec.ineq(xj, p))
        _close(pull_e(torch.tensor(y))[0],
               np.asarray(jspec.jac_eq(xj, p)).T @ y)
        _close(pull_i(torch.tensor(z))[0],
               np.asarray(jspec.jac_ineq(xj, p)).T @ z)


def test_finish_residual_is_unchanged(data_path):
    """The BBD KKT's residual check through segment_sum gives the bits of
    the index_add it replaced (on the CPU both add in ascending
    position)."""
    _, ts = _systems(data_path, "case30test", 0)
    spec = acopf._AcSpec(ts, device="cpu")
    kkt = AcKktBbd(spec, 3)
    rng = np.random.default_rng(6)
    m = kkt._rows.numel()
    size = spec.n_x + spec.m_e
    vals = torch.tensor(rng.standard_normal(m))
    rhs = torch.tensor(rng.standard_normal(size))
    sol = torch.tensor(rng.standard_normal(size))
    _, _, lin_res, curv = kkt._finish(vals, rhs, sol)
    ax = torch.zeros_like(rhs).index_add_(0, kkt._rows,
                                          vals * sol[kkt._cols])
    want = (ax - rhs).abs().max() / (1.0 + rhs.abs().max())
    assert float(lin_res) == float(want)
    nw = kkt.n_w
    assert float(curv) == float((vals[:nw] * sol[kkt._rows[:nw]]
                                 * sol[kkt._cols[:nw]]).sum())
