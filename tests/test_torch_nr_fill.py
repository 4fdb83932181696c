"""K1 ``nr_fill``: its plain PyTorch version against the JAX package's
``_injections``, ``_mismatch`` and ``_nr_jacobian`` on identical network
state carried across with ``ac_arrays_from_numpy``; the wrapper's CPU
dispatch, input checks and build. The CUDA kernel itself is held to the
plain version on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
from juliagrid_tpu.powerflow import ac as jax_ac
from juliagrid_tpu_torch.convert import ac_arrays_from_numpy
from juliagrid_tpu_torch.kernels import _build
from juliagrid_tpu_torch.kernels.nr_fill import nr_fill, nr_fill_ref
from juliagrid_tpu_torch.powerflow import ac as torch_ac

TOL = dict(rtol=1e-12, atol=1e-12)


def _carried(data_path, case):
    system = jg.power_system(str(data_path / case))
    jarr = jax_ac.compile_ac_arrays(system)
    tarr = ac_arrays_from_numpy(
        **{f: np.asarray(getattr(jarr, f)) for f in jarr._fields},
        device="cpu")
    return jarr, tarr


def _states(n, batch, jarr, seed):
    rng = np.random.default_rng(seed)
    vm = 1.0 + 0.05 * rng.standard_normal((batch, n))
    va = 0.2 * rng.standard_normal((batch, n))
    scale = 1.0 + 0.05 * rng.standard_normal((batch, 1))
    ps = np.asarray(jarr.p_sched)[None, :] * scale
    qs = np.asarray(jarr.q_sched)[None, :] * scale
    return vm, va, ps, qs


def _jax_fill(jarr, vm, va, ps, qs):
    a = jarr._replace(p_sched=ps, q_sched=qs)
    p, q, _, _ = jax_ac._injections(a, vm, va)
    mp, mq, del_p, del_q = jax_ac._mismatch(a, vm, va)
    jac, m = jax_ac._nr_jacobian(a, vm, va, p, q)
    return p, q, mp, mq, del_p, del_q, jac, m


@pytest.mark.parametrize("case", ["case14test.m", "case118.m"])
def test_port_kernels_match_jax_single(data_path, case):
    """B = 1 through the port's ac.py functions (CPU dispatch of K1)."""
    jarr, tarr = _carried(data_path, case)
    n = tarr.row_ptr.numel() - 1
    vm, va, _, _ = _states(n, 1, jarr, seed=3)
    want = _jax_fill(jarr, jnp.asarray(vm[0]), jnp.asarray(va[0]),
                     jarr.p_sched, jarr.q_sched)
    tvm, tva = torch.from_numpy(vm[0]), torch.from_numpy(va[0])
    p, q = torch_ac._injections(tarr, tvm, tva)
    mp, mq, del_p, del_q = torch_ac._mismatch(tarr, tvm, tva)
    jac, m = torch_ac._nr_jacobian(tarr, tvm, tva)
    for got, ref in zip((p, q, mp, mq, del_p, del_q, jac, m), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("case", ["case14test.m", "case118.m"])
def test_nr_fill_ref_matches_vmapped_jax(data_path, case):
    """B = 8 scenarios with their own states and schedules."""
    jarr, tarr = _carried(data_path, case)
    n = tarr.row_ptr.numel() - 1
    vm, va, ps, qs = _states(n, 8, jarr, seed=5)
    want = jax.vmap(lambda *x: _jax_fill(jarr, *x))(
        *(jnp.asarray(x) for x in (vm, va, ps, qs)))
    got = nr_fill_ref(tarr, *(torch.from_numpy(x) for x in (vm, va, ps, qs)),
                      jacobian=True)
    for name, ref in zip(("p", "q", "mp", "mq"), want[:4]):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(ref), **TOL)
    # K1's Jacobian is the Newton system's, over the unknowns: the masked
    # Jacobian's rows and columns at those variables
    keep = tarr.unknowns.numpy()
    np.testing.assert_allclose(got.jac.numpy(),
                               np.asarray(want[6])[:, keep][:, :, keep],
                               **TOL)


def test_cpu_tensors_take_the_plain_version(data_path):
    """A CPU tensor goes to nr_fill_ref and launches no kernel; without the
    Jacobian flag no Jacobian is formed."""
    jarr, tarr = _carried(data_path, "case14test.m")
    vm, va, ps, qs = (torch.from_numpy(x)
                      for x in _states(14, 2, jarr, seed=1))
    before = nr_fill.launches
    got = nr_fill(tarr, vm, va, ps, qs, jacobian=True)
    assert nr_fill.launches == before
    ref = nr_fill_ref(tarr, vm, va, ps, qs, jacobian=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert nr_fill(tarr, vm, va, ps, qs).jac is None


def test_nr_fill_rejects_bad_inputs(data_path):
    _, tarr = _carried(data_path, "case14test.m")
    x = torch.ones((2, 14), dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        nr_fill(tarr, x.float(), x, x, x)
    with pytest.raises(ValueError, match="shape"):
        nr_fill(tarr, x[:, :13], x, x, x)
    with pytest.raises(ValueError, match="shape"):
        nr_fill(tarr, x, x[:1], x, x)


def test_entry_list_must_be_unique_sorted_with_diagonal(data_path):
    """K1 writes each Jacobian element once: a repeated (row, col) pair, an
    unsorted list or a missing diagonal entry is refused on the host."""
    jarr, _ = _carried(data_path, "case14test.m")
    fields = {f: np.asarray(getattr(jarr, f)) for f in jarr._fields}
    rows, cols = fields["rows"], fields["cols"]
    dup = dict(fields, rows=np.insert(rows, 1, rows[0]),
               cols=np.insert(cols, 1, cols[0]),
               yg=np.insert(fields["yg"], 1, 0.0),
               yb=np.insert(fields["yb"], 1, 0.0),
               diag=np.where(fields["diag"] > 0, fields["diag"] + 1, 0))
    with pytest.raises(ValueError, match="repeats"):
        ac_arrays_from_numpy(**dup, device="cpu")
    with pytest.raises(ValueError, match="diagonal"):
        ac_arrays_from_numpy(**dict(fields, diag=fields["diag"][:-1]),
                             device="cpu")
    with pytest.raises(ValueError, match="sorted"):
        ac_arrays_from_numpy(**dict(fields, rows=rows[::-1].copy()),
                             device="cpu")


def test_build_targets_hopper_and_raises_without_nvcc(monkeypatch, tmp_path):
    """The kernel is compiled for sm_90a; without the CUDA toolkit the build
    raises instead of handing the call to the plain version."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags
    assert _build.library_path("nr_fill").parent == _build.BUILD_DIR
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("nr_fill")
    assert not (tmp_path / "build").exists()
