"""K4 ``gs_sweep``: its plain PyTorch version against the JAX package's
``_gs_sweep`` and ``_gs_mismatch`` on identical network state carried across
with ``gs_arrays_from_numpy``; the wrapper's CPU dispatch, input checks and
build. The CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
from juliagrid_tpu.powerflow import gauss_seidel as jax_gs
from juliagrid_tpu.utils.synthetic import synthetic_grid
from juliagrid_tpu_torch.convert import gs_arrays_from_numpy
from juliagrid_tpu_torch.kernels import _build
from juliagrid_tpu_torch.kernels.gs_sweep import (MAX_ROW, gs_sweep,
                                                  gs_sweep_ref)

# |port - JAX| <= 1e-12 max(1, |JAX|): the row current sums its terms in
# another order than XLA does
TOL = dict(rtol=1e-12, atol=1e-12)


def _carried(data_path, case):
    """The JAX package's GsArrays and the same fields on the port (CPU)."""
    if case == "synthetic_10x10":
        system = synthetic_grid(10, 10)
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
                         sweep=False)
    assert np.array_equal(start.vre.numpy(), vre)
    np.testing.assert_allclose(
        start.mismatch.numpy(),
        np.asarray(jax_gs._gs_mismatch_jit(jarr, jnp.asarray(vre),
                                           jnp.asarray(vim))), **TOL)


def test_bus_lists_are_the_passes(data_path):
    """K4 walks the PQ buses, then the PV buses, each in ascending order;
    the slack is in neither list."""
    _, tarr = _carried(data_path, "case118")
    types = tarr.bus_type.numpy()
    assert np.array_equal(tarr.pq.numpy(), np.flatnonzero(types == 1))
    assert np.array_equal(tarr.pv.numpy(), np.flatnonzero(types == 2))
    assert tarr.slack not in set(tarr.pq.tolist() + tarr.pv.tolist())
    assert tarr.nb.shape == (118, 10) and tarr.nb.shape[1] <= MAX_ROW


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


def test_gs_sweep_rejects_bad_inputs(data_path):
    _, tarr = _carried(data_path, "case14test")
    x = torch.ones(14, dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        gs_sweep(tarr, x.float(), x)
    with pytest.raises(ValueError, match="shape"):
        gs_sweep(tarr, x[:13], x)
    with pytest.raises(ValueError, match="shape"):
        gs_sweep(tarr, x, x[None])


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
