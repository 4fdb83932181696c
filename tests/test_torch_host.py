"""The port's copied numpy host layer against the JAX package's original:
identical Y-bus entry lists, device tables and start states; and the port
imports no JAX and never runs on the CPU in place of a missing card."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.powerflow import ac as jax_ac
from juliagrid_tpu.utils.synthetic import synthetic_grid as jax_synthetic
from juliagrid_tpu_torch.powerflow import ac as torch_ac
from juliagrid_tpu_torch.utils.synthetic import synthetic_grid as torch_synthetic

REPO = pathlib.Path(__file__).resolve().parents[1]

CASES = ["case14test.m", "case30test.m", "case118.m", "case300.m",
         "case1354pegase.h5", "case14.raw", "synthetic_12x12"]


def _pair(data_path, case):
    """The same case loaded by the JAX package and by the port."""
    if case == "synthetic_12x12":
        return jax_synthetic(12, 12), torch_synthetic(12, 12)
    path = str(data_path / case)
    return jg.power_system(path), jgt.power_system(path)


@pytest.mark.parametrize("case", CASES)
def test_host_copy_builds_identical_tables(data_path, case):
    js, ts = _pair(data_path, case)
    for j, t in zip(jax_ac.ac_entry_host(js), torch_ac.ac_entry_host(ts)):
        assert np.array_equal(j, t)

    jarr = jax_ac.compile_ac_arrays(js)
    tarr = torch_ac.compile_ac_arrays(ts, "cpu")
    for name in ("rows", "cols", "yg", "yb", "diag", "bus_type", "p_sched",
                 "q_sched"):
        assert np.array_equal(np.asarray(getattr(jarr, name)),
                              getattr(tarr, name).numpy()), name
    assert int(jarr.slack) == tarr.slack
    n = ts.bus.number
    assert np.array_equal(
        tarr.row_ptr.numpy(),
        np.searchsorted(np.asarray(jarr.rows), np.arange(n + 1)))

    # start state after the bus-type repair (initializeACPowerFlow)
    for j, t in zip(jax_ac.initialize_ac_power_flow(js),
                    torch_ac.initialize_ac_power_flow(ts)):
        assert np.array_equal(j, t)
    assert np.array_equal(js.bus.layout.type.array[:n],
                          ts.bus.layout.type.array[:n])
    assert js.bus.layout.slack == ts.bus.layout.slack


def test_port_imports_no_jax():
    """Importing every module of the port loads neither JAX nor the JAX
    package (the card's machine has no JAX)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import juliagrid_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'juliagrid_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_cuda_request_raises_without_card(data_path):
    """No quiet CPU fallback: asking for CUDA where there is none raises,
    and CUDA is the default device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    system = jgt.power_system(str(data_path / "case14test.m"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jgt.newton_raphson(system, device="cuda")
    assert jgt.config.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jgt.newton_raphson(system)


def test_set_config_rejects_unknown_key():
    with pytest.raises(KeyError):
        jgt.set_config(factor_dtype="float32")
    jgt.set_config(verbose=1)
    try:
        assert jgt.config.verbose == 1
    finally:
        jgt.default_config()
    assert jgt.config.verbose == 0
