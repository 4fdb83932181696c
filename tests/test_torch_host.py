"""The port's copied numpy host layer against the JAX package's original:
identical Y-bus entry lists, device tables and start states, identical
measurement tables and state-estimation row IR; and the port imports no JAX
and never runs on the CPU in place of a missing card."""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.estimation import acse as jax_acse
from juliagrid_tpu.measurement import configuration as jax_conf
from juliagrid_tpu.oracle import sparse_ref as jax_oracle
from juliagrid_tpu.postprocessing import dc as jax_dc_post
from juliagrid_tpu.powerflow import ac as jax_ac
from juliagrid_tpu.powerflow import dc as jax_dc
from juliagrid_tpu.powerflow import fast_decoupled as jax_fd
from juliagrid_tpu.powerflow import gauss_seidel as jax_gs
from juliagrid_tpu.utils.synthetic import synthetic_grid as jax_synthetic
from juliagrid_tpu_torch.estimation import acse as torch_acse
from juliagrid_tpu_torch.measurement import configuration as torch_conf
from juliagrid_tpu_torch.oracle import sparse_ref as torch_oracle
from juliagrid_tpu_torch.postprocessing import dc as torch_dc_post
from juliagrid_tpu_torch.powerflow import ac as torch_ac
from juliagrid_tpu_torch.powerflow import dc as torch_dc
from juliagrid_tpu_torch.powerflow import fast_decoupled as torch_fd
from juliagrid_tpu_torch.powerflow import gauss_seidel as torch_gs
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


@pytest.mark.parametrize("case", ["case14test.m", "case30test.m",
                                  "case118.m", "synthetic_12x12"])
def test_dc_fnr_gs_tables_match_jax(data_path, case):
    """The port's DC, fast decoupled and Gauss-Seidel device tables equal
    the JAX package's field by field. B' and B'' are scattered on the device
    instead of built densely on the host; on the CPU the parallel branches
    add up in the same order, so they come out bit for bit."""
    js, ts = _pair(data_path, case)
    jdc = jax_dc.compile_dc_arrays(js)
    tdc = torch_dc.compile_dc_arrays(ts, "cpu")
    for name in ("b_dense", "p_sched", "shift", "gshunt"):
        assert np.array_equal(np.asarray(getattr(jdc, name)),
                              getattr(tdc, name).numpy()), name
    assert int(jdc.slack) == tdc.slack
    assert float(jdc.slack_angle) == tdc.slack_angle

    for bx in (True, False):
        for j, t in zip(jax_fd._fnr_matrices(js, bx),
                        torch_fd._fnr_matrices(ts, bx, "cpu")):
            assert np.array_equal(t.numpy(), j)

    jgs = jax_gs.compile_gs_arrays(js)
    tgs = torch_gs.compile_gs_arrays(ts, "cpu")
    for name in jgs._fields:
        j, t = getattr(jgs, name), getattr(tgs, name)
        if name == "slack":
            assert int(j) == t
        else:
            assert np.array_equal(np.asarray(j), t.numpy()), name
            assert np.asarray(j).dtype == t.numpy().dtype, name


@pytest.mark.parametrize("case", ["case14test.m", "case30test.m"])
def test_fdpf_dc_oracles_and_dc_post_match_jax(data_path, case):
    """The port's copies of oracle_dc, oracle_fdpf and the DC
    post-processing give the same numbers as the originals."""
    js, ts = _pair(data_path, case)
    assert np.array_equal(jax_oracle.oracle_dc(js).angle,
                          torch_oracle.oracle_dc(ts).angle)
    for bx in (True, False):
        j = jax_oracle.oracle_fdpf(js, bx=bx)
        t = torch_oracle.oracle_fdpf(ts, bx=bx)
        assert j.iterations == t.iterations and t.converged
        assert np.array_equal(j.magnitude, t.magnitude)
        assert np.array_equal(j.angle, t.angle)

    jpf = jg.dc_power_flow(js)
    jg.power_flow(jpf)
    tpf = torch_dc.dc_power_flow(ts, device="cpu")
    tpf.voltage.angle = np.asarray(jpf.voltage.angle).copy()
    jout, tout = jax_dc_post.power(jpf), torch_dc_post.power(tpf)
    for part in ("injection", "supply", "from_", "to", "generator"):
        assert np.array_equal(getattr(jout, part).active,
                              getattr(tout, part).active), part


def _tables(obj, path="system"):
    """(path, value) of every table of a power system: each Vec's live
    array, each label list and cost dict, each scalar."""
    from juliagrid_tpu_torch.utils.labels import LabelRegistry
    from juliagrid_tpu_torch.utils.vec import Vec
    if isinstance(obj, Vec):
        yield path, obj.array
    elif isinstance(obj, LabelRegistry):
        yield path, obj.labels()
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if f.name != "model":
                yield from _tables(getattr(obj, f.name), f"{path}.{f.name}")
    elif isinstance(obj, dict):
        for key in sorted(obj, key=repr):
            yield from _tables(obj[key], f"{path}[{key!r}]")
    else:
        yield path, obj


@pytest.mark.parametrize("case", ["case1354pegase", "case_ACTIVSg10k"])
def test_npz_snapshot_round_trip(data_path, case, tmp_path):
    """The committed numpy-only snapshot, and one written anew from the
    HDF5 case, load into the same tables as the HDF5 case itself."""
    from juliagrid_tpu_torch.system.snapshot import h5_to_npz
    fresh = tmp_path / f"{case}.npz"
    h5_to_npz(str(data_path / f"{case}.h5"), str(fresh))
    ref = dict(_tables(jgt.power_system(str(data_path / f"{case}.h5"))))
    assert len(ref) > 100
    for path in (data_path / f"{case}.npz", fresh):
        got = dict(_tables(jgt.power_system(str(path))))
        assert got.keys() == ref.keys()
        for key, val in ref.items():
            if isinstance(val, np.ndarray):
                assert got[key].dtype == val.dtype, key
                assert np.array_equal(got[key], val, equal_nan=True), key
            else:
                assert got[key] == val, key


def test_port_imports_no_jax():
    """Importing every module of the port — the power-flow methods, the
    state estimators, bad data, observability and the kernels among them —
    loads neither JAX nor the JAX package (the card's machine has no
    JAX)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import juliagrid_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('estimation.acse', 'kernels.se_fill', 'ops.equations',"
        " 'measurement.devices', 'measurement.hdf5io', 'parallel.batch',"
        " 'powerflow.dc', 'powerflow.fast_decoupled',"
        " 'powerflow.gauss_seidel', 'powerflow.limits', 'postprocessing.dc',"
        " 'kernels.gs_sweep', 'oracle.sparse_ref', 'estimation.dcse',"
        " 'estimation.pmuse', 'estimation.baddata', 'estimation.takahashi',"
        " 'estimation.observability', 'opf.ipm', 'opf.dcopf', 'opf.edit',"
        " 'estimation.lav', 'system.snapshot', 'opf.acopf', 'opf.extended',"
        " 'kernels.opf_fill', 'opf.kkt_bbd', 'kernels.kkt_fill',"
        " 'report.tables', 'report.info', 'utils.checkpoint', 'entry'):\n"
        "    assert 'juliagrid_tpu_torch.' + m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'juliagrid_tpu', 'h5py')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def _every_device_kind(pkg, conf, system, pf):
    """Bulk and manual adds of every device kind, with value edits and
    seeded random status changes (``conf`` is the package's
    measurement.configuration module), through ``pkg``'s public API."""
    mon = pkg.measurement(system)
    pkg.add_voltmeter(mon, analysis=pf)
    pkg.add_ammeter(mon, analysis=pf, square=True, status_to=-1)
    pkg.add_wattmeter(mon, analysis=pf)
    pkg.add_varmeter(mon, analysis=pf, status_bus=0)
    pkg.add_pmu(mon, analysis=pf, polar=True, status_from=-1)
    pkg.add_pmu(mon, analysis=pf, correlated=True, status_bus=-1)
    label = system.bus.label.label(2)
    pkg.add_voltmeter(mon, "V manual", bus=label, magnitude=1.02,
                      variance=1e-4)
    pkg.add_wattmeter(mon, "P manual",
                      from_branch=system.branch.label.label(1), active=0.5)
    pkg.add_pmu(mon, "PMU manual", bus=label, magnitude=1.0, angle=-0.1,
                polar=True)
    pkg.update_wattmeter(mon, "P manual", active=0.4, variance=1e-3)
    pkg.update_pmu(mon, "PMU manual", correlated=True, polar=False)
    conf.seed(4)
    pkg.status_voltmeter(mon, outservice=2)
    pkg.status_pmu(mon, outservice_bus=1)
    return mon


def _same_tables(j, t, where="monitoring"):
    """Field-by-field equality of two measurement dataclass trees."""
    if dataclasses.is_dataclass(j):
        for f in dataclasses.fields(j):
            if f.name != "system":
                _same_tables(getattr(j, f.name), getattr(t, f.name),
                             f"{where}.{f.name}")
    elif hasattr(j, "array"):                      # Vec
        assert j.array.dtype == t.array.dtype, where
        assert np.array_equal(j.array, t.array), where
    elif hasattr(j, "_keys"):                      # LabelRegistry
        assert j._keys == t._keys and j.counter == t.counter, where
    else:
        assert j == t, where


@pytest.mark.parametrize("case", ["case14test.m", "case30test.m"])
def test_measurement_copy_builds_identical_tables(data_path, case):
    """The port's measurement/ copy and the JAX package's original build
    the same device tables and the same compile_se_arrays host mirror from
    the same solved power flow (the JAX package's, so that both read
    identical values)."""
    path = str(data_path / case)
    pf = jg.newton_raphson(jg.power_system(path))
    jg.power_flow(pf, power=True, current=True)
    mons = []
    for pkg, conf in ((jg, jax_conf), (jgt, torch_conf)):
        system = pkg.power_system(path)
        mons.append((system, _every_device_kind(pkg, conf, system, pf)))
    (js, jmon), (ts, tmon) = mons
    _same_tables(jmon, tmon)

    _, jtypes, jdev, jhost = jax_acse.compile_se_arrays(js, jmon,
                                                        return_host=True)
    _, ttypes, tdev, thost = torch_acse.compile_se_arrays(
        ts, tmon, return_host=True, device="cpu")
    assert np.array_equal(jtypes, ttypes) and jdev == tdev
    for name in jhost._fields:
        jf, tf = getattr(jhost, name), getattr(thost, name)
        if name == "branch":
            for jg_, tg_ in zip(jf, tf):
                for j, t in zip(jg_, tg_):
                    assert j.dtype == t.dtype and np.array_equal(j, t), name
        else:
            assert np.asarray(jf).dtype == np.asarray(tf).dtype, name
            assert np.array_equal(jf, tf), name
    for j, t in zip(jax_acse.compile_se_arrays(js, jmon, values_only=True),
                    torch_acse.compile_se_arrays(ts, tmon,
                                                 values_only=True)):
        assert np.array_equal(j, t)


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
