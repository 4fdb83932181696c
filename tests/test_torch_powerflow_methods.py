"""The port's DC, fast decoupled and Gauss-Seidel power flows and reactive
limits against the MATPOWER goldens and the JAX package (patterns of
tests/test_powerflow.py and tests/test_limits.py), on the CPU: exact
iteration counts, states to the goldens' tolerances and to 1e-9 against
JAX (DC 1e-12).

The fast decoupled counts equal the goldens though the two packages factor
B' and B'' differently (JAX: f32 LU with three f64 refinement sweeps; the
port: f64 LU): the solves agree to about 1e-12, far below the 1e-8
tolerance at which the loop stops."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.parallel.batch import batched_dc_solve_jit
from juliagrid_tpu.powerflow import dc as jax_dc
from juliagrid_tpu.powerflow import fast_decoupled as jax_fd
from juliagrid_tpu.powerflow import gauss_seidel as jax_gs
from juliagrid_tpu_torch.ops import linalg
from juliagrid_tpu_torch.parallel import batched_dc_solve
from juliagrid_tpu_torch.powerflow import dc as torch_dc
from juliagrid_tpu_torch.powerflow.ac import mismatch, solve
from juliagrid_tpu_torch.report.log import suppress
from juliagrid_tpu_torch.system.builders import update_bus

from .utils import assert_dc_power, assert_dc_voltage, assert_voltage, h5group

STATE_TOL = dict(rtol=0, atol=1e-9)
DC_TOL = dict(rtol=0, atol=1e-12)
CASES = ["case14test", "case30test"]
#: (port constructor, JAX constructor, golden group, iteration cap)
METHODS = {
    "BX": (jgt.fast_newton_raphson_bx, jax_fd.fast_newton_raphson_bx,
           "fastNewtonRaphsonBX", 30),
    "XB": (jgt.fast_newton_raphson_xb, jax_fd.fast_newton_raphson_xb,
           "fastNewtonRaphsonXB", 30),
    "GS": (jgt.gauss_seidel, jax_gs.gauss_seidel, "gaussSeidel", 900),
}


def _path(data_path, case):
    return str(data_path / f"{case}.m")


def _assert_same_state(port, ref, tol=STATE_TOL):
    assert port.method.iteration == ref.method.iteration
    np.testing.assert_allclose(port.voltage.magnitude,
                               np.asarray(ref.voltage.magnitude), **tol)
    np.testing.assert_allclose(port.voltage.angle,
                               np.asarray(ref.voltage.angle), **tol)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", ["LU", "KLU", "QR", "LL", "LDLt"])
def test_dc_power_flow_matches_goldens_and_jax(data_path, case, kind):
    path = _path(data_path, case)
    golden = h5group(data_path / "results.h5", f"{case}/dcPowerFlow")
    analysis = jgt.dc_power_flow(jgt.power_system(path), kind, device="cpu")
    jgt.power_flow(analysis, power=True)
    assert analysis.method.converged
    assert_dc_voltage(golden, analysis)
    assert_dc_power(golden, analysis)

    ref = jg.dc_power_flow(jg.power_system(path), kind)
    want = np.asarray(jax_dc._dc_solve(ref.arrays, kind))
    np.testing.assert_allclose(analysis.voltage.angle, want, **DC_TOL)


def test_batched_dc_solve_matches_jax_and_single(data_path):
    """8 scenarios of case14: one factorization, one solve call; each
    scenario equals the JAX fleet's and a single solve of its schedule."""
    path = _path(data_path, "case14test")
    arr = jgt.dc_power_flow(jgt.power_system(path), device="cpu").arrays
    ref = jg.dc_power_flow(jg.power_system(path)).arrays
    rng = np.random.default_rng(7)
    p_b = np.asarray(ref.p_sched)[None, :] * (
        1.0 + 0.05 * rng.standard_normal((8, 1)))
    got = batched_dc_solve(arr, torch.from_numpy(p_b))
    assert got.shape == (8, 14)
    want = np.asarray(batched_dc_solve_jit(ref, jnp.asarray(p_b)))
    np.testing.assert_allclose(got.numpy(), want, **DC_TOL)
    for s in range(8):
        single = torch_dc._dc_solve(
            arr._replace(p_sched=torch.from_numpy(p_b[s])), "LU")
        np.testing.assert_allclose(got[s].numpy(), single.numpy(), **DC_TOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("method", ["BX", "XB", "GS"])
def test_iterative_methods_match_goldens_and_jax(data_path, case, method):
    build, jax_build, group, cap = METHODS[method]
    path = _path(data_path, case)
    golden = h5group(data_path / "results.h5", f"{case}/{group}")
    analysis = build(jgt.power_system(path), device="cpu")
    jgt.power_flow(analysis, iteration=cap)
    assert analysis.method.converged
    assert_voltage(golden, analysis, atol=1e-8 if method == "GS" else 1e-9)

    ref = jax_build(jg.power_system(path))
    jg.power_flow(ref, iteration=cap)
    _assert_same_state(analysis, ref)
    if method == "GS":
        assert analysis.method.iteration == chip_smoke.GS_ITERATIONS[case]


def test_gauss_seidel_case118_count_is_pinned(data_path):
    """chip_smoke.py holds the port's case118 Gauss-Seidel on the card to
    the JAX package's iteration count; this pins that count."""
    ref = jax_gs.gauss_seidel(jg.power_system(_path(data_path, "case118")))
    jg.power_flow(ref, iteration=5000)
    assert ref.method.converged
    assert ref.method.iteration == chip_smoke.GS_ITERATIONS["case118"]


def test_compare_ac_methods(data_path):
    """All AC methods converge to the same solution (reference 'Compare AC
    Power Flows Methods' testset)."""
    system = jgt.power_system(_path(data_path, "case14test"))
    nr = jgt.newton_raphson(system, device="cpu")
    jgt.power_flow(nr)
    for build, kwargs in ((jgt.fast_newton_raphson_bx, dict(iteration=300)),
                          (jgt.fast_newton_raphson_xb, dict(iteration=300)),
                          (jgt.gauss_seidel, dict(iteration=1000,
                                                  tolerance=1e-9))):
        analysis = build(system, device="cpu")
        jgt.power_flow(analysis, **kwargs)
        assert analysis.method.converged
        np.testing.assert_allclose(analysis.voltage.magnitude,
                                   nr.voltage.magnitude, atol=1e-7)
        np.testing.assert_allclose(analysis.voltage.angle,
                                   nr.voltage.angle, atol=1e-7)


@pytest.mark.parametrize("method", ["BX", "XB", "GS"])
def test_stepwise_matches_jax(data_path, method):
    """Three reference mismatch!/solve! steps: the same mismatches and
    states as the JAX package's fnr_/gs_ step functions."""
    build, jax_build, _, _ = METHODS[method]
    path = _path(data_path, "case14test")
    analysis = build(jgt.power_system(path), device="cpu")
    ref = jax_build(jg.power_system(path))
    jax_mismatch, jax_step = (
        (jax_gs.gs_mismatch, jax_gs.gs_solve_step) if method == "GS"
        else (jax_fd.fnr_mismatch, jax_fd.fnr_solve_step))
    for _ in range(3):
        np.testing.assert_allclose(mismatch(analysis), jax_mismatch(ref),
                                   rtol=1e-9, atol=1e-12)
        solve(analysis)
        jax_step(ref)
        _assert_same_state(analysis, ref)
    assert analysis.method.iteration == 3


def _limits_run(build, system, cap):
    analysis = build(system, device="cpu")
    jgt.power_flow(analysis, iteration=cap)
    iteration = analysis.method.iteration
    with suppress():
        jgt.reactive_limit(analysis)
    analysis = build(system, device="cpu")
    jgt.power_flow(analysis, iteration=cap)
    analysis.method.iteration += iteration
    jgt.adjust_angle(analysis, system.bus.label.label(0))
    return analysis


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("method", ["NR", "BX", "XB", "GS"])
def test_reactive_limit(data_path, case, method):
    """tests/test_limits.py on the port: enforce the limits, re-solve with
    the accumulated count, adjust the angles to the original slack."""
    build, cap, group = {
        "NR": (jgt.newton_raphson, 20, "newtonRaphson"),
        "BX": (jgt.fast_newton_raphson_bx, 300, "fastNewtonRaphsonBX"),
        "XB": (jgt.fast_newton_raphson_xb, 300, "fastNewtonRaphsonXB"),
        "GS": (jgt.gauss_seidel, 3000, "gaussSeidel"),
    }[method]
    system = jgt.power_system(_path(data_path, case))
    golden = h5group(data_path / "results.h5",
                     f"{case}/reactiveLimit/{group}")
    assert_voltage(golden, _limits_run(build, system, cap))


@pytest.mark.parametrize("method", ["BX", "GS"])
def test_refresh_rebuilds_method_arrays(data_path, method):
    """An injection edit and a bus-type edit rebuild the analysis's
    FnrArrays or GsArrays, equal to a fresh build's."""
    build = METHODS[method][0]
    system = jgt.power_system(_path(data_path, "case14test"))
    analysis = build(system, device="cpu")
    arrays = analysis.arrays
    update_bus(system, system.bus.label.label(13), active=0.2, reactive=0.1)
    update_bus(system, system.bus.label.label(5), type=1)
    mismatch(analysis)
    assert analysis.arrays is not arrays
    fresh = build(system, device="cpu").arrays
    assert type(analysis.arrays) is type(fresh)
    for name, got, want in zip(fresh._fields, analysis.arrays, fresh):
        if isinstance(want, linalg.DenseFactor):   # B' and B'' factors
            assert got.kind == want.kind, name
            assert all(map(torch.equal, got.data, want.data)), name
        elif isinstance(want, torch.Tensor):
            assert torch.equal(got, want), name
        else:
            assert got == want, name
    assert int(fresh.bus_type[5]) == 1


def test_verbose_gauss_seidel_prints_no_increments(data_path, capsys):
    """verbose >= 2 logs every iteration but, for Gauss-Seidel, no
    increments block; the other methods print it."""
    path = _path(data_path, "case14test")
    analysis = jgt.gauss_seidel(jgt.power_system(path), device="cpu")
    jgt.power_flow(analysis, iteration=900, verbose=2)
    out = capsys.readouterr().out
    assert analysis.method.converged and analysis.method.iteration == 281
    assert "Increment" not in out and "EXIT" in out.upper()
    analysis = jgt.fast_newton_raphson_bx(jgt.power_system(path),
                                          device="cpu")
    jgt.power_flow(analysis, iteration=30, verbose=2)
    assert "Magnitude Increment" in capsys.readouterr().out
