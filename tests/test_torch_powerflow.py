"""The port's Newton-Raphson slice against the MATPOWER goldens and the JAX
package (pattern of tests/test_powerflow.py), on the CPU: exact iteration
counts, states to 1e-9 against the goldens and 1e-10 against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import juliagrid_tpu as jg
import juliagrid_tpu_torch as jgt
from juliagrid_tpu.parallel.batch import batched_nr_solve_jit
from juliagrid_tpu_torch.parallel import batched_nr_solve
from juliagrid_tpu_torch.postprocessing.ac import current as ac_current
from juliagrid_tpu_torch.powerflow.ac import _nr_solve, mismatch, solve

from .utils import assert_bus_balance, assert_power, assert_voltage, h5group

STATE_TOL = dict(rtol=0, atol=1e-10)


def _assert_same_state(port, ref):
    assert port.method.iteration == ref.method.iteration
    np.testing.assert_allclose(port.voltage.magnitude,
                               np.asarray(ref.voltage.magnitude), **STATE_TOL)
    np.testing.assert_allclose(port.voltage.angle,
                               np.asarray(ref.voltage.angle), **STATE_TOL)


@pytest.mark.parametrize("case", ["case14test", "case30test"])
@pytest.mark.parametrize("kind", ["LU", "KLU", "QR"])
def test_newton_raphson_matches_goldens_and_jax(data_path, case, kind):
    path = str(data_path / f"{case}.m")
    golden = h5group(data_path / "results.h5", f"{case}/newtonRaphson")

    system = jgt.power_system(path)
    jgt.ac_model(system)
    analysis = jgt.newton_raphson(system, kind, device="cpu")
    jgt.power_flow(analysis)
    assert analysis.method.converged
    assert_voltage(golden, analysis)

    ref = jg.newton_raphson(jg.power_system(path), kind)
    jg.power_flow(ref)
    _assert_same_state(analysis, ref)


def test_newton_raphson_matches_jax_pegase(data_path):
    path = str(data_path / "case1354pegase.h5")
    analysis = jgt.newton_raphson(jgt.power_system(path), device="cpu")
    jgt.power_flow(analysis)
    ref = jg.newton_raphson(jg.power_system(path))
    jg.power_flow(ref)
    assert analysis.method.converged and ref.method.converged
    _assert_same_state(analysis, ref)


def test_stepwise_api(data_path):
    """Reference mismatch!/solve! stepwise loop."""
    system = jgt.power_system(str(data_path / "case14test.m"))
    analysis = jgt.newton_raphson(system, device="cpu")
    for _ in range(20):
        dp, dq = mismatch(analysis)
        if dp < 1e-8 and dq < 1e-8:
            break
        solve(analysis)
    assert dp < 1e-8 and dq < 1e-8
    golden = h5group(data_path / "results.h5", "case14test/newtonRaphson")
    assert analysis.method.iteration == int(golden["iteration"][0])


def test_newton_raphson_powers(data_path):
    system = jgt.power_system(str(data_path / "case14test.m"))
    golden = h5group(data_path / "results.h5", "case14test/newtonRaphson")
    analysis = jgt.newton_raphson(system, device="cpu")
    jgt.power_flow(analysis, power=True)
    ac_current(analysis)
    assert_power(golden, analysis)
    assert_bus_balance(analysis)
    jgt.power_flow(analysis, current=True)
    np.testing.assert_allclose(analysis.current.injection.magnitude,
                               np.abs(system.model.ac.nodal.dot(
                                   analysis.voltage.magnitude
                                   * np.exp(1j * analysis.voltage.angle))),
                               atol=1e-12)


def test_verbose_stepwise_branch(data_path, capsys):
    """verbose >= 2 runs the stepwise loop with the reference's log and
    reaches the golden iteration count and state."""
    system = jgt.power_system(str(data_path / "case14test.m"))
    golden = h5group(data_path / "results.h5", "case14test/newtonRaphson")
    analysis = jgt.newton_raphson(system, device="cpu")
    jgt.power_flow(analysis, verbose=2)
    out = capsys.readouterr().out
    assert analysis.method.converged
    assert_voltage(golden, analysis)
    assert "EXIT" in out.upper()


def test_refresh_after_edit_and_warm_start(data_path):
    """Signature protocol: an edited system rebuilds the device snapshot;
    the warm-started solve matches a fresh analysis of the edited system."""
    from juliagrid_tpu_torch.system.builders import update_bus
    path = str(data_path / "case14test.m")
    system = jgt.power_system(path)
    analysis = jgt.newton_raphson(system, device="cpu")
    jgt.power_flow(analysis)
    arrays = analysis.arrays
    update_bus(system, system.bus.label.label(13), active=0.2,
               reactive=0.1)
    jgt.power_flow(analysis)
    assert analysis.arrays is not arrays
    fresh = jgt.newton_raphson(system, device="cpu")
    jgt.set_initial_point(fresh, analysis)
    jgt.power_flow(fresh)
    assert fresh.method.iteration == 0
    cold = jgt.newton_raphson(system, device="cpu")
    jgt.power_flow(cold)
    np.testing.assert_allclose(analysis.voltage.magnitude,
                               cold.voltage.magnitude, atol=1e-8)
    start = jgt.newton_raphson(system, device="cpu").voltage.magnitude
    jgt.set_initial_point(fresh)
    np.testing.assert_array_equal(fresh.voltage.magnitude, start)


def test_power_flow_refuses_unported_methods(data_path):
    system = jgt.power_system(str(data_path / "case14test.m"))
    with pytest.raises(NotImplementedError, match="Newton-Raphson"):
        jgt.power_flow(object())
    analysis = jgt.newton_raphson(system, device="cpu")
    analysis.method.name = "newton_raphson_sparse"
    with pytest.raises(ValueError, match="unknown method"):
        jgt.power_flow(analysis)


@pytest.mark.parametrize("spread", [0.05, 0.5])
def test_batched_nr_solve_matches_jax(data_path, spread):
    """64 scenarios of case14 in lockstep: per-scenario iteration counts,
    converged flags and converged states equal the JAX package's fleet. At
    a spread of 0.5 the scenarios stop after 7, 8 and 9 iterations and some
    hit the cap, so only the active ones may advance."""
    path = str(data_path / "case14test.m")
    ref = jg.newton_raphson(jg.power_system(path))
    arr = jgt.newton_raphson(jgt.power_system(path), device="cpu").arrays
    nscen = 64
    rng = np.random.default_rng(0)
    scale = 1.0 + spread * rng.standard_normal((nscen, 1))
    vm0 = np.tile(ref.voltage.magnitude, (nscen, 1))
    va0 = np.tile(ref.voltage.angle, (nscen, 1))
    ps = np.asarray(ref.arrays.p_sched)[None, :] * scale
    qs = np.asarray(ref.arrays.q_sched)[None, :] * scale

    want = batched_nr_solve_jit(ref.arrays, *(jnp.asarray(x)
                                              for x in (vm0, va0, ps, qs)),
                                tol=1e-8, max_iter=20)
    got = batched_nr_solve(arr, *(torch.from_numpy(x)
                                  for x in (vm0, va0, ps, qs)),
                           tol=1e-8, max_iter=20)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    conv = got[3].numpy()
    assert conv.all() if spread < 0.1 else len(set(got[2].tolist())) > 2
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy()[conv], np.asarray(w)[conv],
                                   **STATE_TOL)


def test_batched_nr_solve_survives_a_singular_scenario(data_path):
    """Four case14 scenarios, the second started at zero magnitudes so its
    Jacobian is singular: it runs to the cap unconverged, as in the JAX
    package, and the three others converge to the JAX package's states."""
    path = str(data_path / "case14test.m")
    ref = jg.newton_raphson(jg.power_system(path))
    arr = jgt.newton_raphson(jgt.power_system(path), device="cpu").arrays
    vm0 = np.tile(ref.voltage.magnitude, (4, 1))
    vm0[1, :] = 0.0
    va0 = np.tile(ref.voltage.angle, (4, 1))
    ps = np.tile(np.asarray(ref.arrays.p_sched), (4, 1))
    qs = np.tile(np.asarray(ref.arrays.q_sched), (4, 1))
    want = batched_nr_solve_jit(ref.arrays, *(jnp.asarray(x)
                                              for x in (vm0, va0, ps, qs)),
                                tol=1e-8, max_iter=20)
    got = batched_nr_solve(arr, *(torch.from_numpy(x)
                                  for x in (vm0, va0, ps, qs)))
    assert got[2].tolist() == np.asarray(want[2]).tolist() == [7, 20, 7, 7]
    assert got[3].tolist() == np.asarray(want[3]).tolist() == [True, False,
                                                               True, True]
    good = [0, 2, 3]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy()[good], np.asarray(w)[good],
                                   **STATE_TOL)
    with pytest.raises(RuntimeError, match="zero"):
        _nr_solve(arr, torch.from_numpy(vm0[1]), torch.from_numpy(va0[1]),
                  1e-8, 20, "LU")


def test_iteration_cap_matches_jax(data_path):
    """Two solves and no more: unconverged, at the JAX package's state."""
    path = str(data_path / "case14test.m")
    analysis = jgt.newton_raphson(jgt.power_system(path), device="cpu")
    jgt.power_flow(analysis, iteration=2)
    ref = jg.newton_raphson(jg.power_system(path))
    jg.power_flow(ref, iteration=2)
    assert not analysis.method.converged and not ref.method.converged
    assert analysis.method.iteration == 2
    _assert_same_state(analysis, ref)
    np.testing.assert_allclose(analysis.method.max_mismatch_active,
                               ref.method.max_mismatch_active, rtol=1e-9)


@pytest.mark.parametrize("kind", ["LU", "KLU", "QR", "LL", "LDLt"])
def test_linalg_tags_solve_batches(kind):
    """Every factorization tag solves a batch of SPD systems in f64."""
    from juliagrid_tpu_torch.ops import linalg
    rng = np.random.default_rng(11)
    a = rng.standard_normal((3, 9, 9))
    a = a @ a.transpose(0, 2, 1) + 9.0 * np.eye(9)
    b = rng.standard_normal((3, 9))
    x = linalg.solve(linalg.factorize(torch.from_numpy(a), kind),
                     torch.from_numpy(b))
    want = np.linalg.solve(a, b[..., None])[..., 0]
    np.testing.assert_allclose(x.numpy(), want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="unknown"):
        linalg.factorize(torch.from_numpy(a), "PW")
