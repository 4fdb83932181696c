"""The port's multi-device path (``parallel/mesh.py``) on the CPU: gloo ranks
started by ``launch``, against the JAX package's mesh code on a 4-device
mesh of conftest's virtual CPU devices and against the port's unsharded
solves.

The ranks' bodies are module-level functions (a spawned rank imports this
module by name), and JAX is imported only inside the tests that compare
with it, so a rank stays light. Every path also checks that all ranks
return the same bits.

Tolerances, each with its reason:
- sharded NR/SE fleets against the port's unsharded batched solves: 1e-12
  (the same loop on a share of the scenarios; a batched LU or Cholesky of
  another batch size may round differently) and the same counts;
- against the JAX package: the same counts, NR states 1e-10, SE states 1e-8
  (the JAX package factors the gain in f32 and refines, the port in f64;
  tests/test_torch_se.py);
- ``bbd_solve_sharded`` against the JAX one and ``np.linalg.solve``: 1e-8
  (tests/test_bbd.py's);
- the AC OPF over a block mesh against the JAX mesh mode and the port's
  unsharded ``kkt_blocks=4``: the same status, objective 1e-8 relative, x
  1e-6, one step's dx 1e-8 of its scale (the Schur sum runs in another
  order over the ranks; ``chip_smoke.py`` phase 18's BBD gates).
"""

import numpy as np
import pytest
import torch

import juliagrid_tpu_torch as jgt
from juliagrid_tpu_torch.entry import CASE, dryrun_multichip
from juliagrid_tpu_torch.estimation.acse import compile_se_arrays
from juliagrid_tpu_torch.opf import acopf, ipm, kkt_bbd
from juliagrid_tpu_torch.ops.bbd import (bbd_partition, bbd_solve,
                                         bbd_solve_sharded, build_bbd_arrays)
from juliagrid_tpu_torch.parallel import (batched_nr_solve, batched_se_solve,
                                          launch, scenario_mesh,
                                          sharded_nr_solve, sharded_se_solve)
from juliagrid_tpu_torch.parallel.mesh import backend_for
from juliagrid_tpu_torch.utils.synthetic import synthetic_grid

RANKS = 4
TIMEOUT = 240.0          # s, a launch's deadline here
OPF_GRID = (6, 8)        # the JAX dry run's AC OPF
DC_GRID = (8, 12)        # tests/test_bbd.py's DC fixture
STEP_SEED = 5


def _fleet_inputs(nscen):
    """The JAX dry run's fleets on case14test, in numpy: NR at 5% scale
    noise on P and Q, SE means from noiseless meters with 0.1 sigma of
    noise (seed 0); and the meters' weights."""
    system = jgt.power_system(str(CASE))
    pf = jgt.newton_raphson(system, device="cpu")
    arr = pf.arrays
    rng = np.random.default_rng(0)
    n = system.bus.number
    scale = 1.0 + 0.05 * rng.standard_normal((nscen, 1))
    nr = (np.tile(pf.voltage.magnitude, (nscen, 1)),
          np.tile(pf.voltage.angle, (nscen, 1)),
          arr.p_sched.numpy()[None] * scale, arr.q_sched.numpy()[None] * scale)
    jgt.power_flow(pf, power=True)
    host = compile_se_arrays(system, _meters(system, pf), return_host=True,
                             device="cpu")[3]
    means = host.mean[None] + 0.1 / np.sqrt(host.w)[None] * \
        rng.standard_normal((nscen, host.mean.shape[0]))
    se = (np.tile(system.bus.voltage.magnitude.array[:n], (nscen, 1)),
          np.tile(system.bus.voltage.angle.array[:n], (nscen, 1)), means)
    return nr, se, host.w


def _meters(system, pf, pkg=jgt):
    mon = pkg.measurement(system)
    for add in (pkg.add_voltmeter, pkg.add_wattmeter, pkg.add_varmeter):
        add(mon, analysis=pf, noise=False)
    return mon


def _port_fleet_arrays(device):
    system = jgt.power_system(str(CASE))
    pf = jgt.newton_raphson(system, device=device)
    jgt.power_flow(pf, power=True)
    se_arr = compile_se_arrays(system, _meters(system, pf),
                               device=device)[0]
    return pf.arrays, se_arr, jgt.powerflow.ac.compile_ac_arrays(system,
                                                                 device)


def _dc_system():
    """tests/test_bbd.py's slack-masked DC nodal matrix and injections,
    and its bus graph."""
    system = synthetic_grid(*DC_GRID)
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
    return a, rhs, adj


def _opf_step(analysis, kkt, seed):
    """One interior-point step's dx through ``kkt`` at a seeded point near
    the analysis's start."""
    spec = analysis._spec
    rng = np.random.default_rng(seed)
    dev = spec.arrays.rows.device
    x = torch.as_tensor(analysis._x0 + 0.01 * rng.standard_normal(spec.n_x),
                        device=dev)
    y = torch.as_tensor(rng.standard_normal(spec.m_e), device=dev)
    z = torch.as_tensor(rng.uniform(0.5, 2.0, spec.m_i), device=dev)
    s = torch.as_tensor(rng.uniform(0.5, 2.0, spec.m_i), device=dev)
    unit = {"sf": 1.0, "ge": None, "gi": None}
    fns = ipm._make_fns(spec.objective, spec.eq, spec.ineq, spec.n_x,
                        spec.m_e, spec.m_i,
                        kkt_solve=lambda *a: kkt.solve(*a, unit))
    return fns.step(x, y, z, s, 0.1, 1e-6, spec.eq(x), spec.ineq(x) - s)[0]


def _opf_analysis(device):
    return acopf.ac_optimal_power_flow(synthetic_grid(*OPF_GRID, opf=True),
                                       device=device)


def _opf_run(device, blocks, mesh=None):
    analysis = _opf_analysis(device)
    acopf.solve(analysis, kkt_blocks=blocks, kkt_mesh=mesh, max_iter=60,
                tolerance=1e-7)
    res = analysis.method.result
    return {"status": res.status, "iterations": res.iterations,
            "objective": res.objective, "x": res.x, "y": res.y, "z": res.z}


def _rank_paths(mesh, nr, se):
    """One rank: the sharded fleets, the sharded Schur solve, the AC OPF
    over a block mesh (twice, and one step), and the error paths."""
    dev = mesh.device
    arr, se_arr, net = _port_fleet_arrays(dev)
    out = {"nr": [t.cpu() for t in sharded_nr_solve(
        mesh, arr, *(torch.as_tensor(v) for v in nr))],
        "se": [t.cpu() for t in sharded_se_solve(
            mesh, se_arr, net, *(torch.as_tensor(v) for v in se))]}
    bmesh = mesh.renamed("block")
    a, rhs, adj = _dc_system()
    bbd = build_bbd_arrays(a, *bbd_partition(adj, mesh.size), device=dev)
    out["bbd"] = bbd_solve_sharded(bmesh, bbd, torch.as_tensor(rhs)).cpu()
    out["opf"] = [_opf_run(dev, mesh.size, bmesh) for _ in range(2)]
    analysis = _opf_analysis(dev)
    spec = analysis._spec
    out["step"] = _opf_step(analysis, kkt_bbd.AcKktBbd(spec, mesh.size,
                                                       mesh=bmesh),
                            STEP_SEED).cpu()
    errors = {}
    for name, call in (
            ("blocks", lambda: kkt_bbd.AcKktBbd(spec, mesh.size - 1,
                                                mesh=bmesh)),
            ("clock", lambda: acopf.solve(analysis, kkt_blocks=mesh.size,
                                          kkt_mesh=bmesh, max_seconds=1.0)),
            ("rows", lambda: sharded_nr_solve(
                mesh, arr, *(torch.as_tensor(v[:mesh.size + 2])
                             for v in nr)))):
        try:
            call()
        except ValueError as exc:
            errors[name] = str(exc)
    out["errors"] = errors
    return out


def _rank_fails(mesh):
    """Rank 1 raises; rank 0 waits in a barrier for it."""
    if mesh.rank == 1:
        raise ArithmeticError("rank 1 fails on purpose")
    mesh.barrier()


@pytest.fixture(scope="module")
def inputs():
    return _fleet_inputs(2 * RANKS)


@pytest.fixture(scope="module")
def ranks(inputs):
    nr, se, _ = inputs
    return launch(_rank_paths, RANKS, device="cpu", args=(nr, se),
                  timeout=TIMEOUT)


def _same_bits(values):
    """Every rank's results (tensors, arrays, numbers, and lists and dicts
    of them) equal bit for bit."""
    first = values[0]
    for other in values[1:]:
        assert type(first) is type(other)
        if isinstance(first, dict):
            assert first.keys() == other.keys()
            for key in first:
                _same_bits([first[key], other[key]])
        elif isinstance(first, (list, tuple)):
            assert len(first) == len(other)
            for a, b in zip(first, other):
                _same_bits([a, b])
        elif isinstance(first, (torch.Tensor, np.ndarray)):
            a, b = (np.asarray(t) for t in (first, other))
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
        else:
            assert first == other


@pytest.mark.parametrize("path", ["nr", "se"])
def test_sharded_fleet_matches_jax_and_unsharded(ranks, inputs, path):
    """The sharded NR and SE fleets on 4 gloo ranks against the port's
    unsharded batched solve (1e-12, the same counts) and the JAX package's
    sharded solve on a 4-device mesh (the same counts; NR 1e-10, SE
    1e-8); every rank returns the same bits."""
    import jax
    import jax.numpy as jnp

    import juliagrid_tpu as jg
    from juliagrid_tpu.estimation.acse import compile_se_arrays as jcompile
    from juliagrid_tpu.parallel.batch import (scenario_mesh as jmesh,
                                              sharded_nr_solve as jnr,
                                              sharded_se_solve as jse)

    _same_bits([r[path] for r in ranks])
    got = ranks[0][path]
    arr, se_arr, net = _port_fleet_arrays("cpu")
    nr, se, weights = inputs
    if path == "nr":
        want = batched_nr_solve(arr, *(torch.as_tensor(v) for v in nr))
    else:
        want = batched_se_solve(se_arr, net, *(torch.as_tensor(v)
                                               for v in se))
    assert bool(got[3].all())
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12)

    system = jg.power_system(str(CASE))
    pf = jg.newton_raphson(system)
    mesh = jmesh(RANKS)
    assert mesh.devices.size == RANKS and len(jax.devices()) >= RANKS
    if path == "nr":
        ref = jnr(mesh, pf.arrays, *(jnp.asarray(v) for v in nr))
        tol = 1e-10
    else:
        jg.power_flow(pf, power=True)
        jarr, _, _, host = jcompile(system, _meters(system, pf, jg),
                                    return_host=True)
        np.testing.assert_allclose(host.w, weights, rtol=1e-14)
        ref = jse(mesh, jarr, jg.powerflow.ac.compile_ac_arrays(system),
                  *(jnp.asarray(v) for v in se))
        tol = 1e-8
    assert np.array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert np.array_equal(got[3].numpy(), np.asarray(ref[3]))
    for g, w in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol)


def test_bbd_solve_sharded_matches_jax(ranks):
    """``bbd_solve_sharded`` at 4 blocks on 4 ranks against the JAX one on
    a 4-device block mesh, the port's unsharded ``bbd_solve`` and
    ``np.linalg.solve``: 1e-8."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from juliagrid_tpu.ops.bbd import (bbd_partition as jpartition,
                                       bbd_solve_sharded as jsolve,
                                       build_bbd_arrays as jbuild)

    _same_bits([r["bbd"] for r in ranks])
    got = ranks[0]["bbd"].numpy()
    a, rhs, adj = _dc_system()
    np.testing.assert_allclose(got, np.linalg.solve(a, rhs), rtol=0,
                               atol=1e-8)
    block_of, border = bbd_partition(adj, RANKS)
    unsharded = bbd_solve(build_bbd_arrays(a, block_of, border,
                                           device="cpu"),
                          torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(got, unsharded, rtol=0, atol=1e-8)
    jblock_of, jborder = jpartition(adj, RANKS)
    assert np.array_equal(jblock_of, block_of)
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("block",))
    ref = jsolve(mesh, jbuild(a, jblock_of, jborder), jnp.asarray(rhs))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-8)


def test_acopf_kkt_mesh_matches_jax_and_unsharded(ranks):
    """The 6x8 AC OPF with ``kkt_blocks=4`` over a 4-rank block mesh against
    the JAX package's mesh mode on a 4-device mesh and the port's unsharded
    ``kkt_blocks=4``: the same status, objective 1e-8 relative, x 1e-6; one
    step's dx 1e-8 of its scale; two mesh solves give the same bits, and
    every rank the same bits."""
    import jax
    from jax.sharding import Mesh

    from juliagrid_tpu.opf import acopf as jacopf
    from juliagrid_tpu.utils.synthetic import synthetic_grid as jgrid

    _same_bits([r["opf"] + [r["step"]] for r in ranks])
    first, again = ranks[0]["opf"]
    _same_bits([first, again])
    want = _opf_run("cpu", RANKS)
    assert first["status"] == want["status"]
    assert first["status"] in ("optimal", "acceptable")
    assert abs(first["objective"] - want["objective"]) <= \
        1e-8 * max(1.0, abs(want["objective"]))
    np.testing.assert_allclose(first["x"], want["x"], rtol=0, atol=1e-6)

    analysis = _opf_analysis("cpu")
    step = _opf_step(analysis, kkt_bbd.AcKktBbd(analysis._spec, RANKS),
                     STEP_SEED)
    scale = max(1.0, step.abs().max().item())
    assert (ranks[0]["step"] - step).abs().max().item() <= 1e-8 * scale

    ref = jacopf.ac_optimal_power_flow(jgrid(*OPF_GRID, opf=True))
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("block",))
    jacopf.solve(ref, kkt_blocks=RANKS, kkt_mesh=mesh, max_iter=60,
                 tolerance=1e-7)
    res = ref.method.result
    assert first["status"] == res.status
    assert abs(first["objective"] - res.objective) <= \
        1e-8 * max(1.0, abs(res.objective))
    np.testing.assert_allclose(first["x"], np.asarray(res.x), rtol=0,
                               atol=1e-6)


def test_mesh_errors(ranks, monkeypatch):
    """A block count other than the axis size, and scenarios that do not
    divide over the ranks, raise as the JAX package's checks do; a
    wall-clock budget over a mesh raises; a mesh needs a process group and
    this process has none; nccl takes one card a rank; the launcher and
    the dry run default to the card and raise without one."""
    errors = ranks[0]["errors"]
    assert "must equal mesh axis 'block' size 4" in errors["blocks"]
    assert "max_seconds cannot bound a solve over a mesh" in errors["clock"]
    assert "do not divide over the 4 ranks" in errors["rows"]
    with pytest.raises(RuntimeError, match="init_process_group"):
        scenario_mesh(device="cpu")
    with pytest.raises(ValueError, match="cards"):
        launch(_rank_fails, 2, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        launch(_rank_fails, 2, backend="mpi", device="cpu")
    assert backend_for(4, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)


def test_a_failing_rank_fails_the_launch():
    """Rank 1 raises while rank 0 waits for it in a barrier: the launch
    raises with rank 1's error long before its deadline, and stops rank
    0."""
    from torch.multiprocessing import ProcessRaisedException
    import time

    t0 = time.monotonic()
    with pytest.raises(ProcessRaisedException, match="on purpose"):
        launch(_rank_fails, 2, device="cpu", timeout=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT / 2


def test_dryrun_multichip_on_two_cpu_ranks():
    """``dryrun_multichip(2, device="cpu")``: the JAX dry run's four paths
    and checks on two gloo ranks, each rank the same bits."""
    out = dryrun_multichip(2, device="cpu", timeout=TIMEOUT)
    _same_bits(out)
    assert out[0]["opf"]["status"] in ("optimal", "acceptable")
    assert bool(out[0]["se"][3].all()) and out[0]["bbd_residual"] < 1e-8
