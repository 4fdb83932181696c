#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (juliagrid_tpu_torch) on one card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernel K1 (``nr_fill``) from the sources in the
checkout, holds it against its plain PyTorch version, and drives the
Newton-Raphson main path — ``power_system`` -> ``newton_raphson`` ->
``power_flow`` — on a 10,000-bus grid, checked against the independent
scipy oracle; then a 1024-scenario case118 fleet. Every phase prints one
line; any failure exits non-zero. The grid is ``synthetic_grid(100, 100)``:
the ACTIVSg10k case ships as HDF5 and the card's machine has no h5py.

The second-last lines are the card's ``nvidia-smi`` name and power limit
and a JSON object with each kernel's launches on the main path, error
against its plain version and times; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from juliagrid_tpu_torch import newton_raphson, power_flow, power_system
from juliagrid_tpu_torch.kernels import nr_fill as k1
from juliagrid_tpu_torch.oracle import oracle_nr
from juliagrid_tpu_torch.parallel import batched_nr_solve
from juliagrid_tpu_torch.powerflow.ac import (_max_mismatch, _nr_solve,
                                              _nr_update, compile_ac_arrays)
from juliagrid_tpu_torch.utils.synthetic import synthetic_grid

DATA = Path(__file__).resolve().parent / "tests" / "data"
SEED = 0
GRID = (100, 100)          # 10,000 buses
FLEET = 1024               # case118 scenarios (bench config 1's shape)
K1_REL_TOL = 1e-12         # |kernel - plain| <= tol * max(1, |plain|)
SMALL_STATE_TOL = 1e-9     # case14/30 against the oracle
GRID_STATE_TOL = 1e-8      # 10k grid against the oracle
TWIN_STATE_TOL = 1e-10     # a solve against the same solve on nr_fill_ref
TOL = 1e-8                 # NR mismatch tolerance (power_flow default)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(fn):
    """Host seconds of ``fn`` up to the device finishing its work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def random_inputs(arr, n, batch, rng):
    dev = arr.cols.device
    vm = torch.tensor(1.0 + 0.05 * rng.standard_normal((batch, n)), device=dev)
    va = torch.tensor(0.2 * rng.standard_normal((batch, n)), device=dev)
    scale = torch.tensor(1.0 + 0.05 * rng.standard_normal((batch, 1)),
                         device=dev)
    return vm, va, arr.p_sched[None] * scale, arr.q_sched[None] * scale


def compare_k1(label, arr, inputs):
    """Phase 1: K1 against nr_fill_ref on the same inputs."""
    got = k1.nr_fill(arr, *inputs, jacobian=True)
    ref = k1.nr_fill_ref(arr, *inputs, jacobian=True)
    torch.cuda.synchronize()
    worst_rel = worst_abs = 0.0
    for name in ("p", "q", "mp", "mq", "jac"):
        a, b = getattr(got, name), getattr(ref, name)
        diff = (a - b).abs()
        worst_abs = max(worst_abs, diff.max().item())
        worst_rel = max(worst_rel, (diff / b.abs().clamp(min=1.0)).max().item())
        del diff
    check(worst_rel <= K1_REL_TOL,
          f"{label}: K1 disagrees with nr_fill_ref, rel {worst_rel:.3e}")
    check(torch.equal(got.jac != 0, ref.jac != 0),
          f"{label}: K1 Jacobian pattern differs from nr_fill_ref")
    del got, ref
    ms = cuda_ms(lambda: k1.nr_fill(arr, *inputs, jacobian=True), reps=20)
    plain_ms = cuda_ms(lambda: k1.nr_fill_ref(arr, *inputs, jacobian=True),
                       reps=5)
    b, n = inputs[0].shape
    print(f"phase 1 {label} B={b} n={n}: max abs diff {worst_abs!r}, "
          f"max rel diff {worst_rel!r}, pattern equal; "
          f"K1 {ms!r} ms, nr_fill_ref {plain_ms!r} ms per call (jacobian)")
    return worst_abs, ms, plain_ms


def check_against_oracle(label, analysis, oracle, tol):
    dvm = float(np.abs(analysis.voltage.magnitude - oracle.magnitude).max())
    # the oracle returns angles wrapped into (-pi, pi]; on a large grid the
    # port's unwrapped angles pass pi, so compare them modulo 2 pi
    dang = analysis.voltage.angle - oracle.angle
    dva = float(np.abs((dang + np.pi) % (2 * np.pi) - np.pi).max())
    check(analysis.method.converged and oracle.converged,
          f"{label}: not converged")
    check(analysis.method.iteration == oracle.iterations,
          f"{label}: {analysis.method.iteration} iterations, oracle "
          f"{oracle.iterations}")
    check(dvm <= tol and dva <= tol,
          f"{label}: |dvm| {dvm:.3e}, |dva| {dva:.3e} over {tol}")
    return dvm, dva


def timed_split(arr, vm, va, kind="LU"):
    """The loop of ``_nr_solve`` built from its own pieces, with CUDA events
    around K1, the LU factor+solve+update, and the mismatch readback (its
    amax kernels, the copy to the host and the host's round trip)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    split = {"K1": 0.0, "LU": 0.0, "readback": 0.0}
    vm, va = vm[None], va[None]
    ps, qs = arr.p_sched[None], arr.q_sched[None]
    it = 0
    while True:
        ev[0].record()
        res = k1.nr_fill(arr, vm, va, ps, qs, jacobian=True)
        ev[1].record()
        del_p, del_q = _max_mismatch(res)[0].tolist()
        ev[2].record()
        done = (del_p < TOL and del_q < TOL) or it >= 20
        if not done:
            ev[3].record()
            vm, va = _nr_update(arr, vm, va, res, kind)
            ev[4].record()
            it += 1
        torch.cuda.synchronize()
        split["K1"] += ev[0].elapsed_time(ev[1])
        split["readback"] += ev[1].elapsed_time(ev[2])
        if done:
            return it, split
        split["LU"] += ev[3].elapsed_time(ev[4])


def phase0():
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false: the smoke run needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    k1._library()
    build_s = time.perf_counter() - t0
    print(f"phase 0 device: {torch.cuda.get_device_name(0)} ({card}), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"K1 build+load {build_s!r} s")
    return card


def phase1():
    rng = np.random.default_rng(SEED)
    grid = synthetic_grid(*GRID)
    arr = compile_ac_arrays(grid, "cuda")
    err_grid, ms, plain_ms = compare_k1(
        "10k grid", arr, random_inputs(arr, grid.bus.number, 1, rng))
    case118 = power_system(str(DATA / "case118.m"))
    arr118 = compile_ac_arrays(case118, "cuda")
    err_118, _, _ = compare_k1(
        "case118 fleet", arr118,
        random_inputs(arr118, case118.bus.number, FLEET, rng))
    return max(err_grid, err_118), ms, plain_ms


def phase2():
    for case in ("case14test", "case30test"):
        path = str(DATA / f"{case}.m")
        analysis = newton_raphson(power_system(path), device="cuda")
        power_flow(analysis)
        oracle = oracle_nr(power_system(path))
        dvm, dva = check_against_oracle(case, analysis, oracle,
                                        SMALL_STATE_TOL)
        print(f"phase 2 {case}: {analysis.method.iteration} iterations "
              f"(oracle {oracle.iterations}), max |dvm| {dvm!r}, "
              f"max |dva| {dva!r}")


def phase3():
    torch.cuda.reset_peak_memory_stats()
    k1.nr_fill.launches = 0
    t0 = time.perf_counter()
    system = synthetic_grid(*GRID)
    t1 = time.perf_counter()
    analysis = newton_raphson(system, device="cuda")
    vm0, va0 = analysis._state()
    t2 = time.perf_counter()
    power_flow(analysis, power=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = k1.nr_fill.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n = system.bus.number
    check(launches == analysis.method.iteration + 1,
          f"K1 launched {launches} times for "
          f"{analysis.method.iteration} iterations")
    oracle = oracle_nr(synthetic_grid(*GRID))
    dvm, dva = check_against_oracle("10k grid", analysis, oracle,
                                    GRID_STATE_TOL)
    pw = analysis.power
    arr = analysis.arrays
    inj_p = pw.injection.active
    inj_q = pw.injection.reactive
    check(inj_p.shape == (n,) and np.all(np.isfinite(inj_p))
          and np.all(np.isfinite(inj_q)), "10k grid: bad power results")
    not_slack = np.arange(n) != arr.slack
    is_pq = arr.bus_type.cpu().numpy() == 1
    dp = np.abs(inj_p - arr.p_sched.cpu().numpy())[not_slack].max()
    dq = np.abs(inj_q - arr.q_sched.cpu().numpy())[is_pq].max()
    check(dp < TOL and dq < TOL,
          f"10k grid: injections miss the schedule by {dp:.3e}, {dq:.3e}")
    print(f"phase 3 10k-bus main path: n={n}, converged in "
          f"{analysis.method.iteration} iterations (oracle "
          f"{oracle.iterations}), max |dvm| {dvm!r}, max |dva| {dva!r}, "
          f"K1 launches {launches}; wall: power_system {t1 - t0!r} s, "
          f"newton_raphson {t2 - t1!r} s, power_flow(power=True) "
          f"{t3 - t2!r} s; peak device memory {peak_gb!r} GB")

    it, split = timed_split(arr, vm0, va0)
    check(it == analysis.method.iteration,
          f"10k grid: the timed loop took {it} iterations")
    print(f"phase 3 per-iteration split over {it} iterations (CUDA events): "
          f"K1 {split['K1'] / (it + 1)!r} ms per launch ({it + 1} launches), "
          f"LU factor+solve+update {split['LU'] / it!r} ms, "
          f"mismatch readback {split['readback'] / (it + 1)!r} ms")

    runs = []
    for fill in (k1.nr_fill, k1.nr_fill_ref, k1.nr_fill_ref, k1.nr_fill):
        runs.append(wall_s(lambda: _nr_solve(arr, vm0, va0, TOL, 20, "LU",
                                             fill=fill)))
    ker, ref = runs[0][1], runs[1][1]
    check(ker[2] == ref[2] == analysis.method.iteration,
          "10k grid: K1 and nr_fill_ref solves differ in iterations")
    check(torch.allclose(ker[0], ref[0], rtol=0, atol=TWIN_STATE_TOL)
          and torch.allclose(ker[1], ref[1], rtol=0, atol=TWIN_STATE_TOL),
          "10k grid: K1 and nr_fill_ref solves differ in state")
    print("phase 3 _nr_solve wall (K1, nr_fill_ref, nr_fill_ref, K1): "
          + ", ".join(f"{seconds!r} s" for seconds, _ in runs))
    return launches


def phase4():
    system = power_system(str(DATA / "case118.m"))
    analysis = newton_raphson(system, device="cuda")
    arr = analysis.arrays
    vm, va = analysis._state()
    rng = np.random.default_rng(0)
    scale = torch.tensor(1.0 + 0.05 * rng.standard_normal((FLEET, 1)),
                         device=vm.device)
    inputs = (vm.expand(FLEET, -1).contiguous(),
              va.expand(FLEET, -1).contiguous(),
              arr.p_sched[None] * scale, arr.q_sched[None] * scale)
    batched_nr_solve(arr, *inputs)      # warm-up: cuSOLVER's batched setup
    runs = []
    for fill in (k1.nr_fill, k1.nr_fill_ref, k1.nr_fill_ref, k1.nr_fill):
        seconds, out = wall_s(lambda: batched_nr_solve(arr, *inputs,
                                                       fill=fill))
        runs.append((fill is k1.nr_fill, seconds, out))
    ker = runs[0][2]
    ref = runs[1][2]
    check(bool(ker[3].all()),
          f"fleet: {int((~ker[3]).sum())} of {FLEET} did not converge")
    check(torch.equal(ker[2], ref[2]) and torch.equal(ker[3], ref[3]),
          "fleet: iteration counts differ from the nr_fill_ref run")
    dstate = max((ker[0] - ref[0]).abs().max().item(),
                 (ker[1] - ref[1]).abs().max().item())
    check(dstate <= TWIN_STATE_TOL, f"fleet: state differs by {dstate:.3e}")
    total = int(ker[2].sum())
    rates = [(("K1" if is_k1 else "nr_fill_ref"), total / s)
             for is_k1, s, _ in runs]
    print(f"phase 4 case118 fleet x{FLEET}: all converged, "
          f"{total} NR iterations (max {int(ker[2].max())}), state vs "
          f"nr_fill_ref {dstate!r}; NR iterations/s "
          + ", ".join(f"{name} {rate!r}" for name, rate in rates))


def main():
    card = phase0()
    max_err, ms, plain_ms = phase1()
    phase2()
    launches = phase3()
    phase4()
    print(card)
    print(json.dumps({"kernels": [{
        "name": "nr_fill", "route": "cuda",
        "source": "juliagrid_tpu_torch/kernels/csrc/nr_fill.cu",
        "replaces": "juliagrid_tpu/powerflow/ac.py:92",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
