"""The frozen roofline counts of ``metrics/`` at small shapes, against the
arrays each kernel's inputs and outputs are, written out by hand; and the
sizes the entries give them, by hand on three buses and against the
reference's dense Jacobians at case118."""

import importlib.util

import numpy as np
import pytest
import torch

from portbench.reference import grid as ref
from portbench.reference.case import Case, load_case
from portbench.reference.grid import MeasurementSet
from portbench.spec import Spec

from .conftest import ROOT

CASE118 = ROOT / "portbench" / "data" / "case118.m"
VARIANCES = dict(voltmeter=1e-4, wattmeter=1e-4, varmeter=1e-4,
                 pmu_magnitude=1e-8, pmu_angle=1e-8)


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"count_{name}", ROOT / "portbench" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_k1():
    # 2 scenarios, 3 buses, 7 Y entries, 3 unknowns, 9 Jacobian entries
    # over them: Y as 7 complex values (16 B) and 7 int32 columns, 4 int32
    # row pointers, 3 int32 types; each scenario reads vm, va (2 x 3
    # doubles) and P, Q at the 3 equations, writes the 3 mismatches and
    # the 9 entries
    shared = 7 * 16 + 7 * 4 + 4 * 4 + 3 * 4
    each = 2 * 3 * 8 + 3 * 8 + 3 * 8 + 9 * 8
    assert reader("k1_roofline").count(2, 3, 7, 3, 9) == (shared + 2 * each,
                                                          2 * 7 * 22)


def test_k2_lu():
    # 3 systems of order 4: A (16 doubles), b (4) read, x (4), info written;
    # 2 * 64 / 3 + 2 * 16 operations each
    nbytes, flops = reader("k2_lu_roofline").count(3, 4)
    assert nbytes == 3 * (16 * 8 + 4 * 8 + 4 * 8 + 4)
    assert abs(flops - 3 * (128 / 3 + 32)) < 1e-9


def test_k2_cholesky():
    # the lower triangle of order 4 is 10 doubles; 64 / 3 + 32 operations
    nbytes, flops = reader("k2_chol_roofline").count(3, 4)
    assert nbytes == 3 * (10 * 8 + 4 * 8 + 4 * 8 + 4)
    assert abs(flops - 3 * (64 / 3 + 32)) < 1e-9


def test_k3_entry_mode():
    # 2 scenarios, 3 buses, 7 Y entries, 2 branches, 5 rows, 11 H entries:
    # Y (7 x 20 B), 4 row pointers, 5 row descriptions of 8 B, 8 branch-end
    # rows of 5 doubles; each scenario reads vm, va (3 + 3 doubles) and 5
    # means, writes h, r (5 + 5) and 11 entries
    shared = 7 * 20 + 4 * 4 + 5 * 8 + 8 * 5 * 8
    each = 6 * 8 + 5 * 8 + 10 * 8 + 11 * 8
    assert reader("k3e_roofline").count(2, 3, 7, 2, 5, 11) == (
        shared + 2 * each, 2 * 5 * 120)


def test_k8():
    # 2 scenarios, 5 states, 5 rows, 11 entries, 9 gain entries on and
    # below the diagonal, 17 pairs: weights (5 doubles), 11 int32 columns,
    # 6 int32 row pointers; each scenario reads 11 entries and 5
    # residuals, writes the 9 gain entries and rhs (5)
    shared = 5 * 8 + 11 * 4 + 6 * 4
    each = 11 * 8 + 5 * 8 + 9 * 8 + 5 * 8
    assert reader("k8_roofline").count(2, 5, 5, 11, 9, 17) == (
        shared + 2 * each, 2 * (3 * 17 + 5 + 2 * 11))


def three_bus():
    """Slack 0, PV 1, PQ 2 on the line 0 - 1 - 2."""
    z = np.zeros(3)
    c = np.ones(2, dtype=complex)
    return Case(n=3, bus_type=np.array([3, 2, 1]), slack=0, vm_case=z + 1,
                va_case=z, vm_start=z + 1, p_sched=z, q_sched=z,
                shunt=np.zeros(3, dtype=complex), f=np.array([0, 1]),
                t=np.array([1, 2]), yff=c, yft=-c, ytf=-c, ytt=c)


def test_the_power_flow_s_sizes_by_hand():
    # unknowns va1, va2, vm2; the rows P1, P2, Q2 each reach all three
    # (bus 1's Y row holds buses 0-2, bus 2's holds 1-2)
    got = Spec(ROOT).entry("nr").shape(three_bus(), {})
    assert (got["n"], got["nnz"], got["branches"]) == (3, 7, 2)
    assert (got["order"], got["jac_entries"]) == (3, 9)


def test_the_estimator_s_sizes_by_hand():
    # states va1, va2, vm0, vm1, vm2; PMUs at buses 0 and 2; rows: 3
    # voltmeters (1 entry each), P at buses 0-2 (3, 5, 4 entries: the
    # slack's angle held), 2 ends of branch 0-1 (3 each) and of 1-2 (4
    # each), the same for Q, and the PMUs (1, 0: the slack's angle, 1, 1)
    case = three_bus()
    meas = MeasurementSet.every_bus_and_branch(case, 2, VARIANCES)
    got = Spec(ROOT).entry("se").shape(case, dict(meas=meas))
    widths = [1, 1, 1, 3, 5, 4, 3, 3, 4, 4, 3, 5, 4, 3, 3, 4, 4,
              1, 0, 1, 1]
    assert (got["states"], got["rows"]) == (5, 21)
    assert got["entries"] == sum(widths)
    assert got["pairs"] == sum(w * (w + 1) // 2 for w in widths)
    # bus 1's injection rows reach all five states, so every pair is
    # joined: the lower triangle's 15
    assert got["gain_lower"] == 15


@pytest.mark.parametrize("entry", ["nr", "se"])
def test_sizes_match_the_reference_s_jacobians(entry):
    """At case118 the structural counts equal the nonzeros of the
    reference's dense Jacobians (and of HᵀH) at a random state."""
    case = load_case(str(CASE118))
    grid = ref.Grid.build(case, "cpu")
    rng = np.random.default_rng(11)
    vm = torch.tensor(1 + 0.05 * rng.standard_normal((1, case.n)))
    va = torch.tensor(0.2 * rng.standard_normal((1, case.n)))
    if entry == "nr":
        got = Spec(ROOT).entry("nr").shape(case, {})
        v = grid.voltage(vm, va)
        ds_dva, ds_dvm = grid.ds_dv(v, grid.injections(v)[1])
        pvpq = np.flatnonzero(case.bus_type != 3)
        pq = np.flatnonzero(case.bus_type == 1)
        jac = np.block([[ds_dva.real[0][pvpq][:, pvpq].numpy(),
                         ds_dvm.real[0][pvpq][:, pq].numpy()],
                        [ds_dva.imag[0][pq][:, pvpq].numpy(),
                         ds_dvm.imag[0][pq][:, pq].numpy()]])
        assert got["order"] == jac.shape[0] == 181
        assert got["jac_entries"] == np.count_nonzero(jac)
        return
    meas = MeasurementSet.every_bus_and_branch(case, 10, VARIANCES)
    got = Spec(ROOT).entry("se").shape(case, dict(meas=meas))
    keep = np.arange(2 * case.n) != case.slack
    h = ref.jacobian(grid, meas, vm, va)[0].numpy()[:, keep]
    nz = (h != 0).astype(np.float64)
    assert got["states"] == h.shape[1] and got["rows"] == h.shape[0]
    assert got["entries"] == np.count_nonzero(h)
    assert got["gain_lower"] == np.count_nonzero(np.tril(nz.T @ nz))
    w = nz.sum(1)
    assert got["pairs"] == int((w * (w + 1) / 2).sum())


def test_a_share_is_none_without_a_launch():
    from portbench.harness import Run, TraceData
    run = Run(batch=2, setup_s=1.0,
              host_build_s=0.1, calls=[], window_s=1.0, peak_window_bytes=0,
              shape=dict(n=3, nnz=7, order=3, jac_entries=9), trace=None)
    assert reader("k1_roofline").read(run) is None
    run.trace = TraceData(window=(0, 10), device=[("other", 1, 2)],
                          host_ops=([], []), spans=())
    assert reader("k1_roofline").read(run) is None
    run.trace.device.append(("nr_fill_kernel(Args)", 2, 2 + 10 ** 6))
    least = max((168 + 2 * 168) / 3.35e12, 308 / 67e12)
    assert abs(reader("k1_roofline").read(run) - 100 * least / 1e-3) < 1e-9


def test_library_kernels_by_name():
    lib = reader("dense_solve_ms_per_iter").library
    for name in ("void potrf_syrk_nc_kernel<double, 5, 6, 3, 3, 4>(int)",
                 "dlaswp_rowparallel_kernel_batched(int, int)",
                 "idamax_kernel_batched(int)", "dswap_kernel_batched(int)",
                 "void dscal_dger_1d_kernel_batched<6>(int)",
                 "void gemm_template_batched_nn_kernel<double, 16>(int)",
                 "void dtrsv_trans_kernel_outplace_batched<32, 16>(int)",
                 "void batch_trsm_left_kernel<double, 64>(int)"):
        assert lib(name), name
    for name in ("void at::native::triu_tril_kernel<double, int>(int)",
                 "void at::native::(anonymous namespace)::"
                 "CatArrayBatchedCopy<int>(int)",
                 "(anonymous namespace)::nr_fill_kernel(int const*)",
                 "void (anonymous namespace)::fleet_solve_kernel<true, 2>"
                 "((anonymous namespace)::Problem)",
                 "Memcpy DtoD (Device -> Device)", "Memset (Device)"):
        assert not lib(name), name


class _Event:
    def __init__(self, name, start, end, device=False, annotation=False):
        import torch
        self._v = (name, start, end, annotation)
        self._dev = torch.autograd.DeviceType.CUDA if device \
            else torch.autograd.DeviceType.CPU

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def is_user_annotation(self):
        return self._v[3]

    def device_type(self):
        return self._dev


def test_trace_reading_keeps_work_and_drops_the_spans():
    """Kernels and copies are device work; the window's spans, which the
    profiler also lays on the device's timeline, are not."""
    from types import SimpleNamespace

    from portbench import harness

    events = [
        _Event("portbench.window", 0, 100),
        _Event("portbench.solve", 10, 90),
        _Event("aten::mm", 12, 14),
        _Event("portbench.solve", 10, 90, device=True, annotation=True),
        _Event("gemm_kernel", 20, 40, device=True),
        _Event("Memcpy DtoH", 35, 50, device=True),
        _Event("potrf_kernel", 70, 80, device=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    trace = harness._read_trace(prof)
    assert trace.window == (0, 100)
    assert [d[0] for d in trace.device] == ["gemm_kernel", "Memcpy DtoH",
                                            "potrf_kernel"]
    assert harness.busy_ns(trace) == 30 + 10
    assert harness.device_ops(trace) == [["gemm_kernel", 20e-9],
                                         ["Memcpy DtoH", 15e-9],
                                         ["potrf_kernel", 10e-9]]
    # gaps 0-20, 50-70, 80-100, labelled at their middles
    assert dict(harness.idle_gaps(trace)) == {
        "portbench.solve: none": 20e-9, "portbench.solve: aten::mm": 40e-9}
