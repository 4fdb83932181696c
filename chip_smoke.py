#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (juliagrid_tpu_torch) on one card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels K1 (``nr_fill``), K2 (``fleet_solve``),
K3 (``se_fill``), K4 (``gs_sweep``), K5 (``schur_gather``), K6
(``opf_fill``), K7 (``kkt_fill``) and K8 (``gain_fill``) from the sources in
the checkout and holds each against its plain PyTorch version;
each K3, K5 and K6 call (phases 5, 13, 15, 17) is captured once in a CUDA
graph to show that it puts one kernel and no memset or memcpy on the card,
and is timed with its device time alone (queued behind a sleep kernel) and
its host path. It
drives the
Newton-Raphson main path — ``power_system`` -> ``newton_raphson`` ->
``power_flow`` — on a 10,000-bus grid, checked against the independent
scipy oracle, a 1024-scenario case118 fleet and a case14 fleet with one
singular scenario (phases 1-4). Phase 4 also holds K2's LU mode against
its plain version on K1's Jacobians of case14, case30 and case118 at 1, 8
and 1,024 scenarios, on random order-256 inputs and on the singular fleet
(equal ``info``), times it beside the library route it replaced and one
``torch.linalg.solve_ex``, and splits the NR fleet's lockstep iteration
(K1, the solve, the update, the readback) for K2 and for the library
route (``library_route``); phase 7 does the same for K2's Cholesky mode on
the SE gains and the SE fleet. No solve of the main paths may reach K2's
plain version (``k2_plain_barred``).
Then the Gauss-Newton WLS state-estimation path
— ``measurement`` + ``add_*`` -> ``gauss_newton`` -> ``state_estimation`` —
on a 1,369-bus grid against the scipy oracle and on case14/30 with every row
type, and the Monte-Carlo SE fleets of bench configs 3 and 5b (phases 5-7).
Phase 5b holds K3's entry mode and K8 (the estimators' gain and
right-hand side from H's fixed entry pattern) against their plain versions
(K8 bit for bit) on case14/30/118 with every row type, the fleet shapes,
the 10k DC set and a correlated PMU set, and times K8 in turns with the
dense route it replaced (K3's dense H and one f64 GEMM), which
``dense_gain_route`` swaps in as the yardstick: phases 6, 7, 11 and 12 run
their estimates through K8 and again on the dense route, which must take
the same iterations to the same states; no main-path solve may reach the
plain versions or the dense route (``gain_plain_barred``).
Then the rest of power flow: K4 against its plain version on case14/30/118,
the 10k and 25k grids and a grid with a 152-entry Y row, a launch of many
sweeps against as many one-sweep launches, both voltage layouts (phase 8);
the Gauss-Seidel path — ``gauss_seidel`` -> ``power_flow``, one K4 launch a
solve — on case14/30/118 against the JAX package's iteration counts and the
port's Newton-Raphson, and 5,000 sweeps on the 10k grid against the JAX
package's mismatch (phase 9); and the DC path, the DC fleets, the fast
decoupled path and the reactive limits against the scipy oracles and the
port's CPU run (phase 10).
Then the linear estimators (phase 11): DC state estimation on the 10k grid
against ``oracle_dc``, with one planted wattmeter error found by
``chi_test`` and the dense ``residual_test`` on the card and gone after
re-estimation; DC with QR on case118; a nonzero slack angle with PMU angle
rows; PMU state estimation from ``pmu_placement_apply`` (case118, case300)
and with full coverage on the 1,369-bus grid against the power flow and the
port's CPU run. Then bad data (phase 12): bench config 4's case118 set,
where ``lnr_removal``, the stepwise ``residual_test`` + ``state_estimation``
loop and a scipy loop on ``oracle_wls_se`` remove the same two devices; and
the 1,369-bus set with three planted errors, where the dense and Takahashi
``residual_test`` agree and ``lnr_removal`` removes the three. Then the
bordered-block-diagonal scale path: K1's routed mode and K5
(``schur_gather``) against their plain versions, K5 also bit for bit
against ``schur_gather_lists`` and timed beside one ``index_put_``, at the
10k and 25k layouts (phase 13); ``newton_raphson_bbd``
-> ``power_flow_bbd`` on the 10k grid against phase 3's dense solve and on
the 24,964-bus ``synthetic_grid(158, 158)`` against ``oracle_nr``, and
``fast_newton_raphson_bbd`` BX/XB on both against ``oracle_fdpf`` (phase
14); K3's routed mode against its plain version, K5 as the estimator
calls it (no base, sign 1) at the three SE borders, ``gauss_newton_bbd`` ->
``se_bbd_solve`` on the 1,369-bus set against the dense estimate (and in
chunks of blocks against one pass), and the 10k and 25k zero-noise sets
reproducing the phase-14 states (phase 15). Then the interior point
(phase 16): ``dc_optimal_power_flow`` -> ``power_flow`` on case14/30
against the port's CPU run; case118 and the real ACTIVSg10k grid with the
distinct linear costs of tests/test_opf_anchor.py against an LP assembled
from raw data in scipy sparse matrices and solved by HiGHS (every flow and
angle limit included); ACTIVSg10k with its own costs, its dispatch checked
for bus balance and every limit from raw data, with the per-iteration
split of the card's time and the peak memory; case1354pegase against the
CPU run (objective and feasibility: one cost for all its generators leaves
the dispatch free) and, with the anchor's costs, against HiGHS; DC, PMU
and AC LAV (``state_estimation`` on the ``*_lav_*``
analyses; AC through K3) reproducing the case14test power flow, and bench
config 4's case118 AC LAV against the CPU run. Then the AC optimal power
flow (phase 17): K6 against its plain version (case14optimal with every
flow-limit class, case118 and case1354pegase; random points, the flat
start where the √ rows of shunt-free lines sit below their clamp, a
solve's iterates and optimum), ``ac_optimal_power_flow`` -> ``power_flow`` on
case14optimal and case30test against the port's CPU run, case118 against
MATPOWER's published optimum, and the main path: case1354pegase at full
size with its own costs, checked against MATPOWER's published optimum and
for balance (from the raw Y bus) and every limit, with the per-iteration
split; the fixed-order sums (``ops/segments.py``) on the card against the
CPU, bit for bit, and a gather's gradient twice; and K6's times beside a
memset-and-fill split and a bare ``zero_()`` of the same output, with each
mode's registers and local bytes from ``cudaFuncGetAttributes``. Then the
structured (BBD) KKT of the AC OPF (phase 18): K7 against its plain version at
case118, case1354pegase and the 10,000-bus cell, timed; the BBD KKT
against the dense KKT on the 900-bus ``synthetic_grid(30, 30, opf=True)``
(one step's dx, and both solves end to end); and the main path, the
JAX package's 10k AC OPF record ``synthetic_grid(100, 100, opf=True)``
through ``power_flow(power=True)`` with ``kkt_blocks`` unset, checked for
balance from the raw Y bus, every limit and every taken step's linear
residual, with the per-iteration split, solved a second time from a
fresh build of the same grid (the same iterations to the same bits), then
re-solved after a live cost edit on the cached structure. Then the
product surface (phase 19): ``entry()``'s Newton-Raphson step on the card
against the CPU; live edits at full size, each reused analysis re-solved
against a fresh build of the edited case on the card (a branch out, an
added generator and a demand change on a fresh 10k grid, also against
``oracle_nr``; a wattmeter switched off and a varmeter's variance changed
on the 1,369-bus set, with seeded noise); the report tables of the 10k NR,
the 1,369-bus SE, the ACTIVSg10k DC OPF and the pegase AC OPF, checked for
a row per element, pegase's balance and flow columns and the SE residual
column; and a ``utils.profiling.trace`` of the 10k NR solve whose K1
kernel events must equal its K1 launches. ``utils.checkpoint`` is not run
there: it writes HDF5 and the card's machine has no h5py. Then the mesh
path (phase 20, ``parallel/mesh.py``), every rank a process of its own: a
NCCL world of one runs ``sharded_nr_solve`` on phase 4's fleet, which must
give the single process's bits and counts; four gloo ranks that share the
card (NCCL refuses two ranks on one GPU) run the case118 x1024 NR and SE
fleets (``sharded_nr_solve``, ``sharded_se_solve``), ``bbd_solve_sharded``
on the 10k grid's DC matrix at a block a rank and the 10k AC OPF through
``solve_opf`` with ``kkt_blocks=4, kkt_mesh=`` the block mesh, each against
its single-process twin (the AC OPF by phase 18's BBD gates, balance and
limits), every rank's results the same bits, with each path's wall (the
AC OPF's after a short warm-up solve in every process), the all-reduce
stage's ms an iteration and each rank's peak memory; before the ranks
start, K7 and K5 are held to their plain versions at the shapes the ranks
give them (K7 in the k = 4 tables and in each rank's one-block tables, K5
on each block's own route with no base and sign -1); the ranks' K1, K3,
K5 and K7 launches count on the main path. Every phase
prints its lines and times; any failure exits non-zero. The 10k and 25k
NR/SE grids are ``synthetic_grid``s; phase 16 loads ACTIVSg10k and
case1354pegase from their numpy-only ``.npz`` snapshots (the card's
machine has no h5py).

The last lines are each phase's wall time and the whole run's, the card's
``nvidia-smi`` name and power limit
and a JSON object with each kernel's launches on the main paths, error
against its plain version (``max_abs_err``, and ``rel_err`` in the measure
its gate uses), times and least possible time; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from juliagrid_tpu_torch import (add_ammeter, add_pmu, add_varmeter,
                                 add_voltmeter, add_wattmeter, adjust_angle,
                                 chi_test, dc_power_flow,
                                 dc_state_estimation, fast_newton_raphson_bx,
                                 fast_newton_raphson_xb, gauss_newton,
                                 gauss_seidel, lnr_removal, measurement,
                                 newton_raphson, pmu_placement_apply,
                                 pmu_state_estimation, power_flow,
                                 power_system, reactive_limit, residual_test,
                                 state_estimation, update_bus,
                                 update_varmeter, update_voltmeter,
                                 update_wattmeter)
from juliagrid_tpu_torch import (physical_island, print_branch_constraint,
                                 print_branch_data, print_branch_summary,
                                 print_bus_constraint, print_bus_data,
                                 print_bus_summary,
                                 print_generator_constraint,
                                 print_generator_data,
                                 print_generator_summary,
                                 print_wattmeter_data, set_initial_point)
from juliagrid_tpu_torch import dc_model, newton_raphson_bbd, power_flow_bbd
from juliagrid_tpu_torch import (ac_lav_state_estimation,
                                 ac_optimal_power_flow, cost,
                                 dc_lav_state_estimation,
                                 dc_optimal_power_flow,
                                 pmu_lav_state_estimation)
from juliagrid_tpu_torch.convert import (acopf_arrays_from_numpy,
                                         dcse_arrays_from_numpy,
                                         pmuse_arrays_from_numpy)
from juliagrid_tpu_torch.estimation.acse_bbd import (_block_chunk,
                                                     _gn_increment_bbd,
                                                     gauss_newton_bbd,
                                                     se_bbd_solve)
from juliagrid_tpu_torch.estimation import acse as acse_mod
from juliagrid_tpu_torch.estimation import dcse as dcse_mod
from juliagrid_tpu_torch.estimation import pmuse as pmuse_mod
from juliagrid_tpu_torch.estimation.acse import (_gain_equations,
                                                 _se_solve, _solve_normal,
                                                 _w_apply_vec, _weighted,
                                                 build_h, compile_se_arrays,
                                                 gain_table)
from juliagrid_tpu_torch.estimation.baddata import (_deactivate, _host_csr,
                                                    _lnr_detect,
                                                    _projection_diag)
from juliagrid_tpu_torch.estimation.dcse import (_dcse_host,
                                                 _dcse_normal_equations,
                                                 _dcse_weighted)
from juliagrid_tpu_torch.estimation.pmuse import (_pmuse_host,
                                                  _pmuse_normal_equations)
from juliagrid_tpu_torch.entry import entry
from juliagrid_tpu_torch.measurement import devices as meter_devices
from juliagrid_tpu_torch.estimation.takahashi import projection_diag_sparse
from juliagrid_tpu_torch.kernels import fleet_solve as k2
from juliagrid_tpu_torch.kernels import gain_fill as k8
from juliagrid_tpu_torch.kernels import gs_sweep as k4
from juliagrid_tpu_torch.kernels import kkt_fill as k7
from juliagrid_tpu_torch.kernels import nr_fill as k1
from juliagrid_tpu_torch.kernels import opf_fill as k6
from juliagrid_tpu_torch.kernels import schur_gather as k5
from juliagrid_tpu_torch.kernels import se_fill as k3
from juliagrid_tpu_torch.opf import acopf as ac_mod
from juliagrid_tpu_torch.opf import ipm, kkt_bbd
from juliagrid_tpu_torch.opf import solve_opf
from juliagrid_tpu_torch.opf.edit import update_cost
from juliagrid_tpu_torch.ops import linalg
from juliagrid_tpu_torch.ops.bbd import (bbd_partition, bbd_solve,
                                         bbd_solve_sharded, build_bbd_arrays)
from juliagrid_tpu_torch.ops.segments import segment_sum
from juliagrid_tpu_torch.oracle import (oracle_dc, oracle_fdpf, oracle_nr,
                                        oracle_wls_se)
from juliagrid_tpu_torch.parallel import (batched_dc_solve, batched_nr_solve,
                                          batched_se_solve, launch,
                                          sharded_nr_solve, sharded_se_solve)
from juliagrid_tpu_torch.powerflow.ac import (_max_mismatch, _nr_move,
                                              _nr_rhs, _nr_solve, _nr_update,
                                              compile_ac_arrays)
from juliagrid_tpu_torch.powerflow.dc import _dc_solve
from juliagrid_tpu_torch.postprocessing import ac as ac_post
from juliagrid_tpu_torch.powerflow.fast_decoupled import (
    _fnr_matrices, fast_newton_raphson_bbd, power_flow_fnr_bbd)
from juliagrid_tpu_torch.powerflow.gauss_seidel import (_gs_solve, _to_rect,
                                                        compile_gs_arrays)
from juliagrid_tpu_torch.powerflow.newton_bbd import _blocks, compile_nr_bbd
from juliagrid_tpu_torch.report.log import suppress
from juliagrid_tpu_torch.system.builders import (add_branch, add_bus,
                                                 add_generator, update_branch)
from juliagrid_tpu_torch.utils.profiling import annotate, device_stages, trace
from juliagrid_tpu_torch.utils.synthetic import synthetic_grid

DATA = Path(__file__).resolve().parent / "tests" / "data"
SEED = 0
GRID = (100, 100)          # 10,000 buses
FLEET = 1024               # case118 scenarios (bench config 1's shape)
#: the JAX package's batched_nr_solve on case14 x4, the second scenario
#: started at zero magnitudes: iterations and converged flags
SINGULAR_FLEET = ([7, 20, 7, 7], [True, False, True, True])
K1_REL_TOL = 1e-12         # |kernel - plain| <= tol * max(1, |plain|)
SMALL_STATE_TOL = 1e-9     # case14/30 against the oracle
GRID_STATE_TOL = 1e-8      # 10k grid against the oracle
TWIN_STATE_TOL = 1e-10     # a solve against the same solve on nr_fill_ref
TOL = 1e-8                 # NR mismatch tolerance (power_flow default)
SE_GRID = (37, 37)         # 1,369 buses: bench config 5b's pegase-sized shape
SE_FLEET = 1024            # case118 SE scenarios (bench config 3, full width)
SE_CHUNK, SE_CHUNKS = 32, 2  # config 5b: 64 scenarios in chunks of 32
K3_REL_TOL = 1e-12         # |kernel - plain| <= tol * max(1, |plain|)
SE_STATE_TOL = 1e-8        # 1,369-bus SE vs oracle; case14/30 SE vs PF
SE_TOL = 1e-8              # GN max|dx| tolerance (state_estimation default)
#: Gauss-Seidel iterations to 1e-8 of the JAX package on each case (pinned
#: by tests/test_torch_powerflow_methods.py)
GS_ITERATIONS = {"case14test": 281, "case30test": 761, "case118": 2111}
GS_CAP = 5000              # power_flow(iteration=) of the Gauss-Seidel path
#: the JAX package's _gs_solve on the 10k grid from its start, GS_10K_SWEEPS
#: sweeps without converging: max|dP|, max|dQ| (f64 on the CPU)
GS_10K_SWEEPS = 5000
GS_10K_PAIR = (0.029414719534635925, 0.004503041625773047)
#: GS contracts there: a start perturbed by 1e-15 moves the pair 9.4e-14 and
#: 2.8e-13 (relative), and the port's level-by-level plain sweep, whose row
#: sums round in another order, ends 5.3e-14 and 1.8e-13 away; 1e-10 leaves
#: a margin of 500
GS_10K_REL_TOL = 1e-10
K4_REL_TOL = 1e-12         # |kernel - plain| <= tol * max(1, |plain|)
K4_SWEEPS = 20             # sweeps of a split-checked K4 launch
K4_TIMED_SWEEPS = 100      # sweeps of a timed K4 launch
GS_NR_TOL = 1e-7           # Gauss-Seidel state against Newton-Raphson's
DC_SMALL_TOL = 1e-10       # case14/30 DC, and fleet scenarios vs single
FLEET_DC = 1024            # DC scenarios (bench config 2's shape)
FDPF_CAP = 30              # power_flow(iteration=) of the fast decoupled path
NR_CAP = 20                # power_flow_bbd(iteration=), its default
#: fast decoupled steps followed on the 25k lattice, where the method
#: diverges (the scipy oracle's mismatch reaches 1e48 in 100 iterations)
FDPF_25K_STEPS = 6
LINEAR_TOL = 1e-8          # DC SE vs oracle_dc, PMU SE vs NR
CARD_CPU_TOL = 1e-10       # a linear estimate on the card vs the CPU run
LNR_STATE_TOL = 1e-9       # lnr_removal vs the stepwise loop
RN_SPARSE_TOL = 1e-6       # residual_test: dense vs Takahashi max rn
THRESHOLD = 3.0            # normalized-residual threshold (bench config 4)
#: bench config 4's planted wattmeter errors (bench.py:415-416)
CONFIG4_PLANTED = ((3, 5.0), (40, -4.0))
BBD_GRID = (158, 158)      # 24,964 buses: benchmarks/scale_25k.py's lattice
BBD_BLOCKS = 16            # BBD blocks of the 10k and 25k grids
SE_BBD_BLOCKS = 8          # BBD blocks of the 1,369-bus SE (the default)
K5_REL_TOL = 1e-12         # |kernel - plain| <= tol * max(1, |plain|)
BBD_DENSE_TOL = 1e-9       # 10k BBD NR vs the dense NR; BBD SE vs dense SE
OPF_10K = "case_ACTIVSg10k.npz"     # phase 16's full width (numpy snapshot)
OPF_PEGASE = "case1354pegase.npz"
OPF_SMALL_TOL = 1e-8       # case14/30 DC OPF angles and dispatch, card vs CPU
LP_OBJ_RTOL = 1e-7         # DC OPF objective vs HiGHS (the anchor's rtol)
LP_OBJ_RTOL_LOOSE = 1e-6   # ... when the 10k LP stops acceptable
LP_PG_ATOL_118, LP_PG_ATOL_10K = 2e-6, 1e-5  # dispatch vs HiGHS
FEAS_BALANCE_TOL = 1e-8    # 10k own-cost dispatch: bus balance (p.u.)
FEAS_LIMIT_TOL = 1e-7      # ... capability, flow and angle limits
PEGASE_OBJ_RTOL, PEGASE_PG_TOL = 1e-7, 1e-6  # pegase vs CPU / HiGHS
LAV_DC_TOL, LAV_PMU_TOL, LAV_AC_TOL = 1e-6, 1e-6, 1e-5  # vs the power flow
LAV_CARD_CPU_TOL = 1e-7    # config 4's AC LAV, card vs CPU
#: K6: |kernel - plain| <= tol * max(1, max |plain row|). An entry of H is
#: a sum of dual-weighted terms that cancel (at pegase a diagonal entry of
#: 378 sums terms of ~1e5; entry-relative 1.3e-11 there, 1.8e-10 at a
#: case118 entry that cancels to ~1e-10), so its rounding is relative to the
#: row's scale; the entry-relative difference is printed beside it
K6_REL_TOL = 1e-12
AC_OPF_CARD_CPU_TOL = 1e-8  # case14optimal/case30test AC OPF, card vs CPU
PEGASE_AC_OBJ = 74069.35   # MATPOWER's published case1354pegase AC optimum
PEGASE_AC_OBJ_TOL = 0.05   # $/h
CASE118_AC_OBJ, CASE118_AC_RTOL = 129660.69, 2e-4  # tests/test_opf_anchor.py
AC_FEAS_BALANCE_TOL = 1e-8  # pegase AC OPF: bus balance (p.u., raw Y bus)
AC_FEAS_LIMIT_TOL = 1e-7    # ... voltage, capability, flow and angle limits
KKT_GRID = (100, 100)      # the 10k AC OPF: benchmarks/opf_scale.py's grid
KKT_REF_ITERATIONS = 23    # the reference's 10k solve (BENCH_NOTES.md)
KKT_SMALL_GRID, KKT_SMALL_BLOCKS = (30, 30), 8  # BBD against dense
#: K7: |kernel - plain| <= tol * max(1, the row's scale): a COO value
#: against its KKT row's largest value, a block element against its block
#: row's largest (the flow rows' closed forms against autodiff, the bus
#: sums in another order)
K7_REL_TOL = 1e-12
BBD_DENSE_STEP_TOL = 1e-8  # one step's dx, BBD vs dense, of its scale
BBD_DENSE_OBJ_RTOL = 1e-8  # the 30x30 AC OPF end to end, BBD vs dense
BBD_DENSE_STATE_TOL = 1e-6  # ... V and θ
KKT_BALANCE_TOL = 1e-6     # 10k AC OPF: bus balance (p.u., raw Y bus)
KKT_LIN_RES_TOL = 1e-8     # ... lin_res of every step the δ loop takes
ENTRY_TOL = 1e-12          # entry()'s step, card vs CPU
MESH_RANKS = 4             # phase 20's gloo ranks, all on the one card
MESH_TIMEOUT = 420.0       # s, the deadline of a phase-20 launch
MESH_STATE_TOL = 1e-10     # sharded fleets vs their single-process runs
MESH_SCHUR_TOL = 1e-10     # bbd_solve_sharded vs bbd_solve
MESH_SCHUR_RES = 1e-8      # ... its |A x - r|
MESH_SEED = 20             # phase 20's step point and kernel inputs
MESH_WARM_ITER = 3         # a warm-up AC OPF's iterations before the timed
#                            solve, in each rank and in the single process
#: phase 19's edit solves run to a mismatch (NR) or max|dx| (SE) of 1e-10,
#: so a reused and a fresh solve both sit within ~1e-11 of the solution
#: and a stale array, which moves the answer by the edit's size, cannot
#: hide under the stopping tolerance
EDIT_TOL = 1e-10
REUSE_TOL = 1e-9           # a reused re-solve against a fresh build
TABLE_BALANCE_TOL = 1e-8   # pegase's balance columns (phase 17's gate)
FLOW_TABLE_REL_TOL = 1e-12  # Flow Solution vs flow_values on the CPU
#: the Residual column against mean - h(x) from se_fill_ref on the CPU,
#: of max(1, |mean|): h is a sum of power terms, so its rounding scales
#: with the mean it is taken from, not with the residual
RESIDUAL_TABLE_TOL = 1e-12
#: the noisy set's residuals must reach at least this, so that the gate
#: above tells a right column from one of zeros
NOISY_RESIDUAL_MIN = 1e-6
#: published peaks of the card (NVIDIA data sheet, H100 SXM, 700 W)
K2_X_TOL = 1e-11           # K2's x vs its plain version, of the scenario's max|x|
K2_BACKWARD_TOL = 1e-14    # ||A x - b||inf / (||A||inf ||x||inf), every scenario
K2_FACTOR_TOL = 1e-10      # K2's LU factors vs getrf's, of the scenario's max
K2_BATCHES = (1, 8, 1024)  # K2's checks at case14, case30 and case118
K2_CAP_SEED = 14           # the random order-256 inputs of K2's checks
HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 67e12
#: f64 operations of each kernel, estimated from its source (a sine or
#: cosine as one): K1 per Y entry and scenario (angle difference, sine,
#: cosine, ViVj, the two G/B combinations, the two row sums, four
#: partials); K3 per row and scenario (an injection row: about five Y
#: entries of K1's work); K4 per padded Y entry (one complex multiply-add)
#: and per bus (two complex divides, the PV projection). The bytes bound
#: every kernel by two to three orders of magnitude more.
K1_OPS_PER_ENTRY = 22
K3_OPS_PER_ROW = 120
K4_OPS_PER_ENTRY, K4_OPS_PER_BUS = 8, 40
#: K6: per Y-bus entry and end (a sine, a cosine, the six weighted second
#: derivatives) and per flow row and end (its 4x4 Hessian by the chain rule)
K6_OPS_PER_ENTRY, K6_OPS_PER_FLOW = 40, 700
#: K7: per COO value (its share of an item's closed forms, the max, the
#: two scales and the sum) and per flow row (its 4x4 Hessian and gradient)
K7_OPS_PER_ENTRY, K7_OPS_PER_FLOW = 20, 1000
#: K8: per contribution and scenario (two products and a sum) and per rhs
#: entry (the weighted residual, its product and the sum)
K8_OPS_PER_CONTRIB, K8_OPS_PER_RHS = 3, 6
#: K8's G and rhs against the dense route's, of the scenario's max|G| and
#: max|rhs| (one f64 formula, summed in two orders)
K8_DENSE_TOL = 1e-12
#: the tables K8's bound counts as read: the gain table's pattern arrays
#: (the fleet regime's band lists are the kernel's own choice, not the
#: function's input)
K8_BOUND_TABLES = ("nz_ptr", "nz_col", "c_ptr", "c_a", "c_b", "c_w",
                   "dup_ptr", "dup_raw", "col_ptr", "col_ref", "col_row",
                   "pair_of", "partner")
#: phase 5b's batches on both sides of k8.FLEET_MIN; it also runs a rank's
#: share of phase 20's sharded fleet (SE_FLEET // 4 = 256) and SE_FLEET
K8_BATCHES = (1, 5, 7, 8, 31, 32, 33)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


#: each kernel's worst relative error against its plain version, in the
#: measure its gate uses (``note_rel``), for the kernels line
REL_ERR = {}


def note_rel(name, rel):
    REL_ERR[name] = max(REL_ERR.get(name, 0.0), float(rel))


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


def queued_ms(fn, reps):
    """Device ms of one run of ``fn`` with the runs back to back: they are
    queued behind a sleep kernel long enough for the host to enqueue them
    all, so the host's launch path leaves no gap between them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(500_000 * reps)   # ~0.25 ms of the card's clock a run
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps):
    """Host µs of one call of ``fn``: the calls are enqueued behind a
    sleep kernel, so that none of them waits for the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(500_000 * reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return us


def graph_nodes(fn):
    """The types of the work one call of ``fn`` puts on the card: the
    call is captured in a CUDA graph and its nodes are read through
    ``libcuda`` (``CUgraphNodeType``: 0 a kernel, 1 a memcpy, 2 a
    memset)."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0,
          "cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    del graph
    return kinds


def check_one_launch(label, fn):
    """``fn`` must put one kernel on the card and no memset or memcpy."""
    kinds = graph_nodes(fn)
    check(kinds == [0],
          f"{label}: one call puts graph nodes of types {kinds} on the card "
          f"(0 a kernel, 1 a memcpy, 2 a memset); one kernel and nothing "
          f"else was expected")


def wall_s(fn):
    """Host seconds of ``fn`` up to the device finishing its work."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def event_ms(fn):
    """Device ms of one run of ``fn`` from CUDA events, and its result."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = fn()
    ev[1].record()
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]), out


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes, flops):
    """The least time the card could take (ms) and what sets it: the bytes
    moved once over the HBM rate, or the f64 operations over the f64
    peak."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / F64_FLOP_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


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
    note_rel("nr_fill", worst_rel)
    check(torch.equal(got.jac != 0, ref.jac != 0),
          f"{label}: K1 Jacobian pattern differs from nr_fill_ref")
    b, n = inputs[0].shape
    least = bound(tensor_bytes(arr.row_ptr, arr.cols, arr.yg, arr.yb,
                               arr.diag, arr.bus_type, *inputs, *got),
                  b * arr.cols.numel() * K1_OPS_PER_ENTRY)
    del got, ref
    ms = cuda_ms(lambda: k1.nr_fill(arr, *inputs, jacobian=True), reps=20)
    plain_ms = cuda_ms(lambda: k1.nr_fill_ref(arr, *inputs, jacobian=True),
                       reps=5)
    print(f"phase 1 {label} B={b} n={n}: max abs diff {worst_abs!r}, "
          f"max rel diff {worst_rel!r}, pattern equal; "
          f"K1 {ms!r} ms, nr_fill_ref {plain_ms!r} ms per call (jacobian); "
          f"bound {least[0]!r} ms by {least[1]}")
    return worst_abs, ms, plain_ms, least


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
    # one nvcc per source, started together
    kernels = (k1, k2, k3, k4, k5, k6, k7, k8)
    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        for build in [pool.submit(k.LIBRARY.load) for k in kernels]:
            build.result()
    build_s = time.perf_counter() - t0
    print(f"phase 0 device: {torch.cuda.get_device_name(0)} ({card}), "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"K1-K8 build+load {build_s!r} s")
    return card


def phase1():
    rng = np.random.default_rng(SEED)
    grid = synthetic_grid(*GRID)
    arr = compile_ac_arrays(grid, "cuda")
    err_grid, ms, plain_ms, least = compare_k1(
        "10k grid", arr, random_inputs(arr, grid.bus.number, 1, rng))
    case118 = power_system(str(DATA / "case118.m"))
    arr118 = compile_ac_arrays(case118, "cuda")
    err_118 = compare_k1(
        "case118 fleet", arr118,
        random_inputs(arr118, case118.bus.number, FLEET, rng))[0]
    return max(err_grid, err_118), ms, plain_ms, least


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
    return launches, analysis


def nr_fleet_inputs():
    """Phase 4's case118 fleet: its arrays and ``FLEET`` scenarios at 5%
    scale noise on P and Q (seed 0)."""
    system = power_system(str(DATA / "case118.m"))
    analysis = newton_raphson(system, device="cuda")
    arr = analysis.arrays
    vm, va = analysis._state()
    rng = np.random.default_rng(0)
    scale = torch.tensor(1.0 + 0.05 * rng.standard_normal((FLEET, 1)),
                         device=vm.device)
    return arr, (vm.expand(FLEET, -1).contiguous(),
                 va.expand(FLEET, -1).contiguous(),
                 arr.p_sched[None] * scale, arr.q_sched[None] * scale)


# ---- K2: the fleets' dense solves --------------------------------------------

def k2_pair(chol):
    """K2's wrapper and its plain version in one mode."""
    if chol:
        return k2.fleet_cholesky_solve, k2.fleet_cholesky_solve_ref
    return k2.fleet_lu_solve, k2.fleet_lu_solve_ref


def k2_name(chol):
    return "fleet_cholesky_solve" if chol else "fleet_lu_solve"


@contextlib.contextmanager
def k2_plain_barred():
    """While active, a CUDA tensor of an order K2 takes (up to
    ``k2.CAP``) that reaches K2's plain versions fails the run: the main
    path must launch K2 for every solve of those orders."""
    saved = k2.fleet_lu_solve_ref, k2.fleet_cholesky_solve_ref

    def barred(fn):
        def guard(a, *args, **kw):
            check(a.device.type != "cuda" or a.shape[-1] > k2.CAP,
                  f"{fn.__name__} got a CUDA tensor of order "
                  f"{a.shape[-1]} on the main path")
            return fn(a, *args, **kw)
        return guard

    k2.fleet_lu_solve_ref, k2.fleet_cholesky_solve_ref = map(barred, saved)
    try:
        yield
    finally:
        k2.fleet_lu_solve_ref, k2.fleet_cholesky_solve_ref = saved


@contextlib.contextmanager
def library_route():
    """While active, the call sites' K2 solves go to K2's plain versions,
    the library route they took before K2 (``lu_factor_ex`` + ``lu_solve``,
    ``cholesky_ex`` + ``cholesky_solve``): the yardstick of phases 4 and 7,
    never the main path."""
    saved = k2.fleet_lu_solve, k2.fleet_cholesky_solve
    k2.fleet_lu_solve = k2.fleet_lu_solve_ref
    k2.fleet_cholesky_solve = k2.fleet_cholesky_solve_ref
    try:
        yield
    finally:
        k2.fleet_lu_solve, k2.fleet_cholesky_solve = saved


def backward_error(a, x, b):
    """Each scenario's ||A x - b||inf / (||A||inf ||x||inf)."""
    r = (a @ x[..., None])[..., 0] - b
    return r.abs().amax(-1) / (a.abs().sum(-1).amax(-1)
                               * x.abs().amax(-1))


def same_bits_of(x, y):
    return torch.equal(x.view(torch.int64), y.view(torch.int64))


def compare_k2(label, chol, a, b, phase):
    """K2 against its plain version on the same inputs: equal info; where
    both factor, x within K2_X_TOL of the scenario's max|x| and a backward
    error within K2_BACKWARD_TOL; two launches the same bits; the LU's
    pivots, written, equal to getrf's and its factors within K2_FACTOR_TOL
    of the scenario's largest. Returns the worst abs and relative x
    differences."""
    solve, plain = k2_pair(chol)
    x, info = solve(a, b)
    again, _ = solve(a, b)
    ref, rinfo = plain(a, b)
    extra = ""
    if not chol:
        lu, rlu = torch.empty_like(a), torch.empty_like(a)
        piv = torch.empty(a.shape[:2], dtype=torch.int32, device=a.device)
        rpiv = torch.empty_like(piv)
        solve(a, b, lu=lu, piv=piv)
        plain(a, b, lu=rlu, piv=rpiv)
    torch.cuda.synchronize()
    check(torch.equal(info, rinfo), f"{label}: K2's info "
          f"{info.tolist()[:8]} against {rinfo.tolist()[:8]}")
    check(same_bits_of(x, again), f"{label}: two K2 launches differ")
    good = info == 0
    worst_abs = worst_rel = worst_bwd = 0.0
    if good.any():
        diff = (x[good] - ref[good]).abs()
        worst_abs = diff.max().item()
        worst_rel = (diff.amax(-1) / ref[good].abs().amax(-1)).max().item()
        worst_bwd = backward_error(a[good], x[good], b[good]).max().item()
    check(worst_rel <= K2_X_TOL and worst_bwd <= K2_BACKWARD_TOL,
          f"{label}: K2's x {worst_rel:.3e} of max|x| off its plain "
          f"version, backward error {worst_bwd:.3e}")
    if not chol:
        check(torch.equal(piv[good], rpiv[good]), f"{label}: K2's pivots "
              "differ from getrf's")
        if good.any():
            ferr = ((lu[good] - rlu[good]).abs().amax((-2, -1))
                    / rlu[good].abs().amax((-2, -1))).max().item()
            check(ferr <= K2_FACTOR_TOL,
                  f"{label}: K2's factors {ferr:.3e} off getrf's")
            extra = f", pivots equal, factors {ferr!r} of their scale"
        del lu, rlu
    note_rel(k2_name(chol), worst_rel)
    print(f"phase {phase} K2 {'Cholesky' if chol else 'LU'} {label} "
          f"B={a.shape[0]} N={a.shape[1]}: info equal "
          f"({int((~good).sum())} not factored), max abs diff "
          f"{worst_abs!r}, max rel diff {worst_rel!r} of max|x|, backward "
          f"error {worst_bwd!r}, two launches the same bits{extra}")
    return worst_abs, worst_rel


def k2_bound(chol, a):
    """K2's least time: A (the Cholesky reads only its lower triangle,
    N(N+1)/2 doubles) and b read once, x and info written once, or the
    factorization's operations (LU 2N³/3, Cholesky N³/3) and the two
    triangular solves' 2N² over the f64 peak."""
    batch, n = a.shape[:2]
    read = n * (n + 1) // 2 if chol else n * n
    nbytes = batch * (8 * (read + 2 * n) + 4)
    flops = batch * ((n ** 3 / 3 if chol else 2 * n ** 3 / 3) + 2 * n * n)
    return bound(nbytes, flops)


def k2_times(label, chol, a, b, phase, reps=10):
    """K2's ms beside its plain version (the library route of two calls)
    and one library call computing the same x (``torch.linalg.solve_ex``),
    in turns twice (K2, route, solve_ex, K2, route, solve_ex; CUDA events,
    each time the better of its two turns), and K2's device ms alone
    (``queued_ms``); with the scenarios the card holds at once (blocks an
    SM from the occupancy query, times the SMs) and the mode's registers
    and local (spilled) bytes a thread as built. Returns ``(ms, plain_ms,
    bound), library_ms``."""
    solve, plain = k2_pair(chol)
    launched = (k2.fleet_lu_solve.launches, k2.fleet_lu_solve.on_chip)
    turns = {"K2": [], "route": [], "solve_ex": []}
    for _ in range(2):
        turns["K2"].append(cuda_ms(lambda: solve(a, b), reps))
        turns["route"].append(cuda_ms(lambda: plain(a, b), reps))
        turns["solve_ex"].append(
            cuda_ms(lambda: torch.linalg.solve_ex(a, b), reps))
    ms, plain_ms, library_ms = (min(v) for v in turns.values())
    device_ms = queued_ms(lambda: solve(a, b), reps)
    least = k2_bound(chol, a)
    n = a.shape[1]
    per_sm = k2.blocks_per_sm(n, chol)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    regs, local = k2.kernel_attributes(n, chol)
    first = k2.fleet_plan(n, cholesky=chol).first_on_chip
    runs = k2.fleet_lu_solve.launches - launched[0]
    on_chip = k2.fleet_lu_solve.on_chip - launched[1]
    print(f"phase {phase} K2 {'Cholesky' if chol else 'LU'} {label} "
          f"B={a.shape[0]} N={n} ({per_sm} blocks an SM, {per_sm * sms} "
          f"scenarios in flight; first on-chip panel {first} of "
          f"{-(-n // k2.PANEL)}"
          + ("" if chol else f", {on_chip} of {runs} launches on chip")
          + f"; {regs} registers, {local} local bytes a "
          f"thread): in turns K2 "
          + ", ".join(f"{t!r}" for t in turns["K2"])
          + " ms, plain (library route) "
          + ", ".join(f"{t!r}" for t in turns["route"])
          + " ms, torch.linalg.solve_ex "
          + ", ".join(f"{t!r}" for t in turns["solve_ex"])
          + f" ms; K2 device {device_ms!r} ms; bound {least[0]!r} ms by "
          f"{least[1]} ({100 * least[0] / ms!r}%); K2 / route "
          f"{ms / plain_ms!r}, K2 / solve_ex {ms / library_ms!r}")
    return (ms, plain_ms, least), library_ms


def k2_random(n, batch, chol, seed):
    """Random order-``n`` inputs from a seeded generator on the card: for
    the LU ``2 I + N(0, 1/n)`` with its rows shuffled (every column
    pivots), for the Cholesky ``m mᵀ / n + I``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    m = torch.randn(batch, n, n, dtype=torch.float64, device="cuda",
                    generator=gen)
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    if chol:
        a = m @ m.mT / n + eye
    else:
        perm = torch.rand(batch, n, device="cuda", generator=gen).argsort(-1)
        a = (m / n ** 0.5 + 2 * eye).gather(
            1, perm[..., None].expand(-1, -1, n))
    b = torch.randn(batch, n, dtype=torch.float64, device="cuda",
                    generator=gen)
    return a.contiguous(), b


def k2_nr_inputs(case, batch, rng):
    """NR Jacobians and right-hand sides of ``case`` (the Newton system at
    the unknowns' order) from K1 at ``batch`` random states
    (``random_inputs``)."""
    system = case_system(case)
    arr = compile_ac_arrays(system, "cuda")
    res = k1.nr_fill(arr, *random_inputs(arr, system.bus.number, batch,
                                         rng), jacobian=True)
    return res.jac, _nr_rhs(arr, res)


def k2_lu_checks():
    """Phase 4: K2's LU mode against its plain version on K1's Jacobians
    of case14, case30 and case118 at K2_BATCHES scenarios and on random
    order-256 inputs, timed at case14, case30 and case118 x1024 (the last
    for the kernels line), case14 x4 and on the random inputs."""
    rng = np.random.default_rng(SEED)
    err = 0.0
    for case in ("case14test", "case30test", "case118"):
        for batch in K2_BATCHES:
            a, b = k2_nr_inputs(case, batch, rng)
            err = max(err, compare_k2(case, False, a, b, 4)[0])
        times = k2_times(case, False, a, b, 4)
    k2_times("case14test", False, *k2_nr_inputs("case14test", 4, rng), 4)
    a, b = k2_random(k2.CAP, FLEET, False, K2_CAP_SEED)
    err = max(err, compare_k2("random", False, a, b, 4)[0])
    k2_times("random", False, a, b, 4)
    return err, times


def fleet_nr_split(arr, inputs, solve):
    """``batched_nr_solve``'s loop built from its pieces with ``solve`` for
    the step's solves (K2 or the library route), CUDA events around K1,
    the solve, the state update and the readback. Returns the lockstep
    iterations and the split's ms per iteration."""
    vm, va, ps, qs = inputs
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    split = dict.fromkeys(("K1", "solve", "update", "readback"), 0.0)
    res = k1.nr_fill(arr, vm, va, ps, qs, jacobian=True)
    dpq = _max_mismatch(res)
    active = ~((dpq[:, 0] < TOL) & (dpq[:, 1] < TOL))
    go = bool(active.any())
    it = 0
    while it < 20 and go:
        ev[0].record()
        dx, _ = solve(res.jac, _nr_rhs(arr, res))
        ev[1].record()
        vm_new, va_new = _nr_move(arr, vm, va, dx)
        vm = torch.where(active[:, None], vm_new, vm)
        va = torch.where(active[:, None], va_new, va)
        ev[2].record()
        res = k1.nr_fill(arr, vm, va, ps, qs, jacobian=True)
        ev[3].record()
        dpq = _max_mismatch(res)
        active &= ~((dpq[:, 0] < TOL) & (dpq[:, 1] < TOL))
        go = bool(active.any())
        ev[4].record()
        torch.cuda.synchronize()
        for key, i in (("solve", 0), ("update", 1), ("K1", 2),
                       ("readback", 3)):
            split[key] += ev[i].elapsed_time(ev[i + 1])
        it += 1
    return it, {k: v / max(it, 1) for k, v in split.items()}


def phase4():
    arr, inputs = nr_fleet_inputs()
    batched_nr_solve(arr, *inputs)      # warm-up
    k2_err, k2_times_ = k2_lu_checks()
    runs = []
    k2.fleet_lu_solve.launches = k2.fleet_lu_solve.on_chip = 0
    with k2_plain_barred():
        seconds, out = wall_s(lambda: batched_nr_solve(arr, *inputs))
    launches = k2.fleet_lu_solve.launches
    check(launches > 0, "fleet: the NR fleet launched no K2")
    check(k2.fleet_lu_solve.on_chip == launches, f"fleet: "
          f"{k2.fleet_lu_solve.on_chip} of {launches} K2 launches on chip")
    runs.append((True, seconds, out))
    for fill in (k1.nr_fill_ref, k1.nr_fill_ref, k1.nr_fill):
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
    routes = []
    for library in (False, True, True, False):
        with library_route() if library else contextlib.nullcontext():
            seconds, out = wall_s(lambda: batched_nr_solve(arr, *inputs))
        check(torch.equal(out[2], ker[2]), "fleet: the library route "
              "takes other iteration counts")
        routes.append(("library" if library else "K2", total / seconds))
        if library:
            lib = out
    dlib = max((lib[0] - ker[0]).abs().max().item(),
               (lib[1] - ker[1]).abs().max().item())
    check(dlib <= TWIN_STATE_TOL, f"fleet: the library route's state "
          f"differs by {dlib:.3e}")
    print(f"phase 4 case118 fleet x{FLEET}: all converged, "
          f"{total} NR iterations (max {int(ker[2].max())}), state vs "
          f"nr_fill_ref {dstate!r}, vs the library route {dlib!r}; K2 "
          f"launches {launches}, all on chip; NR iterations/s "
          + ", ".join(f"{name} {rate!r}" for name, rate in rates)
          + "; by the step's solve (K1 fill) "
          + ", ".join(f"{name} {rate!r}" for name, rate in routes))
    for name, solve in (("K2", k2.fleet_lu_solve),
                        ("library", k2.fleet_lu_solve_ref)):
        fleet_nr_split(arr, inputs, solve)
        it, split = fleet_nr_split(arr, inputs, solve)
        print(f"phase 4 case118 fleet x{FLEET} per lockstep iteration "
              f"({name} solve, {it} iterations, CUDA events): "
              + ", ".join(f"{k} {v!r} ms" for k, v in split.items())
              + f"; sum {sum(split.values())!r} ms")
    launches += singular_fleet()
    return launches, k2_err, k2_times_


def singular_fleet():
    """Phase 4: case14 x4 with the second scenario started at zero
    magnitudes (a singular Jacobian) gives the JAX package's counts and
    flags, and the CPU run's states for the other three."""
    runs = []
    for device in ("cuda", "cpu"):
        analysis = newton_raphson(power_system(str(DATA / "case14test.m")),
                                  device=device)
        arr = analysis.arrays
        vm, va = (x.expand(4, -1).clone() for x in analysis._state())
        vm[1] = 0.0
        ps = arr.p_sched.expand(4, -1).contiguous()
        qs = arr.q_sched.expand(4, -1).contiguous()
        if device == "cuda":
            res = k1.nr_fill(arr, vm, va, ps, qs, jacobian=True)
            a, b = res.jac, _nr_rhs(arr, res)
            compare_k2("case14 x4, scenario 1 singular", False, a, b, 4)
            info = k2.fleet_lu_solve(a, b)[1].tolist()
            check(info[1] != 0 and info[0] == info[2] == info[3] == 0,
                  f"singular fleet: K2's info {info}")
            k2.fleet_lu_solve.launches = 0
            with k2_plain_barred():
                runs.append(batched_nr_solve(arr, vm, va, ps, qs))
            launches = k2.fleet_lu_solve.launches
        else:
            runs.append(batched_nr_solve(arr, vm, va, ps, qs))
    (vm, va, iters, conv), cpu = runs
    counts, flags = SINGULAR_FLEET
    check(iters.tolist() == counts and conv.tolist() == flags,
          f"singular fleet: {iters.tolist()} iterations, converged "
          f"{conv.tolist()}, JAX {counts}, {flags}")
    good = [0, 2, 3]
    dstate = max((vm[good].cpu() - cpu[0][good]).abs().max().item(),
                 (va[good].cpu() - cpu[1][good]).abs().max().item())
    check(dstate <= CARD_CPU_TOL, f"singular fleet: {dstate:.3e} off the CPU")
    print(f"phase 4 case14 x4 with a singular scenario: iterations "
          f"{iters.tolist()}, converged {conv.tolist()} (JAX {counts}, "
          f"{flags}), good states vs the CPU run {dstate!r}; K2's info at "
          f"the start {info}, K2 launches {launches}")
    return launches


# --------------------------------------------------------------------------
# State estimation (phases 5-7)
# --------------------------------------------------------------------------

def scada_pmu(system, pmu_every=10, noise=False):
    """bench.py's SE measurement set (``_scada_pmu``, bench.py:86-105) from
    the port's own power flow: voltmeters, watt- and varmeters on every bus
    and branch end, polar PMUs on every 10th bus, no noise (with ``noise``,
    each mean drawn around the power flow's value with its variance, from
    the measurement layer's seeded generator)."""
    pf = newton_raphson(system, device="cuda")
    power_flow(pf, power=True)
    mon = measurement(system)
    add_voltmeter(mon, analysis=pf, noise=noise)
    add_wattmeter(mon, analysis=pf, noise=noise)
    add_varmeter(mon, analysis=pf, noise=noise)
    for b in range(0, system.bus.number, pmu_every):
        add_pmu(mon, bus=system.bus.label.label(b),
                magnitude=float(pf.voltage.magnitude[b]),
                angle=float(pf.voltage.angle[b]), polar=True, noise=noise)
    return mon, pf


def solved_case(case):
    system = power_system(str(DATA / f"{case}.m"))
    pf = newton_raphson(system, device="cuda")
    power_flow(pf, power=True, current=True)
    return system, pf


def every_row_type(system, pf):
    """All 21 row types, correlated PMU pairs and two inactive rows."""
    mon = measurement(system)
    add_voltmeter(mon, analysis=pf)
    add_ammeter(mon, analysis=pf)
    add_ammeter(mon, analysis=pf, square=True)
    add_wattmeter(mon, analysis=pf)
    add_varmeter(mon, analysis=pf)
    add_pmu(mon, analysis=pf, polar=True)
    add_pmu(mon, analysis=pf, polar=True, square=True, status_bus=-1)
    add_pmu(mon, analysis=pf)
    add_pmu(mon, analysis=pf, correlated=True, status_from=-1)
    update_voltmeter(mon, mon.voltmeter.label.label(3), status=0)
    update_wattmeter(mon, mon.wattmeter.label.label(5), status=0)
    return mon


def se_sets(system, pf):
    """tests/test_estimation.py's sets (:35-91): SCADA plus ammeters and
    rectangular PMUs, plus polar bus PMUs, plus correlated PMUs."""
    def scada():
        mon = measurement(system)
        add_voltmeter(mon, analysis=pf)
        add_wattmeter(mon, analysis=pf)
        add_varmeter(mon, analysis=pf)
        return mon

    amm = scada()
    add_ammeter(amm, analysis=pf)
    add_pmu(amm, analysis=pf)
    pol = scada()
    add_pmu(pol, analysis=pf, polar=True, status_from=-1, status_to=-1)
    cor = scada()
    add_pmu(cor, analysis=pf, correlated=True)
    return {"scada": scada(), "ammeters+PMUs": amm, "polar PMUs": pol,
            "correlated PMUs": cor}


def se_scenarios(host, nscen, spread=0.5, seed=3):
    """bench.py's ``_se_scenarios`` (bench.py:280-287): base means plus
    spread * sigma * N(0, 1) per row, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    sigma = 1.0 / np.sqrt(host.w)
    return host.mean[None, :] + spread * sigma[None, :] * \
        rng.standard_normal((nscen, len(host.mean)))


def compare_k3(label, arr, net, vm, va, mean):
    """Phase 5: K3 against se_fill_ref on the same inputs, one scenario at
    a time so that the comparison needs no third copy of H."""
    got = k3.se_fill(arr, net, vm, va, mean)
    ref = k3.se_fill_ref(arr, net, vm, va, mean)
    torch.cuda.synchronize()
    worst_rel = worst_abs = 0.0
    where = ""
    pattern = True
    for name in ("h", "r", "jac"):
        for a, b in zip(getattr(got, name), getattr(ref, name)):
            diff = (a - b).abs()
            worst_abs = max(worst_abs, diff.max().item())
            rel = diff / b.abs().clamp(min=1.0)
            k = int(rel.argmax())
            if rel.view(-1)[k].item() > worst_rel:
                worst_rel = rel.view(-1)[k].item()
                row = k // rel.shape[-1] if name == "jac" else k
                where = (f"{name} of a type {int(arr.desc.idx[0, row])} "
                         f"row: {a.view(-1)[k].item()!r} against "
                         f"{b.view(-1)[k].item()!r}")
            if name == "jac":
                pattern &= torch.equal(a != 0, b != 0)
    check(worst_rel <= K3_REL_TOL,
          f"{label}: K3 disagrees with se_fill_ref, rel {worst_rel:.3e} "
          f"at {where}")
    note_rel("se_fill", worst_rel)
    check(pattern, f"{label}: K3 Jacobian pattern differs from se_fill_ref")
    lean = k3.se_fill(arr, net, vm, va, mean, jacobian=False)
    check(torch.equal(lean.h, got.h) and torch.equal(lean.r, got.r),
          f"{label}: K3 without the Jacobian gives other h or r than with "
          f"it")
    b, n = vm.shape
    least = bound(tensor_bytes(arr.desc.idx, arr.desc.coef, arr.status,
                               net.row_ptr, net.cols, net.yg, net.yb,
                               net.diag, vm, va, mean, *got),
                  b * mean.shape[1] * K3_OPS_PER_ROW)
    del got, ref, lean
    ms = cuda_ms(lambda: k3.se_fill(arr, net, vm, va, mean), reps=20)
    dev_ms = queued_ms(lambda: k3.se_fill(arr, net, vm, va, mean), reps=20)
    host = host_us(lambda: k3.se_fill(arr, net, vm, va, mean), reps=20)
    lean_ms, lean_dev = (
        f(lambda: k3.se_fill(arr, net, vm, va, mean, jacobian=False),
          reps=20) for f in (cuda_ms, queued_ms))
    plain_ms = cuda_ms(lambda: k3.se_fill_ref(arr, net, vm, va, mean), reps=5)
    for mode in ("", " without the Jacobian"):
        check_one_launch(f"{label} K3{mode}", lambda: k3.se_fill(
            arr, net, vm, va, mean, jacobian=not mode))
    print(f"phase 5 {label} B={b} n={n} m={mean.shape[1]}: max abs diff "
          f"{worst_abs!r}, max rel diff {worst_rel!r}, pattern equal, h and "
          f"r without the Jacobian equal; one kernel a call and no memset or "
          f"memcpy, with and without the Jacobian (CUDA graph nodes); K3 "
          f"{ms!r} ms per call (device {dev_ms!r} ms queued, host {host!r} "
          f"us), without the "
          f"Jacobian {lean_ms!r} ms (device {lean_dev!r} ms); se_fill_ref "
          f"{plain_ms!r} ms per call (jacobian); bound {least[0]!r} ms by "
          f"{least[1]}")
    return worst_abs, ms, plain_ms, least


def k3_inputs(system, mon, pf, batch, rng):
    """The measurement set on the card, and ``batch`` random states around
    the power-flow state with means perturbed around the set's."""
    arr, types, _, host = compile_se_arrays(system, mon, return_host=True,
                                            device="cuda")
    net = compile_ac_arrays(system, "cuda")
    n = system.bus.number
    vm = pf.voltage.magnitude + 0.01 * rng.standard_normal((batch, n))
    va = pf.voltage.angle + 0.02 * rng.standard_normal((batch, n))
    mean = host.mean + 0.01 * rng.standard_normal((batch, len(host.mean)))
    return arr, net, types, tuple(
        torch.tensor(x, device="cuda") for x in (vm, va, mean))


def phase5():
    rng = np.random.default_rng(SEED)
    worst = 0.0
    for case in ("case14test", "case30test"):
        system, pf = solved_case(case)
        arr, net, types, inputs = k3_inputs(system, every_row_type(system, pf),
                                            pf, 8, rng)
        check(set(types.tolist()) == set(range(1, 22)),
              f"{case}: the set misses row types")
        worst = max(worst, compare_k3(f"{case} all 21 row types", arr, net,
                                      *inputs)[0])
    system = power_system(str(DATA / "case118.m"))
    mon, pf = scada_pmu(system)
    arr, net, _, inputs = k3_inputs(system, mon, pf, SE_FLEET, rng)
    worst = max(worst, compare_k3("case118 fleet", arr, net, *inputs)[0])
    del arr, net, inputs
    system = synthetic_grid(*SE_GRID)
    mon, pf = scada_pmu(system)
    arr, net, _, inputs = k3_inputs(system, mon, pf, SE_CHUNK, rng)
    err, ms, plain_ms, least = compare_k3(
        f"{SE_GRID[0]}x{SE_GRID[1]} grid chunk", arr, net, *inputs)
    return max(worst, err), (ms, plain_ms, least)


# ---- K8: the estimators' gains from H's entry pattern ----------------------

def zero_se_launches():
    """Set the WLS estimators' kernel counts to 0: K3 (dense mode), K3's
    entry mode, K8."""
    k3.se_fill.launches = k3.se_fill_entries.launches = 0
    k8.gain_fill.launches = 0


def se_launches():
    """The WLS estimators' kernel counts since ``zero_se_launches``."""
    return collections.Counter(K3=k3.se_fill.launches,
                               K3e=k3.se_fill_entries.launches,
                               K8=k8.gain_fill.launches)


def dense_ac_gain(arr, res):
    """The AC estimators' dense route, which K8 replaced: the gain ``G =
    (W½H)ᵀ(W½H) + HᵀPH + e_s e_sᵀ`` and right-hand side ``HᵀW r`` from K3's
    dense output ``res`` (P the correlated pair off-diagonals, e_s the
    slack column), one batched f64 GEMM. Scales ``res.jac`` to W½H in
    place."""
    jac = res.jac
    rhs = (jac.mT @ _w_apply_vec(arr, res.r)[..., None])[..., 0]
    if arr.pair_r1.shape[0]:
        # the pair rows, gathered before W½ scales H in place
        h1 = jac[:, arr.pair_r1] * arr.pair_off[:, None]
        h2 = jac[:, arr.pair_r2]
    jac.mul_(arr.w.sqrt()[:, None])
    gain = jac.mT @ jac
    if arr.pair_r1.shape[0]:
        gain += h1.mT @ h2 + h2.mT @ h1
    gain[:, arr.slack, arr.slack] += 1.0  # slack-column identity
    return gain, rhs


def dense_gain(arr, net, vm, va, mean, fill=None, gain=None):
    """The dense route K8 replaced: K3's dense H, then the gain GEMM
    (``dense_ac_gain``)."""
    return dense_ac_gain(arr, k3.se_fill(arr, net, vm, va, mean))


def dense_dc_gain(arr):
    """The DC estimator's dense route: ``(W½Hm)ᵀ(W½Hm) + e_s e_sᵀ`` and
    ``(W½Hm)ᵀ(W½z)``, one GEMM over the dense H."""
    a, b = _dcse_weighted(arr)
    gain = a.mT @ a
    gain[arr.slack, arr.slack] += 1.0
    return gain, a.mT @ b


def dense_pmu_gain(arr):
    """The PMU estimator's dense route: ``HᵀWH`` and ``HᵀWz`` (W with the
    correlated pairs), one GEMM over the dense H."""
    wh, wz = _weighted(arr, arr.h_dense, arr.mean)
    return arr.h_dense.mT @ wh, arr.h_dense.mT @ wz


@contextlib.contextmanager
def dense_gain_route():
    """While active, the estimators' gains take the dense route K8
    replaced (the AC: K3's dense H and one f64 GEMM; DC and PMU: the GEMM
    over their dense H): the yardstick of phases 5b-7 and 11, never the
    main path."""
    saved = (acse_mod._gain_equations, dcse_mod._dcse_normal_equations,
             pmuse_mod._pmuse_normal_equations)
    acse_mod._gain_equations = dense_gain
    dcse_mod._dcse_normal_equations = dense_dc_gain
    pmuse_mod._pmuse_normal_equations = dense_pmu_gain
    try:
        yield
    finally:
        (acse_mod._gain_equations, dcse_mod._dcse_normal_equations,
         pmuse_mod._pmuse_normal_equations) = saved


@contextlib.contextmanager
def gain_plain_barred():
    """While active, a CUDA tensor that reaches the plain versions of K8
    or of K3's entry mode fails the run: the main path must launch K3's
    entry mode and K8 for every gain it forms."""
    saved = (k8.gain_fill_ref, k3.se_fill_entries_ref)

    def barred(fn, tensor_of):
        def guard(*args, **kw):
            check(tensor_of(args).device.type != "cuda",
                  f"{fn.__name__} got a CUDA tensor on the main path")
            return fn(*args, **kw)
        return guard

    k8.gain_fill_ref = barred(saved[0], lambda args: args[1])
    k3.se_fill_entries_ref = barred(saved[1], lambda args: args[2])
    try:
        yield
    finally:
        k8.gain_fill_ref, k3.se_fill_entries_ref = saved


def compare_k3_entries(label, arr, net, vm, va, mean):
    """Phase 5b: K3's entry mode against ``se_fill_entries_ref`` (h, r and
    the values, of max(1, |plain|)), one kernel node a call; its times and
    bound. Returns the mode's output, the worst abs difference and
    ``(ms, plain_ms, bound)``."""
    got = k3.se_fill_entries(arr, net, vm, va, mean)
    ref = k3.se_fill_entries_ref(arr, net, vm, va, mean)
    torch.cuda.synchronize()
    minor = k8.scenario_minor(vm.shape[0])
    check(got.vals.stride() == ref.vals.stride() and (
        not minor or not got.vals.is_contiguous()),
          f"{label}: K3's entry mode gives strides {got.vals.stride()}, its "
          f"plain version {ref.vals.stride()} (scenario-minor: {minor})")
    worst_abs = worst_rel = 0.0
    for name in ("h", "r", "vals"):
        a, b = getattr(got, name), getattr(ref, name)
        diff = (a - b).abs()
        worst_abs = max(worst_abs, diff.max().item())
        worst_rel = max(worst_rel,
                        (diff / b.abs().clamp(min=1.0)).max().item())
    check(worst_rel <= K3_REL_TOL, f"{label}: K3's entry mode disagrees "
          f"with se_fill_entries_ref, rel {worst_rel:.3e}")
    note_rel("se_fill_entries", worst_rel)
    check(torch.equal(got.vals != 0, ref.vals != 0),
          f"{label}: K3's entry mode's zero pattern differs")
    del ref
    check_one_launch(f"{label} K3 entry mode", lambda: k3.se_fill_entries(
        arr, net, vm, va, mean))
    b, n = vm.shape
    m = mean.shape[1]
    desc = arr.desc
    least = bound(tensor_bytes(desc.idx, desc.coef, desc.order, desc.epos,
                               arr.status, net.row_ptr, net.cols, net.yg,
                               net.yb, net.diag, vm, va, mean, *got),
                  b * m * K3_OPS_PER_ROW)
    ms = cuda_ms(lambda: k3.se_fill_entries(arr, net, vm, va, mean), 20)
    dev_ms = queued_ms(lambda: k3.se_fill_entries(arr, net, vm, va, mean),
                       20)
    plain_ms = cuda_ms(lambda: k3.se_fill_entries_ref(arr, net, vm, va,
                                                      mean), 3)
    dense_ms = cuda_ms(lambda: k3.se_fill(arr, net, vm, va, mean), 5)
    print(f"phase 5b {label} B={b} n={n} m={m} E={desc.entries}: K3 entry "
          f"mode ({'scenario-minor' if minor else 'row-major'} values) max "
          f"abs diff {worst_abs!r}, max rel diff {worst_rel!r}, "
          f"one kernel a call; {ms!r} ms (device {dev_ms!r} ms queued), "
          f"se_fill_entries_ref {plain_ms!r} ms, K3's dense H {dense_ms!r} "
          f"ms; bound {least[0]!r} ms by {least[1]} "
          f"({100 * least[0] / ms!r}%)")
    return got, worst_abs, (ms, plain_ms, least)


def k8_bound(table, vals, w, off, r):
    """K8's least time: G and rhs written once, the values, weights,
    residuals and the kernel's tables read once, or its operations over
    the f64 peak."""
    batch, n = vals.shape[0], table.n
    tables = [getattr(table, name) for name in K8_BOUND_TABLES]
    nbytes = 8 * batch * (n * n + n) + tensor_bytes(vals, w, off, r,
                                                    *tables)
    flops = batch * (K8_OPS_PER_CONTRIB * table.c_a.numel()
                     + K8_OPS_PER_RHS * table.col_ref.numel())
    return bound(nbytes, flops)


def same_bits_all(pairs):
    return all(same_bits_of(a, b) for a, b in pairs)


def other_layout(vals):
    """``vals`` copied into the other layout K8 takes: row-major from
    scenario-minor and the other way."""
    return vals.contiguous() if not vals.is_contiguous() else \
        vals.mT.contiguous().mT


def compare_k8(label, table, vals, w, off, r, dense=None):
    """Phase 5b: K8 against ``gain_fill_ref`` bit for bit, in the layout
    given and in the other (``other_layout``), two launches the same bits,
    one kernel node a call; against the dense route's ``dense()`` within
    K8_DENSE_TOL of each scenario's max|G| and max|rhs|. Returns the worst
    abs differences from the plain version and from the dense route."""
    g, rhs = k8.gain_fill(table, vals, w, off, r)
    again = k8.gain_fill(table, vals, w, off, r)
    ref = k8.gain_fill_ref(table, vals, w, off, r)
    other = k8.gain_fill(table, other_layout(vals), w, off, r)
    torch.cuda.synchronize()
    plain_abs = max((a - b).abs().max().item() for a, b in zip((g, rhs), ref))
    check(same_bits_all(zip((g, rhs), ref)),
          f"{label}: K8 differs from gain_fill_ref by {plain_abs!r}")
    check(same_bits_all(zip((g, rhs), again)),
          f"{label}: two K8 launches differ")
    check(same_bits_all(zip((g, rhs), other)),
          f"{label}: K8 in the other layout differs")
    del again, ref, other
    note_rel("gain_fill", 0.0)
    check_one_launch(f"{label} K8", lambda: k8.gain_fill(table, vals, w,
                                                         off, r))
    worst = rel = 0.0
    if dense is not None:
        gd, rd = dense()
        if gd.dim() == 2:
            gd, rd = gd[None], rd[None]
        for a, b in ((g, gd), (rhs, rd)):
            diff = (a - b).abs().flatten(1).amax(1)
            worst = max(worst, diff.max().item())
            rel = max(rel, (diff / b.abs().flatten(1).amax(1)).max().item())
        del gd, rd
        check(rel <= K8_DENSE_TOL, f"{label}: K8 {rel:.3e} of max|G| off "
              "the dense route")
    nnz = table.nz_col.numel()
    regime = "fleet" if k8.scenario_minor(vals.shape[0]) else "small-B"
    bands = (f"{k8.fleet_bands(table).band}-row bands, "
             f"{k8.fleet_shared(table)} shared bytes a fleet block; "
             if regime == "fleet" else "")
    print(f"phase 5b {label} B={vals.shape[0]} N={table.n}: K8 ({regime} "
          f"regime) = gain_fill_ref bit for bit in both layouts, two "
          f"launches the same bits, one kernel a call; {bands}"
          f"{nnz} structural nonzeros ({100 * nnz / table.n ** 2!r}% of G), "
          f"{table.c_a.numel()} contributions, {table.entries} entries; "
          f"vs the dense route max abs {worst!r}, {rel!r} of max|G|")
    return plain_abs, worst


def dense_gain_ms(arr, net, vm, va, mean, reps):
    """CUDA-event ms of the dense route's gain stage alone
    (``dense_ac_gain`` on a fresh dense H each run: it scales H in
    place)."""
    times = []
    for _ in range(reps + 1):
        res = k3.se_fill(arr, net, vm, va, mean)
        times.append(event_ms(lambda: dense_ac_gain(arr, res))[0])
        del res
    return sum(times[1:]) / reps


def k8_times(label, table, vals, w, off, r, dense, reps=5):
    """K8's ms in turns with the dense route's gain (K8, dense, dense, K8;
    ``dense`` times one dense gain), its device ms alone, the plain
    version's ms and the bound. Returns ``(ms, plain_ms, bound),
    dense_ms``."""
    k8_fn = lambda: k8.gain_fill(table, vals, w, off, r)  # noqa: E731
    turns = {"K8": [], "dense": []}
    for which in ("K8", "dense", "dense", "K8"):
        turns[which].append(cuda_ms(k8_fn, reps) if which == "K8"
                            else dense())
    ms, dense_ms = min(turns["K8"]), min(turns["dense"])
    dev_ms = queued_ms(k8_fn, reps)
    plain_ms = cuda_ms(lambda: k8.gain_fill_ref(table, vals, w, off, r), 2)
    least = k8_bound(table, vals, w, off, r)
    print(f"phase 5b {label} B={vals.shape[0]} N={table.n}: in turns K8 "
          + ", ".join(f"{t!r}" for t in turns["K8"])
          + " ms, the dense route's gain "
          + ", ".join(f"{t!r}" for t in turns["dense"])
          + f" ms; K8 device {dev_ms!r} ms; gain_fill_ref {plain_ms!r} ms; "
          f"bound {least[0]!r} ms by {least[1]} "
          f"({100 * least[0] / ms!r}%); K8 / dense {ms / dense_ms!r}")
    return (ms, plain_ms, least), dense_ms


def k8_ac_cell(label, system, mon, pf, batch, rng, timed):
    """Phase 5b on an AC set: K3's entry mode and K8 against their plain
    versions at ``batch`` random states and means, K8 against the dense
    route; with ``timed`` K8 in turns with the dense route's gain.
    Returns the worst abs errors of both, with ``timed`` their times, and
    the batch."""
    arr, net, _, (vm, va, mean) = k3_inputs(system, mon, pf, batch, rng)
    t0 = time.perf_counter()
    table = gain_table(arr, net)
    host_s = time.perf_counter() - t0
    ent, k3e_err, k3e_times = compare_k3_entries(label, arr, net, vm, va,
                                                 mean)
    k8_err = compare_k8(label, table, ent.vals, arr.w, arr.pair_off, ent.r,
                        dense=lambda: dense_gain(arr, net, vm, va, mean))[0]
    print(f"phase 5b {label}: K8's table built on the host in {host_s!r} s")
    times = None
    if timed:
        times = k8_times(label, table, ent.vals, arr.w, arr.pair_off, ent.r,
                         lambda: dense_gain_ms(arr, net, vm, va, mean, 3))
    return k3e_err, k8_err, k3e_times, times, batch


def phase5b():
    """K3's entry mode and K8 against their plain versions (K8 in both
    layouts) and the dense route at K8_BATCHES scenarios and at an odd
    order; K8 timed in turns with the dense route at case118 x256 and
    x1024, the 1,369-bus grid x32 and x1, and the 10k DC set. Returns the
    worst abs errors against the plain versions and the case118 x1024
    times of both (K8's with the dense route's gain)."""
    rng = np.random.default_rng(SEED)
    cells = []
    # K8_BATCHES on both sides of FLEET_MIN: every row type at the small
    # ones, bench.py's set at a rank's 256 and the fleet's 1,024
    for case, batches in (("case14test", (5,)), ("case30test", (7,)),
                          ("case118", (1, 8, 31, 32, 33))):
        system, pf = solved_case(case)
        mon = every_row_type(system, pf)
        for batch in batches:
            cells.append(k8_ac_cell(f"{case} all 21 row types", system, mon,
                                    pf, batch, rng, False))
    system = power_system(str(DATA / "case118.m"))
    mon, pf = scada_pmu(system)
    for batch in (SE_FLEET // 4, SE_FLEET):
        cells.append(k8_ac_cell("case118 fleet", system, mon, pf, batch,
                                rng, True))
    _, _, k3e_times, k8_times_, _ = cells[-1]
    check({c[4] for c in cells} >= {*K8_BATCHES, SE_FLEET // 4, SE_FLEET},
          f"phase 5b ran batches {sorted({c[4] for c in cells})}")
    system = synthetic_grid(*SE_GRID)
    mon, pf = scada_pmu(system)
    for batch in (SE_CHUNK, 1):
        cells.append(k8_ac_cell(f"{SE_GRID[0]}x{SE_GRID[1]} grid", system,
                                mon, pf, batch, rng, True))
    # an odd order (one column a lane, 8-byte stores): the DC set of the
    # same grid, N = 1,369, at its entries and at 33 perturbed copies
    dmon, _ = dc_wattmeters(system)
    darr = dc_state_estimation(dmon, device="cuda").arrays
    dvals, dtable = k8.dense_entries(darr.h_dense, darr.slack)
    check(dtable.n % 2 == 1, f"the odd-N set has N = {dtable.n}")
    doff = darr.w.new_zeros(0)
    for batch in (1, 33):
        noise = torch.tensor(rng.standard_normal((batch, dtable.entries)),
                             device="cuda")
        vals = dvals * (1.0 + 0.01 * noise)
        if k8.scenario_minor(batch):
            vals = vals.mT.contiguous().mT
        mean = darr.mean + 0.01 * torch.tensor(
            rng.standard_normal((batch, darr.mean.shape[0])), device="cuda")
        cells.append((0.0, compare_k8(
            f"{SE_GRID[0]}x{SE_GRID[1]} DC (odd N)", dtable, vals, darr.w,
            doff, mean)[0], None, None, batch))
    del darr, dvals, dtable
    worst_k3e = max(cell[0] for cell in cells)
    worst_k8 = max(cell[1] for cell in cells)
    torch.cuda.empty_cache()

    # the 10k DC set (B = 1) and a correlated PMU set
    system = synthetic_grid(*GRID)
    mon, _ = dc_wattmeters(system)
    arr = dc_state_estimation(mon, device="cuda").arrays
    t0 = time.perf_counter()
    vals, table = k8.dense_entries(arr.h_dense, arr.slack)
    host_s = time.perf_counter() - t0
    off = arr.w.new_zeros(0)
    worst_k8 = max(worst_k8, compare_k8(
        f"{GRID[0]}x{GRID[1]} DC", table, vals, arr.w, off, arr.mean[None],
        dense=lambda: dense_dc_gain(arr))[0])
    print(f"phase 5b {GRID[0]}x{GRID[1]} DC: H's entries and K8's table "
          f"{host_s!r} s (nonzero on the card, table on the host)")
    k8_times(f"{GRID[0]}x{GRID[1]} DC", table, vals, arr.w, off,
             arr.mean[None], lambda: event_ms(lambda: dense_dc_gain(arr))[0],
             reps=3)
    del arr, vals, table
    torch.cuda.empty_cache()
    system = synthetic_grid(*SE_GRID)
    pf = newton_raphson(system, device="cuda")
    power_flow(pf, power=True, current=True)
    mon = measurement(system)
    add_pmu(mon, analysis=pf, correlated=True, noise=False, status_from=-1,
            status_to=-1)
    add_pmu(mon, analysis=pf, noise=False, status_bus=-1)
    arr = pmu_state_estimation(mon, device="cuda").arrays
    vals, table = k8.dense_entries(arr.h_dense, pair_r1=arr.pair_r1,
                                   pair_r2=arr.pair_r2)
    worst_k8 = max(worst_k8, compare_k8(
        f"{SE_GRID[0]}x{SE_GRID[1]} PMU, correlated at the buses", table,
        vals, arr.w, arr.pair_off, arr.mean[None],
        dense=lambda: dense_pmu_gain(arr))[0])
    return (worst_k3e, k3e_times), (worst_k8, k8_times_)


def se_stages(dense):
    """The fill and gain stages of a GN increment: K3's entry mode and K8,
    or (``dense``) the dense route's K3 and GEMM."""
    if dense:
        return (lambda arr, net, vm, va, mean: k3.se_fill(arr, net, vm, va,
                                                          mean),
                lambda arr, net, res: dense_ac_gain(arr, res))
    return (k3.se_fill_entries,
            lambda arr, net, res: k8.gain_fill(
                gain_table(arr, net), res.vals, arr.w, arr.pair_off, res.r))


def se_timed_split(arr, net, vm, va, dense=False):
    """The loop of ``_se_solve`` built from its own pieces, with CUDA events
    around the fill (K3's entry mode; ``dense``: K3's dense H), the gain
    (K8; ``dense``: rhs, W½ scaling and matmul), the Cholesky with its
    solve and residual, and the max|dx| readback."""
    fill, form = se_stages(dense)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    split = {"K3": 0.0, "gain": 0.0, "cholesky": 0.0, "readback": 0.0}
    n = vm.shape[0]
    vm, va, mean = vm[None], va[None], arr.mean[None]
    it = 0
    while True:
        ev[0].record()
        res = fill(arr, net, vm, va, mean)
        ev[1].record()
        gain, rhs = form(arr, net, res)
        del res
        ev[2].record()
        dx, maxinc, _ = _solve_normal(arr, gain, rhs)
        del gain
        ev[3].record()
        inc = float(maxinc)
        ev[4].record()
        done = inc < SE_TOL or it >= 40
        if not done:
            va = va + dx[:, :n]
            vm = vm + dx[:, n:]
            it += 1
        torch.cuda.synchronize()
        for key, a, b in (("K3", 0, 1), ("gain", 1, 2), ("cholesky", 2, 3),
                          ("readback", 3, 4)):
            split[key] += ev[a].elapsed_time(ev[b])
        if done:
            return it, split


def check_se_state(label, analysis, vm, va, tol):
    dvm = float(np.abs(analysis.voltage.magnitude - vm).max())
    dang = analysis.voltage.angle - va
    dva = float(np.abs((dang + np.pi) % (2 * np.pi) - np.pi).max())
    check(analysis.method.converged, f"{label}: not converged")
    check(dvm <= tol and dva <= tol,
          f"{label}: |dvm| {dvm:.3e}, |dva| {dva:.3e} over {tol}")
    return dvm, dva


def phase6():
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    system = synthetic_grid(*SE_GRID)
    t1 = time.perf_counter()
    mon, _ = scada_pmu(system)
    t2 = time.perf_counter()
    se = gauss_newton(mon, device="cuda")
    vm0, va0 = se._state()
    t3 = time.perf_counter()
    zero_se_launches()
    with gain_plain_barred():
        state_estimation(se, power=True)
    torch.cuda.synchronize()
    launches = se_launches()
    t4 = time.perf_counter()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["K3e"] == launches["K8"] == se.method.iteration + 1
          and not launches["K3"],
          f"K3's entry mode / K8 / K3's dense mode launched {launches} for "
          f"{se.method.iteration} iterations")
    check(not se.method.refine_escalated and se.method.refine_residual
          <= 1e-6, f"SE grid: rel {se.method.refine_residual!r}")
    oracle = oracle_wls_se(system, mon)
    check(oracle.converged and se.method.iteration == oracle.iterations,
          f"SE grid: {se.method.iteration} iterations, oracle "
          f"{oracle.iterations}")
    dvm, dva = check_se_state("SE grid", se, oracle.magnitude, oracle.angle,
                              SE_STATE_TOL)
    inj = se.power.injection.active
    check(inj.shape == (system.bus.number,) and np.all(np.isfinite(inj)),
          "SE grid: bad power results")
    m = int(se.arrays.mean.shape[0])
    print(f"phase 6 {SE_GRID[0]}x{SE_GRID[1]} SE main path: n="
          f"{system.bus.number}, m={m}, converged in {se.method.iteration} "
          f"iterations (oracle {oracle.iterations}), max |dvm| {dvm!r}, "
          f"max |dva| {dva!r}, rel {se.method.refine_residual!r}, K3 "
          f"entry-mode and K8 launches {launches['K3e']}, "
          f"{launches['K8']}; wall: power_system {t1 - t0!r} s, power "
          f"flow + measurement set {t2 - t1!r} s, gauss_newton {t3 - t2!r} "
          f"s, state_estimation(power=True) {t4 - t3!r} s; peak device "
          f"memory {peak_gb!r} GB")

    main_se, main_mon = se, mon
    dense = gauss_newton(mon, device="cuda")
    with dense_gain_route():
        t_dense, _ = wall_s(lambda: state_estimation(dense, power=True))
    ddense = max(float(np.abs(dense.voltage.magnitude
                              - se.voltage.magnitude).max()),
                 wrapped_max(dense.voltage.angle, se.voltage.angle))
    check(dense.method.iteration == se.method.iteration
          and dense.method.converged and ddense <= TWIN_STATE_TOL,
          f"SE grid: the dense route took {dense.method.iteration} "
          f"iterations, state {ddense:.3e} off K8's")
    # the same estimate again on the same analysis: K8's table is built
    # once per measurement pattern, in the first solve above
    first = (se.voltage.magnitude, se.voltage.angle)
    se.voltage.magnitude, se.voltage.angle = (x.cpu().numpy()
                                              for x in (vm0, va0))
    with gain_plain_barred():
        t_again, _ = wall_s(lambda: state_estimation(se, power=True))
    check(se.method.iteration == dense.method.iteration
          and np.array_equal(se.voltage.magnitude, first[0])
          and np.array_equal(se.voltage.angle, first[1]),
          "SE grid: a second solve from the same start differs")
    print(f"phase 6 the dense route (K3's dense H, one GEMM): "
          f"{dense.method.iteration} iterations, state vs K8's {ddense!r}; "
          f"state_estimation(power=True) {t_dense!r} s against K8's "
          f"{t4 - t3!r} s (K8's table built inside) and {t_again!r} s "
          f"again on the same analysis (the same bits)")
    del dense
    for route in (False, True):
        it, split = se_timed_split(se.arrays, se.net, vm0, va0, route)
        check(it == se.method.iteration,
              f"SE grid: the timed loop took {it} iterations")
        print(f"phase 6 per-iteration split over {it + 1} increments "
              + ("(the dense route: K3's dense H, the gain GEMM; "
                 if route else "(K3's entry mode, K8; ")
              + "CUDA events): " + ", ".join(
                  f"{k} {v / (it + 1)!r} ms" for k, v in split.items()))

    for case in ("case14test", "case30test"):
        system, pf = solved_case(case)
        runs = [(name, "LU", mon) for name, mon in se_sets(system, pf).items()]
        if case == "case14test":
            runs += [("scada", kind, se_sets(system, pf)["scada"])
                     for kind in ("QR", "PW")]
        for name, kind, mon in runs:
            se = gauss_newton(mon, kind, device="cuda")
            with gain_plain_barred():
                state_estimation(se)
            dvm, dva = check_se_state(f"{case} {name} {kind}", se,
                                      pf.voltage.magnitude,
                                      pf.voltage.angle, SE_STATE_TOL)
            print(f"phase 6 {case} {name} ({kind}): {se.method.iteration} "
                  f"iterations, vs power flow max |dvm| {dvm!r}, max |dva| "
                  f"{dva!r}")
    return launches, main_se, main_mon


def k2_se_inputs(case, batch, rng):
    """Gains and right-hand sides ``HᵀWH + e_s e_sᵀ``, ``HᵀW r`` of
    ``case``'s phase-7 measurement set (``scada_pmu``) from K3's entry mode
    and K8 at ``batch`` random states and means (``k3_inputs``)."""
    system = case_system(case)
    mon, pf = scada_pmu(system)
    arr, net, _, state = k3_inputs(system, mon, pf, batch, rng)
    return _gain_equations(arr, net, *state)


def k2_cholesky_checks():
    """Phase 7: K2's Cholesky mode against its plain version on the SE
    gains of case14, case30 and case118 at K2_BATCHES scenarios and on
    random order-256 inputs, timed at case14, case30 and case118 x1024 (the
    last for the kernels line), case14 x4 and on the random inputs."""
    rng = np.random.default_rng(SEED)
    err = 0.0
    for case in ("case14test", "case30test", "case118"):
        for batch in K2_BATCHES:
            a, b = k2_se_inputs(case, batch, rng)
            err = max(err, compare_k2(case, True, a, b, 7)[0])
        times = k2_times(case, True, a, b, 7)
    k2_times("case14test", True, *k2_se_inputs("case14test", 4, rng), 7)
    a, b = k2_random(k2.CAP, SE_FLEET, True, K2_CAP_SEED)
    err = max(err, compare_k2("random", True, a, b, 7)[0])
    k2_times("random", True, a, b, 7)
    return err, times


def fleet_runs(label, arr, net, vm0, va0, means, chunk):
    """Phase 7: warm-up, then the kernels (K3's entry mode, K8), the plain
    versions twice (``se_fill_entries_ref``, ``gain_fill_ref``) and the
    kernels over all chunks (the first run the main path: its launches are
    counted and no solve may reach the plain versions or the dense route);
    the dense route it replaced in turns (K8, dense, dense, K8), which must
    take the same counts to the same states; where the gain's order is
    within K2's cap, K2 against the library route (K2, library, library,
    K2, each with the kernels); checks, and prints the split of one
    increment by both routes and the rates. Returns the main path's K2
    Cholesky, K3 entry-mode and K8 launches."""
    plain = dict(fill=k3.se_fill_entries_ref, gain=k8.gain_fill_ref)

    def run(**hooks):
        out = []
        for k in range(0, means.shape[0], chunk):
            vm, va, iters, conv = batched_se_solve(
                arr, net, vm0, va0, means[k:k + chunk], **hooks)
            out.append((vm, va, iters, conv))
        return [torch.cat(x) for x in zip(*out)]

    torch.cuda.reset_peak_memory_stats()
    # warm-up of both routes: cuBLAS/cuSOLVER set-up, the allocator's pools
    run()
    run(**plain)
    runs = []
    k2.fleet_cholesky_solve.launches = 0
    zero_se_launches()
    with k2_plain_barred(), gain_plain_barred():
        seconds, out = wall_s(lambda: run())
    launches = se_launches()
    launches["K2c"] = k2.fleet_cholesky_solve.launches
    check(launches["K3e"] > 0 and launches["K3e"] == launches["K8"]
          and not launches["K3"], f"{label}: the main path launched "
          f"{dict(launches)}")
    runs.append(("kernels", seconds, out))
    for hooks in (plain, plain, {}):
        seconds, out = wall_s(lambda: run(**hooks))
        runs.append(("plain versions" if hooks else "kernels", seconds,
                     out))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ker, ref = runs[0][2], runs[1][2]
    nscen = means.shape[0]
    check(bool(ker[3].all()),
          f"{label}: {int((~ker[3]).sum())} of {nscen} did not converge")
    check(torch.equal(ker[2], ref[2]) and torch.equal(ker[3], ref[3]),
          f"{label}: iteration counts differ from the plain versions' run")
    dstate = max((ker[0] - ref[0]).abs().max().item(),
                 (ker[1] - ref[1]).abs().max().item())
    check(dstate <= TWIN_STATE_TOL, f"{label}: state differs by {dstate:.3e}")
    total = int(ker[2].sum())
    dense_runs = []
    for dense in (False, True, True, False):
        with dense_gain_route() if dense else contextlib.nullcontext():
            seconds, out = wall_s(lambda: run())
        check(torch.equal(out[2], ker[2]) and torch.equal(out[3], ker[3]),
              f"{label}: the dense route takes other counts")
        dense_runs.append(("dense" if dense else "K8", seconds))
        if dense:
            dout = out
    ddense = max((dout[0] - ker[0]).abs().max().item(),
                 (dout[1] - ker[1]).abs().max().item())
    check(ddense <= TWIN_STATE_TOL,
          f"{label}: the dense route's state differs by {ddense:.3e}")
    del dout
    split = fleet_split(arr, net, vm0, va0, means[:chunk])
    dsplit = fleet_split(arr, net, vm0, va0, means[:chunk], dense=True)
    # lockstep increments per run: each chunk runs max(iterations) + 1
    steps = sum(int(it.max()) + 1 for it in ker[2].split(chunk))
    wall_ms = 1e3 * min(seconds for _, seconds, _ in runs[::3]) / steps
    solver = (f"K2 ({launches['K2c']} launches)" if launches["K2c"]
              else "torch.linalg (order above K2's cap)")
    print(f"phase 7 {label} one lockstep increment of a chunk (CUDA "
          f"events; K3's entry mode {launches['K3e']} and K8 "
          f"{launches['K8']} launches; {solver}): "
          + ", ".join(f"{k} {v!r} ms" for k, v in split.items())
          + f"; the dense route K8 replaced (K3's dense H, the gain GEMM): "
          + ", ".join(f"{k} {v!r} ms" for k, v in dsplit.items())
          + f"; kernels' run wall per increment {wall_ms!r} ms over {steps} "
          "increments; GN iterations/s in turns "
          + ", ".join(f"{name} {total / sec!r}" for name, sec in dense_runs)
          + f", dense route's state vs K8's {ddense!r}")
    if launches["K2c"]:
        routes = []
        for library in (False, True, True, False):
            with library_route() if library else contextlib.nullcontext():
                seconds, out = wall_s(lambda: run())
            check(torch.equal(out[2], ker[2]) and torch.equal(out[3],
                                                               ker[3]),
                  f"{label}: the library route takes other counts")
            routes.append(("library" if library else "K2", seconds))
            if library:
                lib = out
        dlib = max((lib[0] - ker[0]).abs().max().item(),
                   (lib[1] - ker[1]).abs().max().item())
        check(dlib <= TWIN_STATE_TOL,
              f"{label}: the library route's state differs by {dlib:.3e}")
        with library_route():
            lsplit = fleet_split(arr, net, vm0, va0, means[:chunk])
        print(f"phase 7 {label} the library route (cholesky_ex + "
              f"cholesky_solve), one lockstep increment (CUDA events): "
              + ", ".join(f"{k} {v!r} ms" for k, v in lsplit.items())
              + f"; state vs K2's {dlib!r}; GN iterations/s by the "
              "increment's solve (K3 entry mode, K8) "
              + ", ".join(f"{name} {total / sec!r}" for name, sec in routes))
    print(f"phase 7 {label} x{nscen} (chunks of {chunk}): all converged, "
          f"{total} GN iterations (max {int(ker[2].max())}), state vs "
          f"the plain versions {dstate!r}; peak device memory {peak_gb!r} "
          f"GB; "
          "SE solves/s " + ", ".join(f"{name} {nscen / s!r}"
                                      for name, s, _ in runs)
          + "; GN iterations/s " + ", ".join(f"{name} {total / s!r}"
                                             for name, s, _ in runs))
    return launches


def fleet_split(arr, net, vm, va, mean, dense=False):
    """CUDA-event times of the pieces of one batched increment (K3's entry
    mode, K8's gain, the Cholesky with its solve and residual; ``dense``:
    the dense route's K3 and gain GEMM), after one untimed increment."""
    fill, form = se_stages(dense)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for _ in range(2):
        ev[0].record()
        res = fill(arr, net, vm, va, mean)
        ev[1].record()
        gain, rhs = form(arr, net, res)
        del res
        ev[2].record()
        _solve_normal(arr, gain, rhs)
        ev[3].record()
        del gain, rhs
        torch.cuda.synchronize()
    return {key: ev[a].elapsed_time(ev[a + 1])
            for a, key in enumerate(("K3", "gain", "cholesky"))}


def fleet_inputs(system, nscen, chunk):
    mon, _ = scada_pmu(system)
    arr, _, _, host = compile_se_arrays(system, mon, return_host=True,
                                        device="cuda")
    net = compile_ac_arrays(system, "cuda")
    n = system.bus.number
    # bench.py starts every scenario from the case's stored voltages
    vm0 = torch.tensor(system.bus.voltage.magnitude.array[:n],
                       device="cuda").expand(chunk, -1).contiguous()
    va0 = torch.tensor(system.bus.voltage.angle.array[:n],
                       device="cuda").expand(chunk, -1).contiguous()
    means = torch.tensor(se_scenarios(host, nscen), device="cuda")
    return arr, net, vm0, va0, means


def phase7():
    k2_err, k2_times_ = k2_cholesky_checks()
    system = power_system(str(DATA / "case118.m"))
    launches = fleet_runs("case118 SE fleet",
                          *fleet_inputs(system, SE_FLEET, SE_FLEET),
                          chunk=SE_FLEET)
    check(launches["K2c"] > 0, "case118 SE fleet: launched no K2")
    system = synthetic_grid(*SE_GRID)
    launches += fleet_runs(f"{SE_GRID[0]}x{SE_GRID[1]} SE fleet",
                           *fleet_inputs(system, SE_CHUNK * SE_CHUNKS,
                                         SE_CHUNK), chunk=SE_CHUNK)
    return launches, k2_err, k2_times_


# --------------------------------------------------------------------------
# Gauss-Seidel, DC and fast decoupled power flow (phases 8-10)
# --------------------------------------------------------------------------

def wrapped_max(a, b):
    """max |a - b| of two angle vectors, modulo 2 pi."""
    d = np.asarray(a) - np.asarray(b)
    return float(np.abs((d + np.pi) % (2 * np.pi) - np.pi).max())


def hub_grid(leaves=150, seed=5):
    """A slack, a PQ hub tied to it and to ``leaves`` buses on a ring
    (every 7th a PV bus): the hub's Y row has leaves + 2 entries, wider
    than four chunks of 32 (tests/test_torch_gs_sweep.py builds the same
    grid in both packages)."""
    rng = np.random.default_rng(seed)
    system = power_system()
    add_bus(system, label=1, type=3, magnitude=1.0, angle=0.0)
    add_bus(system, label=2, type=1, active=0.02, reactive=0.01)
    for k in range(leaves):
        pv = k % 7 == 3
        add_bus(system, label=k + 3, type=2 if pv else 1,
                active=0.0 if pv else float(rng.uniform(0.002, 0.01)),
                reactive=0.0 if pv else float(rng.uniform(0.0005, 0.003)))
    add_branch(system, from_bus=1, to_bus=2, resistance=0.001,
               reactance=0.01)
    for k in range(leaves):
        add_branch(system, from_bus=2, to_bus=k + 3,
                   resistance=float(rng.uniform(0.01, 0.03)),
                   reactance=float(rng.uniform(0.05, 0.15)),
                   susceptance=0.01)
        add_branch(system, from_bus=k + 3, to_bus=(k + 1) % leaves + 3,
                   resistance=float(rng.uniform(0.02, 0.05)),
                   reactance=float(rng.uniform(0.1, 0.2)))
    add_generator(system, bus=1, active=0.5, magnitude=1.0)
    for k in range(3, leaves, 7):
        add_generator(system, bus=k + 3, active=0.01, magnitude=1.01)
    return system


def case_system(case):
    if case == "10k grid":
        return synthetic_grid(*GRID)
    if case == "25k grid":
        return synthetic_grid(*BBD_GRID)
    if case == "hub grid":
        return hub_grid()
    return power_system(str(DATA / f"{case}.m"))


def levels(arr):
    """PQ and PV levels of one sweep."""
    return arr.pq_ptr.numel() - 1 + arr.pv_ptr.numel() - 1


def k4_same(a, b):
    """Two K4 results equal bit for bit (state and mismatch)."""
    return (torch.equal(a.vre, b.vre) and torch.equal(a.vim, b.vim)
            and torch.equal(a.mismatch, b.mismatch))


def k4_split_check(label, arr, vre, vim):
    """One launch of K4_SWEEPS sweeps against as many one-sweep launches,
    bit for bit."""
    whole = k4.gs_sweep(arr, vre, vim, max_sweeps=K4_SWEEPS)
    step = k4.gs_sweep(arr, vre, vim, max_sweeps=0)
    for _ in range(K4_SWEEPS):
        step = k4.gs_sweep(arr, step.vre, step.vim, max_sweeps=1)
    check(k4_same(whole, step),
          f"{label}: {K4_SWEEPS} sweeps in one launch differ from "
          f"{K4_SWEEPS} launches")
    return whole


def compare_k4(label, arr, rng):
    """Phase 8: one K4 sweep against gs_sweep_ref from a random state
    around the flat start (the plain version timed on the compared run).
    K4's time is a one-sweep launch made alone, the host's launch path in
    it (``cuda_ms``, as every kernel of the ``kernels`` line); its device
    time alone, and per sweep and per level from a launch of
    K4_TIMED_SWEEPS sweeps against a launch of the mismatch alone, come
    from launches queued back to back (``queued_ms``)."""
    n = arr.bus_type.numel()
    vm = 1.0 + 0.05 * rng.standard_normal(n)
    va = 0.1 * rng.standard_normal(n)
    vre, vim = (torch.tensor(x, device="cuda")
                for x in (vm * np.cos(va), vm * np.sin(va)))
    got = k4.gs_sweep(arr, vre, vim)
    plain_ms, ref = event_ms(lambda: k4.gs_sweep_ref(arr, vre, vim))
    worst_abs, worst_rel = rel_err((got.vre, got.vim, got.mismatch),
                                   (ref.vre, ref.vim, ref.mismatch))
    check(worst_rel <= K4_REL_TOL,
          f"{label}: K4 disagrees with gs_sweep_ref, rel {worst_rel:.3e}")
    note_rel("gs_sweep", worst_rel)
    check(got.info[2:].tolist() == [1.0, 0.0],
          f"{label}: K4 reports {got.info[2:].tolist()} for one sweep")
    # a one-sweep launch reads the table three times: the mismatch, the
    # sweep, the mismatch
    least = bound(tensor_bytes(arr.nb, arr.yre, arr.yim, arr.dre, arr.dim,
                               arr.bus_type, arr.p_sched, arr.q_sched,
                               arr.vg, arr.pq_order, arr.pq_ptr,
                               arr.pv_order, arr.pv_ptr, vre, vim, *got),
                  3 * arr.nb.numel() * K4_OPS_PER_ENTRY
                  + n * K4_OPS_PER_BUS)
    ms = cuda_ms(lambda: k4.gs_sweep(arr, vre, vim), reps=20)
    device_ms = queued_ms(lambda: k4.gs_sweep(arr, vre, vim), reps=20)
    mis_ms = queued_ms(lambda: k4.gs_sweep(arr, vre, vim, max_sweeps=0),
                       reps=20)
    many_ms = queued_ms(lambda: k4.gs_sweep(arr, vre, vim,
                                            max_sweeps=K4_TIMED_SWEEPS),
                        reps=3)
    sweep_us = 1e3 * (many_ms - mis_ms) / K4_TIMED_SWEEPS
    nlev = levels(arr)
    cluster, distributed = k4._layout(0, n, arr.widest, nlev, None, None)
    print(f"phase 8 {label} n={n} row width {arr.nb.shape[1]}, {nlev} "
          f"levels (widest {arr.widest}), cluster {cluster} "
          f"{'distributed' if distributed else 'replicated'}: one sweep + "
          f"mismatch, max abs diff {worst_abs!r}, max rel diff "
          f"{worst_rel!r}; K4 {ms!r} ms launched alone, {device_ms!r} ms "
          f"queued (mismatch alone {mis_ms!r} ms, "
          f"{K4_TIMED_SWEEPS} sweeps {many_ms!r} ms: {sweep_us!r} us a sweep "
          f"with its mismatch, {sweep_us / max(nlev, 1)!r} us a level), "
          f"gs_sweep_ref {plain_ms!r} ms; bound {least[0]!r} ms by "
          f"{least[1]} (the chain of levels sets K4's time)")
    return worst_abs, ms, plain_ms, least, (vre, vim)


def k4_nan_check(label, arr, vre, vim):
    """K4 from the state with one bus NaN, three sweeps to TOL: NaN at the
    buses gs_sweep_ref gives NaN, the other buses within K4_REL_TOL, a NaN
    mismatch pair, the three sweeps done and no convergence, as in jnp."""
    vre = vre.clone()
    vre[vre.numel() // 2] = float("nan")
    got = k4.gs_sweep(arr, vre, vim, max_sweeps=3, tol=TOL)
    ref = k4.gs_sweep_ref(arr, vre, vim, max_sweeps=3, tol=TOL)
    same = all(torch.equal(a.isnan(), b.isnan())
               for a, b in ((got.vre, ref.vre), (got.vim, ref.vim)))
    keep = ~ref.vre.isnan()
    _, rel = rel_err((got.vre[keep], got.vim[keep]),
                     (ref.vre[keep], ref.vim[keep]))
    check(same and rel <= K4_REL_TOL and bool(got.mismatch.isnan().all())
          and got.info[2:].tolist() == [3.0, 0.0],
          f"{label}: K4 from a NaN bus differs from gs_sweep_ref (NaN "
          f"buses alike {same}, rel {rel:.3e}, info {got.info.tolist()})")
    print(f"phase 8 {label}: one bus NaN, 3 sweeps to {TOL}: NaN at the "
          f"same {int((~keep).sum())} buses as gs_sweep_ref, the rest "
          f"within {rel!r} rel, mismatch NaN, not converged")


def phase8():
    rng = np.random.default_rng(SEED)
    worst = 0.0
    times = None
    for case in ("case14test", "case30test", "case118", "10k grid",
                 "25k grid", "hub grid"):
        arr = compile_gs_arrays(case_system(case), "cuda")
        err, ms, plain_ms, least, state = compare_k4(case, arr, rng)
        worst = max(worst, err)
        if case == "case118":
            times = (ms, plain_ms, least)
            k4_nan_check(case, arr, *state)
        if case in ("case118", "10k grid"):
            whole = k4_split_check(case, arr, *state)
            line = (f"phase 8 {case}: {K4_SWEEPS} sweeps in one launch = "
                    f"{K4_SWEEPS} launches bit for bit")
            if case == "10k grid":
                # the other voltage layout: the same bits, its own time
                other = k4._launch(arr, *state, K4_SWEEPS, 0.0,
                                   distributed=True)
                check(k4_same(whole, other),
                      "10k grid: the distributed layout differs")
                lay_ms = [cuda_ms(lambda d=d: k4._launch(
                    arr, *state, K4_SWEEPS, 0.0, distributed=d),
                    reps=3) for d in (False, True, True, False)]
                line += (f"; distributed voltage the same bits; "
                         f"{K4_SWEEPS} sweeps replicated, distributed, "
                         f"distributed, replicated: "
                         + ", ".join(f"{t!r} ms" for t in lay_ms))
            print(line)
    return worst, times


def phase9():
    """Gauss-Seidel ``power_flow`` on case14/30/118 in the JAX package's
    counts, one K4 launch each; then 5,000 sweeps on the 10k grid."""
    total = 0
    for case in ("case14test", "case30test", "case118"):
        nr = newton_raphson(case_system(case), device="cuda")
        power_flow(nr)
        analysis = gauss_seidel(case_system(case), device="cuda")
        vm0, va0 = analysis._state()
        k4.gs_sweep.launches = 0
        seconds, _ = wall_s(lambda: power_flow(analysis, iteration=GS_CAP,
                                               power=True))
        launches = k4.gs_sweep.launches
        total += launches
        it = analysis.method.iteration
        check(analysis.method.converged and it == GS_ITERATIONS[case],
              f"{case} GS: {it} iterations, JAX {GS_ITERATIONS[case]}")
        check(launches == 1,
              f"{case} GS: K4 launched {launches} times for one solve")
        dvm = float(np.abs(analysis.voltage.magnitude
                           - nr.voltage.magnitude).max())
        dva = wrapped_max(analysis.voltage.angle, nr.voltage.angle)
        check(dvm <= GS_NR_TOL and dva <= GS_NR_TOL,
              f"{case} GS vs NR: |dvm| {dvm:.3e}, |dva| {dva:.3e}")
        inj = analysis.power.injection.active
        check(inj.shape == (analysis.system.bus.number,)
              and np.all(np.isfinite(inj)), f"{case} GS: bad power results")
        line = (f"phase 9 {case} Gauss-Seidel main path: converged in {it} "
                f"iterations (JAX {GS_ITERATIONS[case]}), vs NR max |dvm| "
                f"{dvm!r}, max |dva| {dva!r}, K4 launches {launches}; "
                f"power_flow(power=True) wall {seconds!r} s, "
                f"{it / seconds!r} sweeps/s")
        if case != "case118":
            twin = _gs_solve(analysis.arrays, vm0, va0, TOL, GS_CAP,
                             sweep=k4.gs_sweep_ref)
            dtwin = max(float(np.abs(twin[0].cpu().numpy()
                                     - analysis.voltage.magnitude).max()),
                        wrapped_max(twin[1].cpu().numpy(),
                                    analysis.voltage.angle))
            check(twin[2] == it and dtwin <= TWIN_STATE_TOL,
                  f"{case} GS: the gs_sweep_ref loop took {twin[2]} "
                  f"iterations, state {dtwin:.3e} away")
            line += (f"; gs_sweep_ref loop {twin[2]} iterations, state "
                     f"{dtwin!r} away")
        else:
            arr = analysis.arrays
            k4_ms, res = event_ms(lambda: k4.gs_sweep(
                arr, *_to_rect(vm0, va0), max_sweeps=GS_CAP, tol=TOL))
            wall, out = wall_s(lambda: _gs_solve(arr, vm0, va0, TOL, GS_CAP))
            check(out[2] == it and int(res.info[2]) == it,
                  f"{case} GS: the timed solve took {out[2]}")
            line += (f"; _gs_solve wall {wall!r} s, its K4 launch "
                     f"{k4_ms!r} ms ({1e3 * k4_ms / (it + 1)!r} us a sweep "
                     f"with its mismatch, {k4_ms / (1e3 * wall)!r} of the "
                     "wall)")
        print(line)

    analysis = gauss_seidel(case_system("10k grid"), device="cuda")
    k4.gs_sweep.launches = 0
    seconds, _ = wall_s(lambda: power_flow(analysis,
                                           iteration=GS_10K_SWEEPS))
    launches = k4.gs_sweep.launches
    total += launches
    pair = (analysis.method.max_mismatch_active,
            analysis.method.max_mismatch_reactive)
    rel = max(abs(a - b) / b for a, b in zip(pair, GS_10K_PAIR))
    check(analysis.method.iteration == GS_10K_SWEEPS
          and not analysis.method.converged and launches == 1,
          f"10k grid GS: {analysis.method.iteration} sweeps, converged "
          f"{analysis.method.converged}, {launches} launches")
    check(rel <= GS_10K_REL_TOL,
          f"10k grid GS: mismatch {pair} against the JAX package's "
          f"{GS_10K_PAIR}, rel {rel:.3e}")
    print(f"phase 9 10k grid Gauss-Seidel: {GS_10K_SWEEPS} sweeps, not "
          f"converged, mismatch {pair!r} (JAX {GS_10K_PAIR!r}, rel {rel!r}), "
          f"K4 launches {launches}; power_flow wall {seconds!r} s, "
          f"{1e3 * seconds / GS_10K_SWEEPS!r} ms a sweep")
    return total


def dc_fleet(label, system):
    """One factorization and one solve call for FLEET_DC scenarios of
    p_sched (1 + 0.05 N(0, 1)) from default_rng(1), bench.py:230-233."""
    arr = dc_power_flow(system, device="cuda").arrays
    rng = np.random.default_rng(1)
    p_b = arr.p_sched[None] * torch.tensor(
        1.0 + 0.05 * rng.standard_normal((FLEET_DC, 1)), device="cuda")
    theta = batched_dc_solve(arr, p_b)
    check(theta.shape == p_b.shape and bool(theta.isfinite().all()),
          f"{label} DC fleet: bad angles")
    worst = 0.0
    for s in range(0, FLEET_DC, FLEET_DC // 8):
        single = _dc_solve(arr._replace(p_sched=p_b[s]), "LU")
        worst = max(worst, (theta[s] - single).abs().max().item())
    check(worst <= DC_SMALL_TOL,
          f"{label} DC fleet: scenarios differ from single solves by "
          f"{worst:.3e}")
    ms = cuda_ms(lambda: batched_dc_solve(arr, p_b), reps=5)
    single_ms = cuda_ms(lambda: _dc_solve(arr, "LU"), reps=5)
    print(f"phase 10 {label} DC fleet x{FLEET_DC}: 8 scenarios vs single "
          f"solves max |d theta| {worst!r}; {ms!r} ms per fleet (factor + "
          f"one solve of {FLEET_DC} columns, CUDA events), "
          f"{FLEET_DC / ms * 1e3!r} solves/s; single _dc_solve {single_ms!r}"
          " ms")


def fdpf_timed_split(arr, vm, va):
    """The loop of ``_fnr_solve`` built from its own pieces, with CUDA
    events around the two K1 launches, the two ``lu_solve`` half-steps and
    the mismatch readback (its scaling and amax kernels, the copy and the
    host's round trip)."""
    n = vm.shape[0]
    not_slack = torch.arange(n, device=vm.device) != arr.slack
    is_pq = arr.bus_type == 1
    split = {"K1": 0.0, "lu_solve": 0.0, "readback": 0.0}

    def k1_fill(vm, va):
        return k1.nr_fill(arr, vm[None], va[None], arr.p_sched[None],
                          arr.q_sched[None])

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
    ev[0].record()
    res = k1_fill(vm, va)
    ev[1].record()
    torch.cuda.synchronize()
    split["K1"] += ev[0].elapsed_time(ev[1])
    it = 0
    while True:
        ev[2].record()
        mp, mq = res.mp[0] / vm, res.mq[0] / vm
        del_p, del_q = torch.stack([mp.abs().amax(), mq.abs().amax()]).tolist()
        ev[3].record()
        done = (del_p < TOL and del_q < TOL) or it >= FDPF_CAP
        if not done:
            va = va + torch.where(not_slack, linalg.solve(arr.bp, mp), 0.0)
            ev[4].record()
            mq = k1_fill(vm, va).mq[0] / vm
            ev[5].record()
            vm = vm + torch.where(is_pq, linalg.solve(arr.bq, mq), 0.0)
            ev[6].record()
            res = k1_fill(vm, va)
            ev[7].record()
            it += 1
        torch.cuda.synchronize()
        split["readback"] += ev[2].elapsed_time(ev[3])
        if done:
            return it, split
        split["lu_solve"] += (ev[3].elapsed_time(ev[4])
                              + ev[5].elapsed_time(ev[6]))
        split["K1"] += ev[4].elapsed_time(ev[5]) + ev[6].elapsed_time(ev[7])


def fdpf_run(case, bx):
    label = f"{case} FDPF {'BX' if bx else 'XB'}"
    build = fast_newton_raphson_bx if bx else fast_newton_raphson_xb
    system = case_system(case)
    t_asm, (bp, bq) = wall_s(lambda: _fnr_matrices(system, bx, "cuda"))
    t_lu, _ = wall_s(lambda: (linalg.factorize(bp), linalg.factorize(bq)))
    del bp, bq
    t_system, fresh = wall_s(lambda: case_system(case))
    t_build, analysis = wall_s(lambda: build(fresh, device="cuda"))
    vm0, va0 = analysis._state()
    k1.nr_fill.launches = 0
    t_solve, _ = wall_s(lambda: power_flow(analysis, iteration=FDPF_CAP))
    launches = k1.nr_fill.launches
    it = analysis.method.iteration
    oracle = oracle_fdpf(case_system(case), bx=bx, iteration=FDPF_CAP)
    check(launches == 2 * it + 1,
          f"{label}: K1 launched {launches} times for {it} iterations")
    check(analysis.method.converged and oracle.converged
          and it == oracle.iterations,
          f"{label}: {it} iterations, oracle {oracle.iterations}")
    dvm = float(np.abs(analysis.voltage.magnitude - oracle.magnitude).max())
    dva = wrapped_max(analysis.voltage.angle, oracle.angle)
    check(dvm <= GRID_STATE_TOL and dva <= GRID_STATE_TOL,
          f"{label}: |dvm| {dvm:.3e}, |dva| {dva:.3e}")
    runs, split = fdpf_timed_split(analysis.arrays, vm0, va0)
    check(runs == it, f"{label}: the timed loop took {runs} iterations")
    print(f"phase 10 {label}: n={system.bus.number}, {it} iterations (oracle "
          f"{oracle.iterations}), max |dvm| {dvm!r}, max |dva| {dva!r}, K1 "
          f"launches {launches}; wall: power_system {t_system!r} s, "
          f"construction {t_build!r} s (B'/B'' assembly {t_asm!r} s, two "
          f"f64 LU {t_lu!r} s), power_flow {t_solve!r} s; per iteration (CUDA events): K1 "
          f"{split['K1'] / (it + 1)!r} ms for two launches, two lu_solve "
          f"{split['lu_solve'] / it!r} ms, readback "
          f"{split['readback'] / (it + 1)!r} ms")


def limits_run(device):
    """tests/test_limits.py's sequence on case118 with FDPF BX."""
    system = case_system("case118")
    analysis = fast_newton_raphson_bx(system, device=device)
    power_flow(analysis, iteration=300)
    first = analysis.method.iteration
    with suppress():
        flags = reactive_limit(analysis)
    analysis = fast_newton_raphson_bx(system, device=device)
    power_flow(analysis, iteration=300)
    analysis.method.iteration += first
    adjust_angle(analysis, system.bus.label.label(0))
    return flags, analysis


def phase10():
    for case, tol in (("case14test", DC_SMALL_TOL),
                      ("case30test", DC_SMALL_TOL),
                      ("10k grid", GRID_STATE_TOL)):
        t_system, system = wall_s(lambda: case_system(case))
        t_build, analysis = wall_s(lambda: dc_power_flow(system,
                                                         device="cuda"))
        t_solve, _ = wall_s(lambda: power_flow(analysis, power=True))
        dva = wrapped_max(analysis.voltage.angle,
                          oracle_dc(case_system(case)).angle)
        check(dva <= tol, f"{case} DC: |d theta| {dva:.3e} over {tol}")
        flow = analysis.power.from_.active
        check(flow.shape == (analysis.system.branch.number,)
              and np.all(np.isfinite(flow)), f"{case} DC: bad power results")
        print(f"phase 10 {case} DC main path: vs oracle_dc max |d theta| "
              f"{dva!r}, max |theta| "
              f"{float(np.abs(analysis.voltage.angle).max())!r}; wall: "
              f"power_system {t_system!r} s, dc_power_flow {t_build!r} s, "
              f"power_flow(power=True) "
              f"{t_solve!r} s")
    dc_fleet("case118", case_system("case118"))
    dc_fleet("10k grid", case_system("10k grid"))
    for case in ("10k grid", "case118"):
        for bx in (True, False):
            fdpf_run(case, bx)

    flags, card = limits_run("cuda")
    cpu_flags, cpu = limits_run("cpu")
    dstate = max(float(np.abs(card.voltage.magnitude
                              - cpu.voltage.magnitude).max()),
                 float(np.abs(card.voltage.angle - cpu.voltage.angle).max()))
    check(np.array_equal(flags, cpu_flags) and np.any(flags != 0)
          and card.method.iteration == cpu.method.iteration
          and card.method.converged and dstate <= TWIN_STATE_TOL,
          f"case118 reactive limits: card and CPU runs differ (flags "
          f"{flags.tolist()} / {cpu_flags.tolist()}, iterations "
          f"{card.method.iteration} / {cpu.method.iteration}, state "
          f"{dstate:.3e})")
    print(f"phase 10 case118 FDPF BX reactive limits: "
          f"{int(np.sum(flags != 0))} generators at a limit, {card.method.iteration} iterations in "
          f"all, card vs CPU state {dstate!r}")


# --------------------------------------------------------------------------
# Linear estimators and bad data (phases 11-12)
# --------------------------------------------------------------------------

def dc_wattmeters(system):
    """Zero-noise wattmeters at every bus and branch end from the port's DC
    power flow on the card."""
    pf = dc_power_flow(system, device="cuda")
    power_flow(pf, power=True)
    mon = measurement(system)
    add_wattmeter(mon, analysis=pf, noise=False)
    return mon, pf


def linear_split(host_fn, from_numpy, fields, normal_equations, dense,
                 system, mon):
    """The construction and LU solve of a linear estimator from its own
    pieces: host seconds of the COO rows, CUDA-event ms of the H scatter,
    wall s of H's entries and K8's table (the first gain's), CUDA-event ms
    of the gain by K8 (``normal_equations``) in turns with the dense route
    (``dense``: W scaling and GEMM; K8, dense, dense, K8), and of the LU
    factor + solve. ``fields`` names the host rows' fields ``from_numpy``
    takes besides H."""
    t_host, host = wall_s(lambda: host_fn(system, mon))
    scatter, h = event_ms(lambda: linalg.dense_from_coo(
        host.rows, host.cols, host.vals, host.shape, "cuda"))
    arr = from_numpy(h_dense=h, device="cuda",
                     **{name: getattr(host, name) for name in fields})
    t_table, _ = wall_s(lambda: k8.dense_entries(
        arr.h_dense, getattr(arr, "slack", -1), getattr(arr, "pair_r1", None),
        getattr(arr, "pair_r2", None)))
    turns = {"K8": [], "dense": []}
    for route in ("K8", "dense", "dense", "K8"):
        ms, (gain, rhs) = event_ms(lambda: (normal_equations if route == "K8"
                                            else dense)(arr))
        turns[route].append(ms)
    solve_ms, _ = event_ms(
        lambda: linalg.solve(linalg.factorize(gain, linalg.LU), rhs))
    return (f"host rows {t_host!r} s, H scatter {scatter!r} ms, H's entries "
            f"and K8's table {t_table!r} s, gain by K8 "
            + ", ".join(f"{t!r}" for t in turns["K8"])
            + " ms, by the dense route (W scaling, GEMM) "
            + ", ".join(f"{t!r}" for t in turns["dense"])
            + f" ms, LU factor+solve {solve_ms!r} ms (CUDA events), "
            f"m={host.shape[0]}, state {host.shape[1]}")


def projection_times(label, h, w, mask_cols):
    """The dense projection on the card (CUDA events) against the host
    Takahashi path (wall, with the CSR copy), and their largest
    difference relative to 1/w."""
    dense_ms, c = event_ms(lambda: _projection_diag(h, w, mask_cols))
    t_csr, hs = wall_s(lambda: _host_csr(h))
    w_host = w.cpu().numpy()
    t_taka, c_sparse = wall_s(lambda: projection_diag_sparse(
        hs, w_host, mask_cols=mask_cols))
    diff = float(np.max(np.abs(c.cpu().numpy() - c_sparse) * w_host))
    print(f"phase 11/12 {label} projection diag(H G^-1 H^T), m={h.shape[0]}"
          f", state {h.shape[1]}: dense on the card {dense_ms!r} ms (CUDA "
          f"events), host Takahashi {t_taka!r} s + CSR copy {t_csr!r} s; "
          f"max |c_dense - c_takahashi| w {diff!r}")


def check_linear(label, se, vm, va, tol):
    dva = wrapped_max(se.voltage.angle, va)
    dvm = (float(np.abs(se.voltage.magnitude - vm).max())
           if vm is not None else 0.0)
    check(se.method.converged and dva <= tol and dvm <= tol,
          f"{label}: |dvm| {dvm:.3e}, |dva| {dva:.3e} over {tol}")
    return max(dvm, dva)


def card_vs_cpu(label, build, mon, kind, vm, va):
    """One linear estimate on the card and on the CPU: both against the
    reference state, and against each other. Returns the card solve's K8
    launches."""
    t_build, se = wall_s(lambda: build(mon, kind, device="cuda"))
    zero_se_launches()
    with gain_plain_barred():
        t_solve, _ = wall_s(lambda: state_estimation(se))
    launches = se_launches()["K8"]
    cpu = build(mon, kind, device="cpu")
    state_estimation(cpu)
    err = check_linear(label, se, vm, va, LINEAR_TOL)
    dcpu = check_linear(f"{label} card vs CPU", se, getattr(
        cpu.voltage, "magnitude", None), cpu.voltage.angle, CARD_CPU_TOL)
    print(f"phase 11 {label} ({kind}): vs reference {err!r}, card vs CPU "
          f"{dcpu!r}; wall: construction {t_build!r} s, state_estimation "
          f"{t_solve!r} s; K8 launches {launches}")
    return launches


def phase11():
    # 10k-bus DC SE: every wattmeter, zero noise, LU
    system = synthetic_grid(*GRID)
    mon, _ = dc_wattmeters(system)
    oracle = oracle_dc(synthetic_grid(*GRID))
    torch.cuda.reset_peak_memory_stats()
    t_build, se = wall_s(lambda: dc_state_estimation(mon, device="cuda"))
    zero_se_launches()
    with gain_plain_barred():
        t_solve, _ = wall_s(lambda: state_estimation(se, power=True))
    launches = se_launches()
    check(launches["K8"] == 1, f"10k DC SE: K8 launched {launches['K8']} "
          "times for one solve")
    err = check_linear("10k DC SE", se, None, oracle.angle, LINEAR_TOL)
    print(f"phase 11 10k grid DC SE main path: m={se.arrays.mean.shape[0]}, "
          f"vs oracle_dc {err!r}; wall: dc_state_estimation {t_build!r} s, "
          f"state_estimation(power=True) {t_solve!r} s (K8 launches "
          f"{launches['K8']}, its table built inside); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9!r} GB")
    theta = se.voltage.angle.copy()
    with dense_gain_route():
        t_dense, _ = wall_s(lambda: state_estimation(se, power=True))
    ddense = wrapped_max(se.voltage.angle, theta)
    check(ddense <= CARD_CPU_TOL, f"10k DC SE: the dense route's angles "
          f"{ddense:.3e} off K8's")
    print(f"phase 11 10k grid DC SE by the dense route (one GEMM over H): "
          f"state_estimation(power=True) {t_dense!r} s, angles vs K8's "
          f"{ddense!r}")
    print("phase 11 10k grid DC SE split: "
          + linear_split(_dcse_host, dcse_arrays_from_numpy,
                         ("mean", "w", "slack", "slack_angle"),
                         _dcse_normal_equations, dense_dc_gain, system, mon))

    # one planted gross error: chi, the dense residual test, re-estimation
    k = system.bus.number + system.branch.number // 2
    label = mon.wattmeter.label.label(k)
    update_wattmeter(mon, label, active=10.0)
    state_estimation(se)
    chi = chi_test(se)
    check(chi.detect, f"10k DC SE: chi test misses the planted error {chi}")
    t_rt, bad = wall_s(lambda: residual_test(se, THRESHOLD, sparse=False))
    check(bad.detect and bad.label == label,
          f"10k DC SE: residual_test named {bad.label}, planted {label}")
    state_estimation(se)
    after = chi_test(se)
    check(not after.detect, f"10k DC SE: chi test after removal {after}")
    err = check_linear("10k DC SE re-estimated", se, None, oracle.angle,
                       LINEAR_TOL)
    print(f"phase 11 10k grid DC bad data: chi objective {chi.objective!r} "
          f"over {chi.treshold!r}, residual_test(sparse=False) named the "
          f"planted wattmeter (rn {bad.max_normalized_residual!r}, "
          f"{t_rt!r} s), after re-estimation chi {after.objective!r}, vs "
          f"oracle_dc {err!r}")
    projection_times("10k DC", se.arrays.h_dense, se.arrays.w,
                     [se.arrays.slack])
    del se

    # DC QR on case118; the nonzero slack angle with PMU angle rows
    mon, _ = dc_wattmeters(case_system("case118"))
    se = dc_state_estimation(mon, "QR", device="cuda")
    state_estimation(se)
    err = check_linear("case118 DC SE QR", se, None,
                       oracle_dc(case_system("case118")).angle, DC_SMALL_TOL)
    print(f"phase 11 case118 DC SE (QR): vs oracle_dc {err!r}")
    system = case_system("case14test")
    system.bus.voltage.angle[system.bus.layout.slack] = 0.2
    mon, pf = dc_wattmeters(system)
    for b in range(0, system.bus.number, 3):
        add_pmu(mon, bus=system.bus.label.label(b), magnitude=1.0,
                angle=float(pf.voltage.angle[b]), noise=False)
    se = dc_state_estimation(mon, device="cuda")
    state_estimation(se)
    err = check_linear("slack-angle DC SE", se, None, pf.voltage.angle,
                       DC_SMALL_TOL)
    chi = chi_test(se)
    bad = residual_test(se)
    check(not chi.detect and not bad.detect
          and bad.max_normalized_residual < 1e-6,
          f"slack-angle DC SE: chi {chi}, residual test {bad}")
    print(f"phase 11 case14 DC SE, slack angle 0.2 rad + PMU angle rows: "
          f"vs power flow {err!r}, chi objective {chi.objective!r}, max rn "
          f"{bad.max_normalized_residual!r}")

    # PMU SE: placed PMUs (case118, case300), full coverage (1,369 buses)
    pmu_launches = 0
    for case in ("case118", "case300"):
        system, pf = solved_case(case)
        mon = measurement(system)
        t_place, placement = wall_s(
            lambda: pmu_placement_apply(mon, pf, noise=False))
        print(f"phase 11 {case} pmu_placement_apply: {len(placement.bus)} "
              f"buses, {mon.pmu.number} PMUs, {t_place!r} s")
        for kind in ("LU", "QR"):
            pmu_launches += card_vs_cpu(
                f"{case} placed PMUs", pmu_state_estimation, mon, kind,
                pf.voltage.magnitude, pf.voltage.angle)
    system = synthetic_grid(*SE_GRID)
    pf = newton_raphson(system, device="cuda")
    power_flow(pf, power=True, current=True)
    # every bus and branch end; then every bus with correlated PMUs (a
    # correlated PMU on a branch carrying ~1e-4 p.u. of current has a near
    # singular 2x2 covariance, weights ~1e15, and the normal equations
    # lose the 1e-8: ROADMAP queue 3)
    for corr, kinds in ((False, ("LU", "QR")), (True, ("LU",))):
        mon = measurement(system)
        side = {"status_from": -1, "status_to": -1} if corr else {}
        add_pmu(mon, analysis=pf, correlated=corr, noise=False, **side)
        for kind in kinds:
            pmu_launches += card_vs_cpu(
                f"{SE_GRID[0]}x{SE_GRID[1]} "
                + ("correlated PMUs at every bus" if corr
                   else "PMUs at every bus and branch end"),
                pmu_state_estimation, mon, kind, pf.voltage.magnitude,
                pf.voltage.angle)
    print(f"phase 11 {SE_GRID[0]}x{SE_GRID[1]} PMU SE split (correlated): "
          + linear_split(_pmuse_host, pmuse_arrays_from_numpy,
                         ("mean", "w", "pair_r1", "pair_r2", "pair_off"),
                         _pmuse_normal_equations, dense_pmu_gain, system,
                         mon))
    return launches["K8"] + pmu_launches


def planted(mon, errors):
    for idx, value in errors:
        update_wattmeter(mon, mon.wattmeter.label.label(idx), active=value)
    return [mon.wattmeter.label.label(idx) for idx, _ in errors]


def stepwise_lnr(se):
    """The reference usage: residual_test + state_estimation until nothing
    is detected."""
    state_estimation(se)
    removed = []
    for _ in range(10):
        bad = residual_test(se, THRESHOLD)
        if not bad.detect:
            return removed
        removed.append(bad.label)
        state_estimation(se)
    return removed


def scipy_lnr(system, mon):
    """bench.py's CPU loop (bench.py:446-467): oracle WLS, the residual
    covariance from a sparse LU, the worst row out, repeat."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu
    removed = []
    while len(removed) < 10:
        res = oracle_wls_se(system, mon)
        keep = np.ones(res.jacobian.shape[1])
        keep[res.slack] = 0.0
        hm = (res.jacobian.tocsc() @ sp.diags(keep)).tocsc()
        gain = (hm.T @ sp.diags(res.weights) @ hm
                + sp.diags(1.0 - keep)).tocsc()
        ginv_ht = splu(gain).solve(hm.T.toarray())
        c = 1.0 / res.weights - np.einsum("ji,ji->i", ginv_ht,
                                          hm.toarray().T)
        rn = np.abs(res.residual) / np.sqrt(np.maximum(c, 1e-14))
        k = int(np.argmax(rn))
        if rn[k] <= THRESHOLD:
            break
        removed.append(_deactivate(mon, *res.row_device[k]))
    return removed


def lnr_rounds(se):
    """The loop of ``lnr_removal`` built from its own pieces, with CUDA
    events around each round's solve and detection; returns the removed
    devices' labels and the per-round ms."""
    arr, net = se.arrays, se.net
    groups = {}
    row_group = torch.tensor([groups.setdefault(kd, len(groups))
                              for kd in se.method.row_device], device="cuda")
    vm, va = se._state()
    status, removed, rounds = arr.status, [], []
    while True:
        live = arr._replace(status=status)
        solve_ms, (vm, va) = event_ms(lambda: _se_solve(
            live, net, vm, va, SE_TOL, 40, linalg.LU)[:2])
        detect_ms, (row, rn) = event_ms(lambda: _lnr_detect(live, net, vm,
                                                            va))
        rounds.append((solve_ms, detect_ms))
        if not rn > THRESHOLD:
            return removed, rounds
        status = status * (row_group != row_group[row])
        kind, dev = se.method.row_device[row]
        removed.append(getattr(se.monitoring, kind).label.label(dev))


def phase12():
    launches = collections.Counter()
    # bench config 4's shape: case118, scada_pmu, wattmeters 3 and 40
    def config4():
        system = case_system("case118")
        mon, _ = scada_pmu(system)
        return system, mon, planted(mon, CONFIG4_PLANTED)

    _, mon, want = config4()
    se = gauss_newton(mon, device="cuda")
    zero_se_launches()
    k2.fleet_cholesky_solve.launches = 0
    with k2_plain_barred(), gain_plain_barred():
        t_lnr, labels = wall_s(lambda: lnr_removal(se, THRESHOLD, 10))
    lnr = se_launches()
    launches += lnr
    k2_launches = k2.fleet_cholesky_solve.launches
    check(lnr["K3"] > 0 and lnr["K3e"] > 0 and lnr["K8"] > 0
          and k2_launches > 0,
          f"config 4: lnr_removal launched {dict(lnr)}, K2 {k2_launches}")
    _, mon_a, _ = config4()
    se_a = gauss_newton(mon_a, device="cuda")
    zero_se_launches()
    with gain_plain_barred():
        t_step, stepwise = wall_s(lambda: stepwise_lnr(se_a))
    launches += se_launches()
    system_c, mon_c, _ = config4()
    t_scipy, by_scipy = wall_s(lambda: scipy_lnr(system_c, mon_c))
    dstate = max(float(np.abs(se.voltage.magnitude
                              - se_a.voltage.magnitude).max()),
                 wrapped_max(se.voltage.angle, se_a.voltage.angle))
    check(labels == stepwise == by_scipy and sorted(labels) == sorted(want)
          and se.method.converged and dstate <= LNR_STATE_TOL,
          f"config 4: lnr_removal {labels}, stepwise {stepwise}, scipy "
          f"{by_scipy}, planted {want}, converged {se.method.converged}, "
          f"state {dstate:.3e}")
    _, mon_t, _ = config4()
    timed, rounds = lnr_rounds(gauss_newton(mon_t, device="cuda"))
    check(timed == labels, f"config 4: the timed loop removed {timed}")
    print(f"phase 12 config 4 (case118, wattmeters 3 and 40 planted): "
          f"lnr_removal, the stepwise loop and the scipy loop removed "
          f"{labels}; state vs stepwise {dstate!r}; wall: lnr_removal "
          f"{t_lnr!r} s, stepwise {t_step!r} s, scipy {t_scipy!r} s; K2 "
          f"launches {k2_launches}; per round (CUDA events, solve / detect "
          "ms): "
          + ", ".join(f"{s!r} / {d!r}" for s, d in rounds))

    # the 1,369-bus set of phase 6 with three planted wattmeter errors
    system = synthetic_grid(*SE_GRID)
    n = system.bus.number
    errors = ((n // 6, 3.0), (n // 2, -3.0), (5 * n // 6, 4.0))
    mon, _ = scada_pmu(system)
    want = planted(mon, errors)
    se = gauss_newton(mon, device="cuda")
    zero_se_launches()
    with gain_plain_barred():
        state_estimation(se)
    chi = chi_test(se)
    t_dense, dense = wall_s(lambda: residual_test(se, THRESHOLD,
                                                  sparse=False))
    check(chi.detect, f"{SE_GRID} SE: chi test {chi}")
    check(dense.detect and dense.label in want,
          f"{SE_GRID} SE: residual_test (dense) named {dense.label}")
    # put the named wattmeter back in service: the Takahashi path sees the
    # same state and the same rows
    mon.wattmeter.active.status[se.method.row_device[dense.index][1]] = 1
    mon.changed_values()
    t_sparse, sparse = wall_s(lambda: residual_test(se, THRESHOLD,
                                                    sparse=True))
    launches += se_launches()
    check(dense.label == sparse.label
          and abs(dense.max_normalized_residual
                  - sparse.max_normalized_residual) <= RN_SPARSE_TOL,
          f"{SE_GRID} SE: residual_test dense {dense}, sparse {sparse}")
    h, _ = build_h(se.arrays, se.net, *se._state())
    projection_times(f"{SE_GRID[0]}x{SE_GRID[1]} AC", h, se.arrays.w,
                     [se.arrays.slack])
    del h
    mon, _ = scada_pmu(synthetic_grid(*SE_GRID))
    planted(mon, errors)
    se = gauss_newton(mon, device="cuda")
    zero_se_launches()
    with gain_plain_barred():
        t_lnr, labels = wall_s(lambda: lnr_removal(se, THRESHOLD, 10))
    launches += se_launches()
    check(sorted(labels) == sorted(want) and se.method.converged,
          f"{SE_GRID} SE: lnr_removal removed {labels}, planted {want}")
    print(f"phase 12 {SE_GRID[0]}x{SE_GRID[1]} SE, three planted "
          f"wattmeters: chi objective {chi.objective!r} over "
          f"{chi.treshold!r}; residual_test dense ({t_dense!r} s) and "
          f"Takahashi ({t_sparse!r} s) named {dense.label}, max rn "
          f"{dense.max_normalized_residual!r} / "
          f"{sparse.max_normalized_residual!r}; lnr_removal removed "
          f"{labels} in {t_lnr!r} s; launches of K3 (dense, the "
          f"detections), K3's entry mode and K8 {dict(launches)}")
    return launches, k2_launches


# --------------------------------------------------------------------------
# Bordered-block-diagonal scale path (phases 13-15)
# --------------------------------------------------------------------------

def rel_err(got, ref):
    """max |a - b| and max |a - b| / max(1, |b|) over pairs of tensors."""
    worst_abs = worst_rel = 0.0
    for a, b in zip(got, ref):
        diff = (a - b).abs()
        worst_abs = max(worst_abs, diff.max().item())
        worst_rel = max(worst_rel,
                        (diff / b.abs().clamp(min=1.0)).max().item())
    return worst_abs, worst_rel


def compare_k1_routed(label, arr, rng):
    """Phase 13: K1's routed mode against nr_fill_routed_ref at a random
    state of the BBD layout ``arr``."""
    net = arr.net
    n = net.bus_type.numel()
    vm = torch.tensor(1.0 + 0.05 * rng.standard_normal(n), device="cuda")
    va = torch.tensor(0.2 * rng.standard_normal(n), device="cuda")
    got = k1.nr_fill_routed(net, arr.route, vm, va)
    ref = k1.nr_fill_routed_ref(net, arr.route, vm, va)
    torch.cuda.synchronize()
    worst_abs, worst_rel = rel_err(got, ref)
    check(worst_rel <= K1_REL_TOL,
          f"{label}: K1 routed disagrees with its plain version, rel "
          f"{worst_rel:.3e}")
    note_rel("nr_fill_routed", worst_rel)
    check(torch.equal(got.buf != 0, ref.buf != 0),
          f"{label}: K1 routed pattern differs from its plain version")
    least = bound(tensor_bytes(net.row_ptr, net.cols, net.yg, net.yb,
                               net.diag, net.bus_type, net.p_sched,
                               net.q_sched, vm, va, arr.route.off,
                               arr.route.ones, *got),
                  net.cols.numel() * K1_OPS_PER_ENTRY)
    del got, ref
    ms = cuda_ms(lambda: k1.nr_fill_routed(net, arr.route, vm, va), reps=20)
    plain_ms = cuda_ms(lambda: k1.nr_fill_routed_ref(net, arr.route, vm, va),
                       reps=5)
    print(f"phase 13 {label} K1 routed: n={n}, buffer "
          f"{arr.route.size * 8 / 1e9!r} GB, max abs diff {worst_abs!r}, "
          f"max rel diff {worst_rel!r}, pattern equal; K1 routed {ms!r} ms, "
          f"plain {plain_ms!r} ms per call; bound {least[0]!r} ms by "
          f"{least[1]}")
    return worst_abs, ms, plain_ms, least


def k5_sources(route):
    """The real contributions and parts of ``route``: each block's real
    border slots squared, and once more for the right-hand side."""
    real = (route.bsel < route.nb).sum(dim=1)
    return int((real * real).sum() + real.sum())


def k5_bound(route, base=True):
    """K5's least time on ``route``: it reads each real contribution and
    part once (not the pad slots, nor its own tables: bsel alone says
    where each goes), the border block and right-hand side where the call
    has them (``base``), and writes the border system."""
    sources = k5_sources(route)
    border = 8 * (route.nb * route.nb + route.nb)
    return bound(8 * sources + tensor_bytes(route.bsel)
                 + (2 if base else 1) * border, 2 * sources)


def compare_k5(label, route, base=True, phase=13, sign=None):
    """K5 against schur_gather_ref, bit for bit against schur_gather_lists
    and against one index_put_ on random contributions of the layout's
    shapes, called as its solver calls it: sign -1 and a border base in
    the BBD NR (phase 13), sign 1 and no base in the BBD SE (phase 15,
    ``base=False``), sign -1 and no base on one block's route in the AC
    OPF's mesh mode (phase 20, ``base=False, sign=-1.0``)."""
    if sign is None:
        sign = -1.0 if base else 1.0
    k, width = route.bsel.shape
    nb = route.nb
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           device="cuda")

    contrib, parts = randn(k, width, width), randn(k, width)
    args = ((contrib, parts, randn(nb, nb), randn(nb), sign) if base
            else (contrib, parts, None, None, sign))
    got = k5.schur_gather(route, *args)
    ref = k5.schur_gather_ref(route, *args)
    lists = k5.schur_gather_lists(route, *args)
    torch.cuda.synchronize()
    worst_abs, worst_rel = rel_err(got, ref)
    check(worst_rel <= K5_REL_TOL,
          f"{label}: K5 disagrees with schur_gather_ref, rel {worst_rel:.3e}")
    note_rel("schur_gather", worst_rel)
    check(all(torch.equal(a, b) for a, b in zip(got, lists)),
          f"{label}: K5 is not bit for bit schur_gather_lists, max abs diff "
          f"{rel_err(got, lists)[0]!r}")
    sources = k5_sources(route)
    least = k5_bound(route, base)
    del got, ref, lists

    def call():
        return k5.schur_gather(route, *args)

    ms = cuda_ms(call, reps=20)
    dev_ms = queued_ms(call, reps=20)
    host = host_us(call, reps=20)
    plain_ms = cuda_ms(lambda: k5.schur_gather_ref(route, *args), reps=5)
    s_pad = contrib.new_zeros((nb + 1, nb + 1))
    index = (route.bsel[:, :, None].expand(-1, -1, width),
             route.bsel[:, None, :].expand(-1, width, -1))
    library_ms = cuda_ms(lambda: s_pad.index_put_(index, contrib,
                                                  accumulate=True), reps=20)
    check_one_launch(f"{label} K5", call)
    print(f"phase {phase} {label} K5: k={k}, L={width}, nb={nb}, "
          f"{'border base' if base else 'no base'}, sign {sign:+g}, "
          f"{'merge' if not route.by_rows else 'row'} kernel, {sources} "
          f"sources, {route.slot_blk.numel()} list entries; max abs diff "
          f"{worst_abs!r}, max rel diff {worst_rel!r}, bit for bit "
          f"schur_gather_lists; one kernel a call and no memset or memcpy "
          f"(CUDA graph nodes); K5 {ms!r} ms per call (device {dev_ms!r} ms "
          f"queued, host {host!r} us), plain {plain_ms!r} ms, index_put_ "
          f"{library_ms!r} ms per call; bound {least[0]!r} ms by {least[1]}")
    return worst_abs, ms, plain_ms, least, library_ms


def phase13():
    rng = np.random.default_rng(SEED)
    out = {}
    for label, shape in (("10k", GRID), ("25k", BBD_GRID)):
        system = synthetic_grid(*shape)
        t_build, (arr, lay) = wall_s(lambda: compile_nr_bbd(
            system, BBD_BLOCKS, "cuda"))
        print(f"phase 13 {label} BBD layout: k={lay.k}, ni={lay.ni}, "
              f"mb={lay.mb}, mbl={lay.mbl}; compile_nr_bbd {t_build!r} s")
        out[label] = (compare_k1_routed(label, arr, rng),
                      compare_k5(label, arr.schur))
        del arr
    k1r_err = max(v[0][0] for v in out.values())
    k5_err = max(v[1][0] for v in out.values())
    # the JSON line carries the 25k layout's times
    return (k1r_err, *out["25k"][0][1:]), (k5_err, *out["25k"][1][1:])


def stage_ms(split, per=None):
    """``device_stages`` totals as text, each over ``per`` (default: its
    own count)."""
    return ", ".join(f"{key} {ms / (per or count)!r} ms"
                     for key, (count, ms) in split.items())


def nr_bbd_run(label, system, reference, tol, n_blocks=None, cap=NR_CAP,
               converges=True):
    """Phase 14: the BBD NR main path on ``system`` in ``n_blocks`` blocks
    (default ``BBD_BLOCKS``; counts reset just before, read just after),
    capped at ``cap`` iterations and checked against ``reference`` (an
    analysis or oracle result with magnitude/angle, its iterations and
    whether it converged): the same count, both converged as
    ``converges`` says, and if they did, the same state."""
    torch.cuda.reset_peak_memory_stats()
    k1.nr_fill_routed.launches = 0
    k5.schur_gather.launches = 0
    t_build, analysis = wall_s(lambda: newton_raphson_bbd(
        system, n_blocks=n_blocks or BBD_BLOCKS, device="cuda"))
    start = (analysis.voltage.magnitude.copy(),
             analysis.voltage.angle.copy())
    vm0, va0 = analysis._state()
    with device_stages() as first:
        t_solve, _ = wall_s(lambda: power_flow_bbd(analysis, iteration=cap))
    launches = (k1.nr_fill_routed.launches, k5.schur_gather.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    it = analysis.method.iteration
    check(launches == (it + 1, it),
          f"{label} BBD NR: K1 routed / K5 launched {launches} times for "
          f"{it} iterations")
    if hasattr(reference, "iterations"):
        ref_it, ref_conv = reference.iterations, reference.converged
        ref_vm, ref_va = reference.magnitude, reference.angle
    else:
        ref_it, ref_conv = (reference.method.iteration,
                            reference.method.converged)
        ref_vm, ref_va = reference.voltage.magnitude, reference.voltage.angle
    conv = analysis.method.converged
    check(conv == ref_conv == converges and it == ref_it,
          f"{label} BBD NR: {it} iterations (converged {conv}), reference "
          f"{ref_it} ({ref_conv})")
    dvm = float(np.abs(analysis.voltage.magnitude - ref_vm).max())
    dva = wrapped_max(analysis.voltage.angle, ref_va)
    check(not converges or (dvm <= tol and dva <= tol),
          f"{label} BBD NR: |dvm| {dvm:.3e}, |dva| {dva:.3e} over {tol}")
    # the same solve again from the same start, with the card warmed up
    analysis.voltage.magnitude, analysis.voltage.angle = start
    with device_stages() as split:
        t_again, _ = wall_s(lambda: power_flow_bbd(analysis, iteration=cap))
    check(analysis.method.iteration == it,
          f"{label} BBD NR: {analysis.method.iteration} iterations again")
    lay = analysis._bbd_layout
    # the interior LU as PyTorch batches it (MAGMA's batched getrf), against
    # the port's one cuSOLVER getrf per block, on the first Jacobian
    a_ii = _blocks(k1.nr_fill_routed(analysis.arrays.net,
                                     analysis.arrays.route, vm0, va0).buf,
                   lay)[0]
    batched_ms, _ = event_ms(lambda: torch.linalg.lu_factor(a_ii))
    blocks_ms, _ = event_ms(lambda: linalg.lu_factor_blocks(a_ii))
    del a_ii
    print(f"phase 14 {label} BBD NR main path: n={system.bus.number}, k="
          f"{lay.k}, ni={lay.ni}, mb={lay.mb}, mbl={lay.mbl}; {it} "
          f"iterations (reference {ref_it}), converged {conv}, max mismatch "
          f"{analysis.method.max_mismatch_active!r} / "
          f"{analysis.method.max_mismatch_reactive!r}, max |dvm| {dvm!r}, "
          f"max |dva| {dva!r}, K1 routed / K5 launches {launches}; wall: "
          f"newton_raphson_bbd {t_build!r} s, power_flow_bbd {t_solve!r} s"
          f" ({t_again!r} s again); peak device memory {peak_gb!r} GB")
    print(f"phase 14 {label} BBD NR per iteration (CUDA events between the "
          f"marks of power_flow_bbd, {it} steps, {it + 1} fills), solved "
          f"again: {stage_ms(split)}; first solve: {stage_ms(first)}; "
          f"interior LU once more: batched lu_factor {batched_ms!r} ms, per "
          f"block {blocks_ms!r} ms")
    return analysis, launches


def fdpf_bbd_run(label, system, bx, cap, converges):
    """Phase 14: the BBD fast decoupled path against oracle_fdpf, both
    capped at ``cap`` iterations: the same count, the same convergence
    (``converges``) and the same state."""
    name = f"{label} FDPF-BBD {'BX' if bx else 'XB'}"
    k1.nr_fill.launches = 0
    t_build, analysis = wall_s(lambda: fast_newton_raphson_bbd(
        system, bx=bx, n_blocks=BBD_BLOCKS, device="cuda"))
    t_solve, _ = wall_s(lambda: power_flow_fnr_bbd(analysis,
                                                   iteration=cap))
    launches = k1.nr_fill.launches
    it = analysis.method.iteration
    oracle = oracle_fdpf(system, bx=bx, iteration=cap)
    check(launches == 2 * it + 1,
          f"{name}: K1 launched {launches} times for {it} iterations")
    check(analysis.method.converged == oracle.converged == converges
          and it == oracle.iterations,
          f"{name}: {it} iterations (converged "
          f"{analysis.method.converged}), oracle {oracle.iterations} "
          f"({oracle.converged})")
    dvm = float(np.abs(analysis.voltage.magnitude - oracle.magnitude).max())
    dva = wrapped_max(analysis.voltage.angle, oracle.angle)
    check(dvm <= GRID_STATE_TOL and dva <= GRID_STATE_TOL,
          f"{name}: |dvm| {dvm:.3e}, |dva| {dva:.3e}")
    print(f"phase 14 {name}: {it} iterations (oracle {oracle.iterations}),"
          f" converged {analysis.method.converged}, max mismatch "
          f"{analysis.method.max_mismatch_active!r} / "
          f"{analysis.method.max_mismatch_reactive!r} (oracle "
          f"{oracle.max_mismatch_active!r} / "
          f"{oracle.max_mismatch_reactive!r}), max |dvm| {dvm!r}, max |dva| "
          f"{dva!r}; wall: construction "
          f"(partition, blocks, two BBD factorizations) {t_build!r} s, "
          f"power_flow_fnr_bbd {t_solve!r} s")


def phase14(dense_10k):
    """The BBD power flows; returns the 10k and 25k NR analyses and the
    K1 routed / K5 launches of their main paths."""
    system = synthetic_grid(*GRID)
    nr_10k, launches = nr_bbd_run("10k", system, dense_10k, BBD_DENSE_TOL)
    for bx in (True, False):
        fdpf_bbd_run("10k", system, bx, FDPF_CAP, True)
    t_system, system = wall_s(lambda: synthetic_grid(*BBD_GRID))
    t_oracle, oracle = wall_s(lambda: oracle_nr(system))
    print(f"phase 14 25k grid: n={system.bus.number}, "
          f"{system.branch.number} branches; power_system {t_system!r} s; "
          f"oracle_nr {oracle.iterations} iterations in {t_oracle!r} s")
    nr_25k, counts = nr_bbd_run("25k", system, oracle, GRID_STATE_TOL)
    launches = [a + b for a, b in zip(launches, counts)]
    for bx in (True, False):
        fdpf_bbd_run("25k", system, bx, FDPF_25K_STEPS, False)
    return (nr_10k, nr_25k), launches


def compare_k3_routed(label, sb, lay, vm, va):
    """Phase 15: K3's routed mode against se_fill_routed_ref at the state
    ``vm``/``va``, all blocks in one launch."""
    arr, route = sb.base, sb.route
    scale = arr.w.sqrt()
    got = k3.se_fill_routed(arr, sb.net, route, vm, va, scale)
    ref = k3.se_fill_routed_ref(arr, sb.net, route, vm, va, scale)
    torch.cuda.synchronize()
    worst_abs, worst_rel = rel_err(got, ref)
    check(worst_rel <= K3_REL_TOL,
          f"{label}: K3 routed disagrees with its plain version, rel "
          f"{worst_rel:.3e}")
    note_rel("se_fill_routed", worst_rel)
    check(torch.equal(got.jac != 0, ref.jac != 0),
          f"{label}: K3 routed pattern differs from its plain version")
    net = sb.net
    least = bound(tensor_bytes(arr.desc.idx, arr.desc.coef, arr.status,
                               arr.mean, net.row_ptr, net.cols, net.yg,
                               net.yb, net.diag, route.row_block,
                               route.row_slot, route.colmap, scale, vm, va,
                               *got),
                  arr.mean.numel() * K3_OPS_PER_ROW)
    gb = got.jac.numel() * 8 / 1e9
    del got, ref

    def call():
        return k3.se_fill_routed(arr, sb.net, route, vm, va, scale)

    ms = cuda_ms(call, reps=10)
    dev_ms = queued_ms(call, reps=10)
    host = host_us(call, reps=10)
    plain_ms = cuda_ms(lambda: k3.se_fill_routed_ref(arr, sb.net, route, vm,
                                                     va, scale), reps=3)
    check_one_launch(f"{label} K3 routed", call)
    print(f"phase 15 {label} K3 routed: m={arr.mean.numel()}, k={lay.k}, "
          f"mr={lay.mr}, width {2 * lay.ni + 2 * lay.lb}, H {gb!r} GB; max "
          f"abs diff {worst_abs!r}, max rel diff {worst_rel!r}, pattern "
          f"equal; one kernel a call and no memset or memcpy (CUDA graph "
          f"nodes); K3 routed {ms!r} ms per call (device {dev_ms!r} ms "
          f"queued, host {host!r} us), plain {plain_ms!r} ms per call; bound "
          f"{least[0]!r} ms by {least[1]}")
    return worst_abs, ms, plain_ms, least


def se_bbd_run(label, mon, n_blocks, reference, tol, start=None):
    """Phase 15: the BBD SE main path (counts reset just before, read just
    after) from the case's stored voltages or from ``start`` (magnitude,
    angle), checked against ``reference`` (magnitude, angle, iterations or
    None)."""
    torch.cuda.reset_peak_memory_stats()
    t_build, se = wall_s(lambda: gauss_newton_bbd(mon, n_blocks=n_blocks,
                                                  device="cuda"))
    if start is not None:
        se.voltage.magnitude, se.voltage.angle = start
    start = se.voltage.magnitude.copy(), se.voltage.angle.copy()
    vm0, va0 = se._state()
    k3.se_fill_routed.launches = 0
    k5.schur_gather.launches = 0
    with device_stages() as first:
        t_solve, _ = wall_s(lambda: se_bbd_solve(se))
    launches = (k3.se_fill_routed.launches, k5.schur_gather.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    it = se.method.iteration
    lay = se._bbd_layout
    chunks = -(-lay.k // _block_chunk(lay, vm0.device))
    check(launches == (chunks * (it + 1), it + 1),
          f"{label} BBD SE: K3 routed / K5 launched {launches} times for "
          f"{it} iterations")
    vm, va, ref_it = reference
    check(ref_it is None or it == ref_it,
          f"{label} BBD SE: {it} iterations, reference {ref_it}")
    dvm, dva = check_se_state(f"{label} BBD SE", se, vm, va, tol)
    # the same estimate again from the same start, with the card warmed up
    se.voltage.magnitude, se.voltage.angle = start
    with device_stages() as split:
        t_again, _ = wall_s(lambda: se_bbd_solve(se))
    check(se.method.iteration == it,
          f"{label} BBD SE: {se.method.iteration} iterations again")
    print(f"phase 15 {label} BBD SE main path: n={se.system.bus.number}, "
          f"m={se.arrays.mean.numel()}, k={lay.k}, ni={lay.ni}, mb={lay.mb}"
          f", mr={lay.mr}, lb={lay.lb}, {chunks} chunk(s); {it} iterations "
          f"(reference {ref_it}), max |dvm| {dvm!r}, max |dva| {dva!r}, K3 "
          f"routed / K5 launches {launches}; wall: gauss_newton_bbd "
          f"{t_build!r} s, se_bbd_solve {t_solve!r} s ({t_again!r} s "
          f"again); peak device memory {peak_gb!r} GB")
    print(f"phase 15 {label} BBD SE per increment (CUDA events between the "
          f"marks of se_bbd_solve, {it + 1} increments), solved again: "
          f"{stage_ms(split, it + 1)}; first solve: {stage_ms(first, it + 1)}")
    return se, launches


def perturbed(system, vm, va, rng):
    """``(vm, va)`` with noise on the PQ magnitudes (0.01) and the
    non-slack angles (0.02 rad)."""
    n = system.bus.number
    is_pq = system.bus.layout.type.array[:n] == 1
    moved = np.arange(n) != system.bus.layout.slack
    return (vm + np.where(is_pq, 0.01 * rng.standard_normal(n), 0.0),
            va + np.where(moved, 0.02 * rng.standard_normal(n), 0.0))


def zero_noise_run(label, nr, rng):
    """Phase 15: the BBD SE of the zero-noise voltmeter, wattmeter and
    varmeter set of the BBD power flow ``nr`` gives its state back. The
    estimator starts from the last estimate, here the power-flow state
    perturbed: from the flat start Gauss-Newton does not converge on these
    lattices (the 25k one's angles span 11.7 rad), in the port as in
    ``oracle_wls_se`` (PERF.md, section 6)."""
    t_post, _ = wall_s(lambda: (ac_post.power(nr), ac_post.current(nr)))
    mon = measurement(nr.system)
    t_set, _ = wall_s(lambda: (
        add_voltmeter(mon, analysis=nr, noise=False),
        add_wattmeter(mon, analysis=nr, noise=False),
        add_varmeter(mon, analysis=nr, noise=False)))
    print(f"phase 15 {label} zero-noise set: {mon.voltmeter.number} "
          f"voltmeters, {mon.wattmeter.number} wattmeters, "
          f"{mon.varmeter.number} varmeters; post-processing {t_post!r} s, "
          f"measurement set {t_set!r} s")
    vm, va = nr.voltage.magnitude, nr.voltage.angle
    return se_bbd_run(label, mon, BBD_BLOCKS, (vm, va, None), GRID_STATE_TOL,
                      perturbed(nr.system, vm, va, rng))


def phase15(nr_bbd):
    rng = np.random.default_rng(SEED)
    # the 1,369-bus set of phase 6 (no correlated pairs) against the dense
    # estimate
    label = f"{SE_GRID[0]}x{SE_GRID[1]}"
    system = synthetic_grid(*SE_GRID)
    mon, _ = scada_pmu(system)
    dense = gauss_newton(mon, device="cuda")
    state_estimation(dense)
    se, launches = se_bbd_run(
        label, mon, SE_BBD_BLOCKS,
        (dense.voltage.magnitude, dense.voltage.angle,
         dense.method.iteration), BBD_DENSE_TOL)
    k5_err = compare_k5(f"{label} BBD SE", se._bbd.schur, base=False,
                        phase=15)[0]
    k3r = compare_k3_routed(label, se._bbd, se._bbd_layout, *se._state())
    # the gain stage over chunks of blocks, as where the card's memory asks
    # for it, gives the increment of one pass
    vm, va = (torch.tensor(x, device="cuda") for x in perturbed(
        system, se.voltage.magnitude, se.voltage.angle, rng))
    whole, _ = _gn_increment_bbd(se._bbd, se._bbd_layout, vm, va)
    chunked, _ = _gn_increment_bbd(se._bbd, se._bbd_layout, vm, va, chunk=3)
    diff = (whole - chunked).abs().max().item()
    check(diff <= TWIN_STATE_TOL * max(1.0, whole.abs().max().item()),
          f"{label} BBD SE: the increment in chunks of 3 blocks is {diff:.3e}"
          f" from one pass")
    print(f"phase 15 {label} BBD SE increment in chunks of 3 blocks vs one "
          f"pass: max abs diff {diff!r}")
    del se

    # the zero-noise sets from the phase-14 BBD NR solutions
    for label, nr in zip(("10k", "25k"), nr_bbd):
        se, counts = zero_noise_run(label, nr, rng)
        k5_err = max(k5_err, compare_k5(f"{label} BBD SE", se._bbd.schur,
                                        base=False, phase=15)[0])
        launches = [a + b for a, b in zip(launches, counts)]
        if label == "25k":
            vm, va = (torch.tensor(x, device="cuda") for x in perturbed(
                nr.system, se.voltage.magnitude, se.voltage.angle, rng))
            k3r_25k = compare_k3_routed(label, se._bbd, se._bbd_layout, vm,
                                        va)
        del se
    err = max(k3r[0], k3r_25k[0])
    return (err, *k3r_25k[1:]), launches, k5_err


# --------------------------------------------------------------------------
# Interior point: DC optimal power flow and LAV state estimation (phase 16)
# --------------------------------------------------------------------------

def opf_solve(system, device, stages=False):
    """``dc_optimal_power_flow`` -> ``power_flow(power=True)`` on
    ``device``: the analysis, its wall (s) and, with ``stages``, the
    card's time by ``ipm``'s stages (``device_stages``) and the peak
    device memory (bytes)."""
    analysis = dc_optimal_power_flow(system, device=device)
    if device == "cpu":
        t0 = time.perf_counter()
        power_flow(analysis, power=True)
        return analysis, time.perf_counter() - t0, None, None
    torch.cuda.reset_peak_memory_stats()
    if stages:
        with device_stages() as split:
            wall, _ = wall_s(lambda: power_flow(analysis, power=True))
    else:
        split = None
        wall, _ = wall_s(lambda: power_flow(analysis, power=True))
    return analysis, wall, split, torch.cuda.max_memory_allocated()


def opf_line(label, analysis, wall):
    res = analysis.method.result
    return (f"{label}: status {res.status}, {res.iterations} iterations, "
            f"objective {res.objective!r}, KKT error {res.kkt_error!r}, "
            f"power_flow(power=True) {wall!r} s")


def linear_costs(system, seed=11):
    """Every generator's cost replaced by a distinct linear curve (the
    anchor of tests/test_opf_anchor.py), so the DC OPF is an LP."""
    rng = np.random.default_rng(seed)
    g = system.generator.number
    c1 = 20.0 + 30.0 * rng.random(g)
    for i in range(g):
        cost(system, system.generator.label.label(i), active=2,
             polynomial=[float(c1[i]), 5.0])
    return c1


def dc_network(system):
    """The DC network from raw branch data (reactance, tap, shift), apart
    from the port's model: in-service branch ends, admittances, shifts,
    the branch-bus incidence ``a`` (+1 at the from bus) and the flows'
    constant part."""
    from scipy import sparse
    n, br = system.bus.number, system.branch
    m = br.number
    on = np.flatnonzero(br.layout.status.array[:m] == 1)
    f = br.layout.from_bus.array[:m][on]
    t = br.layout.to_bus.array[:m][on]
    tau = br.parameter.turns_ratio.array[:m][on].copy()
    tau[tau == 0.0] = 1.0
    adm = 1.0 / (br.parameter.reactance.array[:m][on] * tau)
    phi = br.parameter.shift_angle.array[:m][on]
    k = len(on)
    a = sparse.csr_matrix((np.r_[np.ones(k), -np.ones(k)],
                           (np.r_[np.arange(k), np.arange(k)], np.r_[f, t])),
                          shape=(k, n))
    return on, f, t, adm, phi, a


def dc_limits(system, on):
    """The limited branch flows and angle differences of the DC OPF model:
    a branch's flow rows when a bound is nonzero and finite, its angle rows
    when a bound is meaningful (not 0 or ±2π)."""
    br = system.branch
    m = br.number
    lo, hi = br.flow.min_from_bus.array[:m][on], br.flow.max_from_bus.array[
        :m][on]
    flow = ((lo != 0) & np.isfinite(lo)) | ((hi != 0) & np.isfinite(hi))
    alo = br.voltage.min_diff_angle.array[:m][on]
    ahi = br.voltage.max_diff_angle.array[:m][on]
    two_pi = 2 * np.pi
    ang = ((np.isfinite(alo) & (alo != 0) & (alo != -two_pi))
           | (np.isfinite(ahi) & (ahi != 0) & (ahi != two_pi)))
    return flow, lo, hi, ang, alo, ahi


def independent_dc_lp(system, c1):
    """The DC OPF LP with every flow and angle limit, assembled from raw
    system data in scipy sparse matrices and solved by HiGHS."""
    from scipy import sparse
    from scipy.optimize import linprog
    n, bus, gen = system.bus.number, system.bus, system.generator
    g = gen.number
    on_g = np.flatnonzero(gen.layout.status.array[:g] == 1)
    on, f, t, adm, phi, a = dc_network(system)
    flow, lo, hi, ang, alo, ahi = dc_limits(system, on)
    da = sparse.diags(adm) @ a                 # branch flows: da θ - adm φ
    ag = sparse.csr_matrix((-np.ones(len(on_g)),
                            (gen.layout.bus.array[:g][on_g],
                             np.arange(len(on_g)))), shape=(n, len(on_g)))
    # balance: Aᵀ (da θ - adm φ) - Σ pg = -pd - gsh
    a_eq = sparse.hstack([a.T @ da, ag]).tocsr()
    b_eq = (-bus.demand.active.array[:n] - bus.shunt.conductance.array[:n]
            + a.T @ (adm * phi))
    # flow rows: lo <= da θ - adm φ <= hi; angle rows: lo <= a θ <= hi
    rows, rhs = [], []
    for sel, mat, off, low, high in ((flow, da, adm * phi, lo, hi),
                                     (ang, a, np.zeros_like(phi), alo, ahi)):
        for sign, bnd in ((1.0, high), (-1.0, low)):
            keep = sel & np.isfinite(bnd)
            rows.append(sign * mat[keep])
            rhs.append(sign * (bnd[keep] + off[keep]))
    a_th = sparse.vstack(rows)
    a_ub = sparse.hstack([a_th, sparse.csr_matrix(
        (a_th.shape[0], len(on_g)))]).tocsr()
    b_ub = np.concatenate(rhs)
    slack = bus.layout.slack
    bounds = [(None, None)] * n
    bounds[slack] = (float(bus.voltage.angle[slack]),) * 2
    for i in on_g:
        low, high = gen.capability.min_active[i], gen.capability.max_active[i]
        bounds.append((float(low) if np.isfinite(low) else None,
                       float(high) if np.isfinite(high) else None))
    c = np.r_[np.zeros(n), c1[on_g]]
    t0 = time.perf_counter()
    res = linprog(c, A_ub=a_ub, b_ub=b_ub, A_eq=a_eq, b_eq=b_eq,
                  bounds=bounds, method="highs")
    check(res.status == 0, f"HiGHS: {res.message}")
    pg = np.zeros(g)
    pg[on_g] = res.x[n:]
    return res.fun + 5.0 * len(on_g), pg, time.perf_counter() - t0


def dc_feasibility(system, theta, pg):
    """Worst bus-balance residual (p.u.) and worst capability, flow and
    angle-limit violations of a DC dispatch, from raw system data."""
    n, bus, gen = system.bus.number, system.bus, system.generator
    g = gen.number
    on, f, t, adm, phi, a = dc_network(system)
    flow, lo, hi, ang, alo, ahi = dc_limits(system, on)
    pf = adm * (a @ theta - phi)
    supply = np.bincount(gen.layout.bus.array[:g], weights=pg, minlength=n)
    balance = supply - bus.demand.active.array[:n] \
        - bus.shunt.conductance.array[:n] - a.T @ pf
    on_g = gen.layout.status.array[:g] == 1
    cap = np.maximum(gen.capability.min_active.array[:g] - pg,
                     pg - gen.capability.max_active.array[:g])[on_g]
    dth = a @ theta

    def over(val, low, high, sel):
        low = np.where(np.isfinite(low), low, -np.inf)[sel]
        high = np.where(np.isfinite(high), high, np.inf)[sel]
        worst = np.maximum(low - val[sel], val[sel] - high)
        return float(worst.max()) if worst.size else -np.inf

    return (float(np.abs(balance).max()), float(cap.max()),
            over(pf, lo, hi, flow), over(dth, alo, ahi, ang),
            int(flow.sum()), int(ang.sum()))


def opf_small():
    """case14test/30test card vs CPU; the case118 LP anchor vs HiGHS."""
    for case in ("case14test", "case30test"):
        card, wall, _, _ = opf_solve(case_system(case), "cuda")
        cpu, _, _, _ = opf_solve(case_system(case), "cpu")
        dva = float(np.abs(card.voltage.angle - cpu.voltage.angle).max())
        dpg = float(np.abs(card.power.generator.active
                           - cpu.power.generator.active).max())
        check(card.method.converged and cpu.method.converged
              and dva <= OPF_SMALL_TOL and dpg <= OPF_SMALL_TOL,
              f"{case} DC OPF: card vs CPU |d theta| {dva:.3e}, |d pg| "
              f"{dpg:.3e}, converged {card.method.converged}/"
              f"{cpu.method.converged}")
        print(f"phase 16 {opf_line(case + ' DC OPF', card, wall)}; "
              f"CPU {cpu.method.iteration} iterations; card vs CPU "
              f"|d theta| {dva!r}, |d pg| {dpg!r}")
    system = case_system("case118")
    c1 = linear_costs(system)
    want, pg_lp, t_lp = independent_dc_lp(system, c1)
    card, wall, split, _ = opf_solve(system, "cuda", stages=True)
    it = card.method.iteration
    dobj = abs(card.method.objective - want) / abs(want)
    dpg = float(np.abs(card.power.generator.active - pg_lp).max())
    check(card.method.converged and dobj <= LP_OBJ_RTOL
          and dpg <= LP_PG_ATOL_118,
          f"case118 LP: objective rel {dobj:.3e}, |d pg| {dpg:.3e}")
    print(f"phase 16 {opf_line('case118 LP (anchor costs)', card, wall)}; "
          f"vs HiGHS ({t_lp!r} s) objective rel {dobj!r}, |d pg| {dpg!r}; "
          f"per iteration (CUDA events): {stage_ms(split, it)}")


def opf_10k():
    """ACTIVSg10k at full width: (a) the anchor's linear costs against
    HiGHS with every flow limit; (b) the case's own costs, with the
    feasibility of the dispatch checked from raw data."""
    system = power_system(str(DATA / OPF_10K))
    c1 = linear_costs(system)
    want, pg_lp, t_lp = independent_dc_lp(system, c1)
    card, wall, split, peak = opf_solve(system, "cuda", stages=True)
    res = card.method.result
    dobj = abs(card.method.objective - want) / abs(want)
    dpg = float(np.abs(card.power.generator.active - pg_lp).max())
    obj_tol = LP_OBJ_RTOL if res.status == "optimal" else LP_OBJ_RTOL_LOOSE
    check(res.status in ("optimal", "acceptable") and dobj <= obj_tol
          and dpg <= LP_PG_ATOL_10K,
          f"{OPF_10K} LP: status {res.status}, objective rel {dobj:.3e} "
          f"(tol {obj_tol}), |d pg| {dpg:.3e}")
    print(f"phase 16 {opf_line(OPF_10K + ' LP (anchor costs)', card, wall)};"
          f" vs HiGHS ({t_lp!r} s) objective rel {dobj!r}, |d pg| {dpg!r};"
          f" peak {peak / 1e9!r} GB; per iteration (CUDA events): "
          f"{stage_ms(split, res.iterations)}")

    system = power_system(str(DATA / OPF_10K))
    card, wall, split, peak = opf_solve(system, "cuda", stages=True)
    res = card.method.result
    spec = card._spec
    bal, cap, flow, ang, n_flow, n_ang = dc_feasibility(
        system, card.voltage.angle, card.power.generator.active)
    check(res.status in ("optimal", "acceptable") and bal <= FEAS_BALANCE_TOL
          and max(cap, flow, ang) <= FEAS_LIMIT_TOL,
          f"{OPF_10K} DC OPF: status {res.status}, balance {bal:.3e}, "
          f"limits {cap:.3e} / {flow:.3e} / {ang:.3e}")
    print(f"phase 16 {opf_line(OPF_10K + ' DC OPF (own costs)', card, wall)}"
          f"; n_x {spec.n_x}, {len(spec.ineq_tags)} inequality rows "
          f"({n_flow} limited flows, {n_ang} angle limits); worst balance "
          f"{bal!r} p.u., capability {cap!r}, flow {flow!r}, angle {ang!r}; "
          f"peak {peak / 1e9!r} GB; per iteration (CUDA events): "
          f"{stage_ms(split, res.iterations)}")
    return card


def opf_pegase():
    """case1354pegase with its own costs, card against the CPU run: every
    generator has the same linear cost, so every balanced dispatch inside
    the limits is optimal and the dispatch is not unique: both runs are
    held to the objective and to feasibility from raw data. With the
    anchor's distinct linear costs the dispatch is unique: the card's
    against HiGHS."""
    system = power_system(str(DATA / OPF_PEGASE))
    card, wall, split, peak = opf_solve(system, "cuda", stages=True)
    cpu_system = power_system(str(DATA / OPF_PEGASE))
    cpu, t_cpu, _, _ = opf_solve(cpu_system, "cpu")
    res, spec = card.method.result, card._spec
    on = spec.gen_on
    one_cost = not spec.obj_quad[on].any() \
        and np.unique(spec.obj_lin[on]).size == 1
    dobj = abs(card.method.objective - cpu.method.objective) / abs(
        cpu.method.objective)
    dpg = float(np.abs(card.power.generator.active
                       - cpu.power.generator.active).max())
    worst = [dc_feasibility(s, a.voltage.angle, a.power.generator.active)
             for s, a in ((system, card), (cpu_system, cpu))]
    feasible = all(bal <= FEAS_BALANCE_TOL and max(cap, flow, ang)
                   <= FEAS_LIMIT_TOL for bal, cap, flow, ang, _, _ in worst)
    check(res.status in ("optimal", "acceptable")
          and res.status == cpu.method.result.status
          and dobj <= PEGASE_OBJ_RTOL and feasible
          and (one_cost or dpg <= PEGASE_PG_TOL),
          f"{OPF_PEGASE}: status {res.status}/{cpu.method.result.status}, "
          f"objective rel {dobj:.3e}, |d pg| {dpg:.3e}, feasibility "
          f"{worst}")
    print(f"phase 16 {opf_line(OPF_PEGASE + ' DC OPF', card, wall)}; CPU "
          f"{cpu.method.iteration} iterations in {t_cpu!r} s; card vs CPU "
          f"objective rel {dobj!r}; one cost for all "
          f"{int(on.sum())} generators: {one_cost}, so the dispatch is not "
          f"unique (card vs CPU |d pg| {dpg!r}); worst balance, capability,"
          f" flow: card {worst[0][:3]}, CPU {worst[1][:3]}; peak "
          f"{peak / 1e9!r} GB; per iteration (CUDA events): "
          f"{stage_ms(split, res.iterations)}")

    system = power_system(str(DATA / OPF_PEGASE))
    c1 = linear_costs(system)
    want, pg_lp, t_lp = independent_dc_lp(system, c1)
    card, wall, split, _ = opf_solve(system, "cuda", stages=True)
    res = card.method.result
    dobj = abs(card.method.objective - want) / abs(want)
    dpg = float(np.abs(card.power.generator.active - pg_lp).max())
    check(res.status in ("optimal", "acceptable") and dobj <= PEGASE_OBJ_RTOL
          and dpg <= PEGASE_PG_TOL,
          f"{OPF_PEGASE} LP: status {res.status}, objective rel {dobj:.3e},"
          f" |d pg| {dpg:.3e}")
    print(f"phase 16 {opf_line(OPF_PEGASE + ' LP (anchor costs)', card, wall)}"
          f"; vs HiGHS ({t_lp!r} s) objective rel {dobj!r}, |d pg| {dpg!r}; "
          f"per iteration (CUDA events): {stage_ms(split, res.iterations)}")


def lav_runs():
    """DC, PMU and AC LAV reproduce the case14test power flow on the card;
    config 4's case118 AC LAV on the card against the CPU run. Returns
    K3's launches on the card."""
    launches = 0
    system, pf = solved_case("case14test")
    dpf = dc_power_flow(system, device="cuda")
    power_flow(dpf, power=True)
    dmon = measurement(system)
    add_wattmeter(dmon, analysis=dpf)
    pmon = measurement(system)
    add_pmu(pmon, analysis=pf)
    amon = measurement(system)
    for add in (add_voltmeter, add_wattmeter, add_varmeter):
        add(amon, analysis=pf)
    for kind, build, mon, ref, tol in (
            ("DC", dc_lav_state_estimation, dmon, dpf, LAV_DC_TOL),
            ("PMU", pmu_lav_state_estimation, pmon, pf, LAV_PMU_TOL),
            ("AC", ac_lav_state_estimation, amon, pf, LAV_AC_TOL)):
        se = build(mon, device="cuda")
        k3.se_fill.launches = 0
        wall, _ = wall_s(lambda: state_estimation(se, iteration=200))
        launches += k3.se_fill.launches
        dva = float(np.abs(se.voltage.angle - ref.voltage.angle).max())
        dvm = 0.0 if kind == "DC" else float(np.abs(
            se.voltage.magnitude - ref.voltage.magnitude).max())
        check(se.method.converged and max(dva, dvm) <= tol,
              f"case14test {kind} LAV: converged {se.method.converged}, "
              f"|d theta| {dva:.3e}, |d V| {dvm:.3e} over {tol}")
        print(f"phase 16 case14test {kind} LAV vs the power flow: "
              f"{se.method.iteration} iterations, |d theta| {dva!r}, |d V| "
              f"{dvm!r}; state_estimation {wall!r} s, K3 launches "
              f"{k3.se_fill.launches}")

    def config4(device):
        system = case_system("case118")
        mon, _ = scada_pmu(system)
        planted(mon, CONFIG4_PLANTED)
        return ac_lav_state_estimation(mon, device=device)

    card, cpu = config4("cuda"), config4("cpu")
    k3.se_fill.launches = 0
    with device_stages() as split:
        wall, _ = wall_s(lambda: state_estimation(card, iteration=200))
    n_k3 = k3.se_fill.launches
    launches += n_k3
    t0 = time.perf_counter()
    state_estimation(cpu, iteration=200)
    t_cpu = time.perf_counter() - t0
    dstate = max(float(np.abs(card.voltage.magnitude
                              - cpu.voltage.magnitude).max()),
                 float(np.abs(card.voltage.angle - cpu.voltage.angle).max()))
    it = card.method.iteration
    check(card.method.converged and cpu.method.converged and n_k3 > 0
          and it == cpu.method.iteration and dstate <= LAV_CARD_CPU_TOL,
          f"config 4 AC LAV: converged {card.method.converged}/"
          f"{cpu.method.converged}, iterations {it}/{cpu.method.iteration},"
          f" card vs CPU {dstate:.3e}, K3 launches {n_k3}")
    print(f"phase 16 config 4 AC LAV (case118, wattmeters 3 and 40 "
          f"planted): converged, {it} iterations on card and CPU, card vs "
          f"CPU state {dstate!r}; state_estimation {wall!r} s (CPU "
          f"{t_cpu!r} s), K3 launches {n_k3}; per iteration (CUDA events): "
          f"{stage_ms(split, it)}")
    return launches


def phase16():
    """The interior point's DC OPF and LAV cells. Returns the K3 launches
    of the LAV runs and the ACTIVSg10k own-cost DC OPF."""
    opf_small()
    dc_10k = opf_10k()
    opf_pegase()
    return lav_runs(), dc_10k


# ---- phase 17: the AC optimal power flow and K6 ---------------------------

def with_flow_class(system, cls):
    """Every branch's flow limit read as class ``cls`` (1 P, 2 |S|, 3
    |S|², 4 |I|, 5 |I|²)."""
    for k in range(system.branch.number):
        update_branch(system, system.branch.label.label(k), type=cls)
    return system


def k6_points(spec, x0, rng, count=2):
    """``count`` random points around ``x0`` with random duals, and the
    flat start (θ = 0, V = 1), where the current and power of every
    shunt-free line are 0 exactly: its √ rows sit below the clamp."""
    n = spec.n
    points = []
    for _ in range(count + 1):
        x = np.array(x0, dtype=np.float64)
        if len(points) < count:
            x[:n] += 0.1 * rng.standard_normal(n)
            x[n:2 * n] *= 1.0 + 0.05 * rng.standard_normal(n)
            x[2 * n:] += 0.1 * rng.standard_normal(x.size - 2 * n)
        else:
            x[:n], x[n:2 * n] = 0.0, 1.0
        points.append((x, rng.standard_normal(spec.m_e),
                       rng.standard_normal(spec.m_i)))
    return points


def k6_zero_rows(spec, x):
    """Flow rows of a √ class (2, 4) whose S² or I² is below the clamp at
    ``x``."""
    from juliagrid_tpu_torch.opf.acopf import flow_values
    arr = spec.arrays
    if not arr.fl_fb.numel():
        return 0
    n = spec.n
    xt = torch.as_tensor(x, device=arr.rows.device)
    sq = arr._replace(fl_cls=torch.where(arr.fl_cls == 2, 3, torch.where(
        arr.fl_cls == 4, 5, arr.fl_cls)))
    val = flow_values(sq, xt[:n], xt[n:2 * n])
    root = (arr.fl_cls == 2) | (arr.fl_cls == 4)
    return int(((val < 1e-24) & root).sum())


def compare_k6(label, arr, points):
    """K6 against opf_fill_ref at each (x, y, z): both Jacobians and the
    Hessian. Returns the worst abs, row-relative (checked) and
    entry-relative differences."""
    worst_abs = worst_rel = worst_entry = 0.0
    where = ""
    for x, y, z in points:
        dev = arr.rows.device
        xt, yt, zt = (torch.as_tensor(a, device=dev) for a in (x, y, z))
        got, ref = k6.opf_fill(arr, xt), k6.opf_fill_ref(arr, xt)
        pairs = [("J_E", got.jac_eq, ref.jac_eq),
                 ("J_I", got.jac_ineq, ref.jac_ineq),
                 ("H", k6.opf_fill(arr, xt, yt, zt).hess,
                  k6.opf_fill_ref(arr, xt, yt, zt).hess)]
        for name, a, b in pairs:
            if not b.numel():
                continue
            diff = (a - b).abs()
            worst_abs = max(worst_abs, diff.max().item())
            worst_entry = max(worst_entry,
                              (diff / b.abs().clamp(min=1.0)).max().item())
            rel = diff / b.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
            k = int(rel.argmax())
            if rel.view(-1)[k].item() > worst_rel:
                worst_rel = rel.view(-1)[k].item()
                where = (f"{name}[{k // b.shape[1]}, {k % b.shape[1]}]: "
                         f"{a.view(-1)[k].item()!r} against "
                         f"{b.view(-1)[k].item()!r}")
        del got, ref, pairs
    torch.cuda.synchronize()
    check(worst_rel <= K6_REL_TOL,
          f"{label}: K6 disagrees with opf_fill_ref, rel {worst_rel:.3e} of "
          f"the row at {where}")
    note_rel("opf_fill", worst_rel)
    return worst_abs, worst_rel, worst_entry


def k6_bound(arr, x, outputs, duals=()):
    """K6's least time: its tables, the Y-bus values, the point (and the
    duals) read once, the outputs written once; the operations (a few tens
    a Y-bus entry, ~700 a flow row's Hessian) are far below the bytes."""
    nbytes = tensor_bytes(*(t for t in arr.fill if torch.is_tensor(t)),
                          arr.yg, arr.yb, x, *duals, *outputs)
    ops = K6_OPS_PER_ENTRY * 2 * arr.rows.numel() \
        + K6_OPS_PER_FLOW * 2 * arr.fl_fb.numel()
    return bound(nbytes, ops)


def k6_times(label, arr, x, y, z):
    """K6 at the main path's point: ms of each mode (CUDA events), its
    device time alone and host µs, the memset-and-fill split, a bare
    ``zero_()`` of the same output (the card's practical store floor), the
    plain version, one kernel node a call, the bounds, and what the build
    gave each mode's kernel (registers and local bytes a thread, resident
    blocks an SM). Returns (ms, plain_ms, (bound_ms, bound_by)) of the pair
    an iteration takes (one Jacobian and one Hessian launch)."""
    jac = lambda: k6.opf_fill(arr, x)  # noqa: E731
    hes = lambda: k6.opf_fill(arr, x, y, z)  # noqa: E731
    out = {}
    for mode, fn, split, plain in (
            ("Jacobian", jac, lambda: k6._launch(arr, x, zeroed=True),
             lambda: k6.opf_fill_ref(arr, x)),
            ("Hessian", hes, lambda: k6._launch(arr, x, y, z, zeroed=True),
             lambda: k6.opf_fill_ref(arr, x, y, z))):
        attr = k6.kernel_attributes(mode == "Hessian")
        check_one_launch(f"{label} K6 {mode}", fn)
        outputs = [t for t in fn() if t is not None]
        least = k6_bound(arr, x, outputs, (y, z) if mode == "Hessian" else ())
        rows = sum(t.shape[0] for t in outputs)
        del outputs
        floor = torch.empty((rows, arr.n_x), dtype=torch.float64,
                            device=x.device)
        zero = floor.zero_
        # memset-and-fill, a bare zero_() and the one launch in turns
        ms = [cuda_ms(f, reps=20) for f in (fn, split, zero, zero, split,
                                            fn)]
        del floor
        out[mode] = (0.5 * (ms[0] + ms[5]), queued_ms(fn, reps=20),
                     host_us(fn, reps=20), 0.5 * (ms[1] + ms[4]),
                     cuda_ms(plain, reps=3), least, 0.5 * (ms[2] + ms[3]))
        o = out[mode]
        print(f"phase 17 {label} K6 {mode} mode: {o[0]!r} ms per call "
              f"(CUDA events; runs {ms[0]!r}, {ms[5]!r}), device {o[1]!r} "
              f"ms queued, host {o[2]!r} us; one kernel node a call, no "
              f"memset or memcpy (CUDA graph); memset (torch.zeros) + "
              f"fill {o[3]!r} ms (runs {ms[1]!r}, {ms[4]!r}); a bare "
              f"zero_() of the same {rows} x {arr.n_x} output {o[6]!r} ms "
              f"(runs {ms[2]!r}, {ms[3]!r}); opf_fill_ref {o[4]!r} ms; "
              f"bound {least[0]!r} ms by {least[1]}, share "
              f"{least[0] / o[0]!r}; kernel: {attr['registers']} registers "
              f"and {attr['local_bytes']} local bytes a thread, "
              f"{attr['shared_bytes']} static shared bytes, "
              f"{attr['blocks_per_sm']} resident blocks an SM "
              f"({256 if mode == 'Jacobian' else 128} threads each)")
    pair = [sum(out[m][i] for m in out) for i in (0, 4)]
    least = sum(out[m][5][0] for m in out)
    return pair[0], pair[1], (least, "bytes")


def fixed_sums_check(spec):
    """``ops.segments.segment_sum`` on the card, twice, by columns and in
    one kernel, against the same calls on the CPU, bit for bit, and the
    gradient of a gather
    (``x[..., idx]``, which PyTorch sums in order on the card) twice, at
    the shapes of the spec's bus sums (its Y-bus entries by row, its
    generators by bus, a batch of line-search points) and of the 10k BBD
    KKT's residual (1.34M entries into 44,001 rows, in no order)."""
    rng = np.random.default_rng(SEED)
    arr = spec.arrays
    cases = [("Y-bus entries by row", arr.rows.cpu().numpy(), spec.n, ()),
             ("generators by bus", arr.gen_bus.cpu().numpy(), spec.n, ()),
             ("8 points' entries by row", arr.rows.cpu().numpy(), spec.n,
              (8,)),
             ("10k KKT residual", rng.integers(0, 44_001, 1_340_000), 44_001,
              ())]
    for name, index, size, lead in cases:
        src = rng.standard_normal(lead + (index.size,)) * 10.0 ** \
            rng.integers(-8, 8, lead + (index.size,))
        got = [segment_sum(torch.tensor(src, device=dev),
                           torch.tensor(index, device=dev), size,
                           forward_ad=ad).cpu()
               for ad in (True, False) for dev in ("cuda", "cuda", "cpu")]
        x = torch.tensor(rng.standard_normal(lead + (size,)), device="cuda")
        idx = torch.tensor(index, device="cuda")
        cot = torch.tensor(src, device="cuda")
        grads = [torch.func.vjp(lambda v: v[..., idx], x)[1](cot)[0]
                 for _ in range(2)]
        check(all(torch.equal(got[0], other) for other in got[1:])
              and torch.equal(grads[0], grads[1]),
              f"fixed-order sums ({name}): the card's and the CPU's bits "
              f"differ, max {float((got[0] - got[2]).abs().max())!r}, "
              f"gather's gradient twice "
              f"{float((grads[0] - grads[1]).abs().max())!r}")
        print(f"phase 17 fixed-order sums, {name} ({index.size} entries "
              f"into {size}, batch {lead}): card twice = CPU bit for bit, "
              f"by columns and in one kernel; a gather's gradient twice the "
              f"same bits")


def ac_opf_run(system, device, stages=False, iterates=None):
    """``ac_optimal_power_flow`` -> ``power_flow(power=True)`` on
    ``device``: the analysis, its wall (s), with ``stages`` the card's time
    by the interior point's stages and the peak device memory (bytes).
    With a list ``iterates``, every fifth (x, y, z) the solve hands the
    Hessian goes into it (host copies)."""
    analysis = ac_optimal_power_flow(system, device=device)
    if iterates is not None:
        analysis._refresh_spec()
        spec = analysis._spec
        hess = spec.hess

        def recording(x, y, z):
            if spec.n_hess % 5 == 0:
                iterates.append(tuple(t.cpu().numpy() for t in (x, y, z)))
            spec.n_hess += 1
            return hess(x, y, z)

        spec.n_hess = 0
        spec.hess = recording
    if device == "cpu":
        t0 = time.perf_counter()
        power_flow(analysis, power=True)
        return analysis, time.perf_counter() - t0, None, None
    torch.cuda.reset_peak_memory_stats()
    if stages:
        with device_stages() as split:
            wall, _ = wall_s(lambda: power_flow(analysis, power=True))
    else:
        split = None
        wall, _ = wall_s(lambda: power_flow(analysis, power=True))
    return analysis, wall, split, torch.cuda.max_memory_allocated()


def ac_feasibility(system, analysis):
    """Worst bus-balance residual (p.u., from the raw Y bus) and worst
    violation of the voltage, capability, flow and angle limits of an AC
    OPF solution, in numpy from the system's data."""
    n, bus, gen, br = (system.bus.number, system.bus, system.generator,
                       system.branch)
    g, m = gen.number, br.number
    vm = np.asarray(analysis.voltage.magnitude)
    va = np.asarray(analysis.voltage.angle)
    v = vm * np.exp(1j * va)
    s_inj = v * np.conj(system.model.ac.nodal @ v)
    pg = np.asarray(analysis.power.generator.active)
    qg = np.asarray(analysis.power.generator.reactive)
    on_g = gen.layout.status.array[:g] == 1
    supply = np.zeros(n, dtype=complex)
    np.add.at(supply, gen.layout.bus.array[:g][on_g], (pg + 1j * qg)[on_g])
    mismatch = supply - (bus.demand.active.array[:n]
                         + 1j * bus.demand.reactive.array[:n]) - s_inj
    balance = float(max(np.abs(mismatch.real).max(),
                        np.abs(mismatch.imag).max()))

    def over(val, lo, hi):
        lo = np.where(np.isfinite(lo), lo, -np.inf)
        hi = np.where(np.isfinite(hi), hi, np.inf)
        worst = np.maximum(lo - val, val - hi)
        return float(worst.max()) if worst.size else -np.inf

    volt = over(vm, bus.voltage.min_magnitude.array[:n],
                bus.voltage.max_magnitude.array[:n])
    cap = gen.capability
    power = max(over(pg[on_g], cap.min_active.array[:g][on_g],
                     cap.max_active.array[:g][on_g]),
                over(qg[on_g], cap.min_reactive.array[:g][on_g],
                     cap.max_reactive.array[:g][on_g]))
    on = br.layout.status.array[:m] == 1
    f = br.layout.from_bus.array[:m]
    t = br.layout.to_bus.array[:m]
    ac = system.model.ac
    i_f = ac.nodal_from_from * v[f] + ac.nodal_from_to * v[t]
    i_t = ac.nodal_to_from * v[f] + ac.nodal_to_to * v[t]
    ftype = (np.asarray(br.flow.type.array[:m]) if len(br.flow.type)
             else np.full(m, 3))
    flow, n_flow = -np.inf, 0
    for cur, vend, lo, hi in (
            (i_f, v[f], br.flow.min_from_bus.array[:m],
             br.flow.max_from_bus.array[:m]),
            (i_t, v[t], br.flow.min_to_bus.array[:m],
             br.flow.max_to_bus.array[:m])):
        s = vend * np.conj(cur)
        val = np.select([ftype == 1, ftype == 2, ftype == 3, ftype == 4],
                        [s.real, np.abs(s), np.abs(s) ** 2, np.abs(cur)],
                        np.abs(cur) ** 2)
        sq = np.where((ftype == 3) | (ftype == 5), 2, 1)
        lo = np.where(ftype != 1, np.maximum(lo, 0.0), lo)
        hi = np.where(ftype != 1, np.maximum(hi, 0.0), hi)
        used = on & ~((lo == 0.0) & (hi == 0.0)) & ~(np.isinf(lo)
                                                     & np.isinf(hi))
        lo_c = np.where((ftype != 1) & (lo == 0.0), -np.inf, lo ** sq)
        flow = max(flow, over(val[used], lo_c[used], (hi ** sq)[used]))
        n_flow += int(used.sum())
    two_pi = 2 * np.pi
    alo = (br.voltage.min_diff_angle.array[:m]
           if len(br.voltage.min_diff_angle) else np.full(m, -two_pi))
    ahi = (br.voltage.max_diff_angle.array[:m]
           if len(br.voltage.max_diff_angle) else np.full(m, two_pi))
    # the rows the model keeps: a pair of 0 or ±2π limits means no limit
    kept = on & ((np.isfinite(alo) & (alo != 0.0) & (alo != -two_pi))
                 | (np.isfinite(ahi) & (ahi != 0.0) & (ahi != two_pi)))
    angle = over((va[f] - va[t])[kept], alo[kept], ahi[kept])
    return balance, volt, power, flow, angle, n_flow


def ac_opf_small():
    """case14optimal and case30test card vs CPU; case118 against MATPOWER's
    published optimum. Returns the case118 analysis."""
    for case in ("case14optimal", "case30test"):
        card, wall, split, _ = ac_opf_run(case_system(case), "cuda",
                                          stages=True)
        cpu, t_cpu, _, _ = ac_opf_run(case_system(case), "cpu")
        dstate = max(float(np.abs(card.voltage.magnitude
                                  - cpu.voltage.magnitude).max()),
                     float(np.abs(card.voltage.angle
                                  - cpu.voltage.angle).max()),
                     float(np.abs(card.power.generator.active
                                  - cpu.power.generator.active).max()),
                     float(np.abs(card.power.generator.reactive
                                  - cpu.power.generator.reactive).max()))
        it, it_cpu = card.method.iteration, cpu.method.iteration
        check(card.method.converged and cpu.method.converged
              and it == it_cpu and dstate <= AC_OPF_CARD_CPU_TOL,
              f"{case} AC OPF: card vs CPU iterations {it}/{it_cpu}, states "
              f"{dstate:.3e}, converged {card.method.converged}/"
              f"{cpu.method.converged}")
        print(f"phase 17 {opf_line(case + ' AC OPF', card, wall)}; CPU "
              f"{it_cpu} iterations in {t_cpu!r} s; card vs CPU states (V, "
              f"θ, Pg, Qg) {dstate!r}; per iteration (CUDA events): "
              f"{stage_ms(split, it)}")
    system = case_system("case118")
    iterates = []
    card, wall, split, _ = ac_opf_run(system, "cuda", stages=True,
                                      iterates=iterates)
    res = card.method.result
    drel = abs(res.objective - CASE118_AC_OBJ) / CASE118_AC_OBJ
    check(res.status in ("optimal", "acceptable")
          and drel <= CASE118_AC_RTOL,
          f"case118 AC OPF: status {res.status}, objective {res.objective}"
          f" against MATPOWER's {CASE118_AC_OBJ} (rel {drel:.3e})")
    print(f"phase 17 {opf_line('case118 AC OPF', card, wall)}; against "
          f"MATPOWER's {CASE118_AC_OBJ} rel {drel!r}; per iteration (CUDA "
          f"events): {stage_ms(split, res.iterations)}")
    return card, iterates


def phase17():
    """K6 against its plain version (case14optimal with every flow class,
    case118, pegase; random points, the flat start, a solve's iterates and
    its optimum),
    then the AC OPF: case14optimal/case30test card vs CPU, case118 vs
    MATPOWER, and the main path, case1354pegase at full size with its own
    costs through ``power_flow(power=True)``. Returns K6's worst abs error,
    its times, its launches on the main path and the pegase analysis."""
    rng = np.random.default_rng(SEED)
    worst = 0.0
    for cls in (1, 2, 3, 4, 5):
        system = with_flow_class(case_system("case14optimal"), cls)
        spec = ac_optimal_power_flow(system, device="cuda")._spec
        x0 = spec.start(system)
        points = k6_points(spec, x0, rng)
        err, rel, entry = compare_k6(f"case14optimal class {cls}",
                                     spec.arrays, points)
        worst = max(worst, err)
        print(f"phase 17 case14optimal, flow class {cls} ({len(spec.flows)}"
              f" flow rows, {k6_zero_rows(spec, points[-1][0])} √ rows "
              f"below the clamp at the flat start): K6 vs opf_fill_ref at "
              f"{len(points)} points, max abs diff {err!r}, max rel diff "
              f"{rel!r} of the row ({entry!r} of the entry)")

    case118, iterates = ac_opf_small()
    spec, res = case118._spec, case118.method.result
    points = k6_points(spec, spec.start(case118.system), rng)
    points += iterates + [(res.x, res.y, res.z)]
    err, rel, entry = compare_k6("case118", spec.arrays, points)
    worst = max(worst, err)
    print(f"phase 17 case118: K6 vs opf_fill_ref at {len(points)} points "
          f"({len(iterates)} iterates of the solve and its optimum last), "
          f"max abs diff {err!r}, max rel "
          f"diff {rel!r} of the row ({entry!r} of the entry)")

    # the main path: pegase at full size, its own costs
    system = power_system(str(DATA / OPF_PEGASE))
    k6.opf_fill.launches = 0
    card, wall, split, peak = ac_opf_run(system, "cuda", stages=True)
    launches = k6.opf_fill.launches
    res, spec = card.method.result, card._spec
    balance, volt, power, flow, angle, n_flow = ac_feasibility(system, card)
    dobj = abs(res.objective - PEGASE_AC_OBJ)
    check(res.status in ("optimal", "acceptable")
          and dobj <= PEGASE_AC_OBJ_TOL and balance <= AC_FEAS_BALANCE_TOL
          and max(volt, power, flow, angle) <= AC_FEAS_LIMIT_TOL
          and launches > 0,
          f"{OPF_PEGASE} AC OPF: status {res.status}, objective "
          f"{res.objective!r} (|d| {dobj:.3e} from {PEGASE_AC_OBJ}), balance"
          f" {balance:.3e}, limits V {volt:.3e} PQ {power:.3e} flow "
          f"{flow:.3e} angle {angle:.3e}, K6 launches {launches}")
    it = res.iterations
    label = OPF_PEGASE + " AC OPF (own costs)"
    print(f"phase 17 {opf_line(label, card, wall)}; n_x {spec.n_x}, m_E "
          f"{spec.m_e}, m_I {spec.m_i}, KKT order {spec.n_x + spec.m_e}, "
          f"{len(spec.flows)} flow rows; objective {dobj!r} from MATPOWER's "
          f"{PEGASE_AC_OBJ}; optimal with KKT <= 1e-8: "
          f"{res.status == 'optimal' and res.kkt_error <= 1e-8}; worst "
          f"balance {balance!r} p.u. (raw Y bus), limits: V {volt!r}, Pg/Qg "
          f"{power!r}, flow {flow!r} ({n_flow} limited ends), angle "
          f"{angle!r}; K6 launches {launches} ({launches / it!r} an "
          f"iteration); peak {peak / 1e9!r} GB; per iteration (CUDA "
          f"events): {stage_ms(split, it)}")

    points = k6_points(spec, spec.start(system), rng, count=1)
    points.append((res.x, res.y, res.z))
    err, rel, entry = compare_k6(OPF_PEGASE, spec.arrays, points)
    worst = max(worst, err)
    print(f"phase 17 {OPF_PEGASE}: K6 vs opf_fill_ref at {len(points)} "
          f"points ({k6_zero_rows(spec, points[-2][0])} √ rows below the "
          f"clamp at the flat start; the last point the solve's optimum), "
          f"max abs diff {err!r}, max rel diff {rel!r} of the row ({entry!r}"
          f" of the entry)")
    fixed_sums_check(spec)
    dev = spec.arrays.rows.device
    x, y, z = (torch.as_tensor(a, device=dev) for a in (res.x, res.y, res.z))
    times = k6_times(OPF_PEGASE, spec.arrays, x, y, z)
    return worst, times, launches, card


# ---- phase 18: the structured (BBD) KKT of the AC OPF and K7 ---------------

def k7_point(spec, x0, rng):
    """A random interior point near the start ``x0`` (inside the boxes: the
    start sits 1% inside them, V moves 0.2%), duals y, z and slacks s > 0,
    Σ = z / s, and random objective and row scales."""
    n = spec.n
    x = np.array(x0, dtype=np.float64)
    x[:n] += 0.05 * rng.standard_normal(n)
    x[n:2 * n] *= 1.0 + 0.002 * rng.standard_normal(n)
    z = rng.uniform(1e-2, 1e2, spec.m_i)
    s = rng.uniform(1e-2, 1e2, spec.m_i)
    return (x, rng.standard_normal(spec.m_e), z, z / s,
            1e-6, float(rng.uniform(0.2, 1.0)),
            rng.uniform(0.3, 1.0, spec.m_e), rng.uniform(0.3, 1.0, spec.m_i))


def k7_args(kkt, point, table=None):
    """K7's arguments at ``point`` in ``kkt``'s tables or in ``table``
    (one rank's, ``kkt_fill_table(kkt, block=r)``)."""
    dev = kkt.spec.arrays.rows.device
    x, y, z, sigma, delta, sf, ge, gi = point
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (kkt.table if table is None else table, kkt.spec.arrays, t(x),
            t(y), t(z), t(sigma), delta, sf, t(ge), t(gi))


def compare_k7(label, kkt, point, table=None):
    """K7 against kkt_fill_ref (in ``kkt``'s tables or ``table``): every
    COO value within K7_REL_TOL of its KKT row's scale (its largest
    value), d, and every element of the four blocks within K7_REL_TOL of
    its block row's scale. Returns the worst abs and row-relative
    differences."""
    args = k7_args(kkt, point, table)
    got, ref = k7.kkt_fill(*args), k7.kkt_fill_ref(*args)
    rows = args[0].rows.long()
    rmax = torch.zeros(kkt.n_aug, dtype=torch.float64, device=rows.device)
    rmax = rmax.scatter_reduce(0, rows, ref.vals.abs(), "amax")
    pairs = [("vals", got.vals, ref.vals, rmax[rows].clamp(min=1.0)),
             ("d", got.d, ref.d, ref.d.abs().clamp(min=1.0))]
    for name in ("a_ii", "a_ib", "a_bi", "a_bb"):
        b = getattr(ref, name)
        pairs.append((name, getattr(got, name), b,
                      b.abs().amax(dim=-1, keepdim=True).clamp(min=1.0)))
    worst_abs = worst_rel = 0.0
    where = ""
    for name, a, b, scale in pairs:
        diff = (a - b).abs()
        worst_abs = max(worst_abs, diff.max().item())
        rel = (diff / scale).reshape(-1)
        k = int(rel.argmax())
        if rel[k].item() > worst_rel or not torch.isfinite(rel[k]):
            worst_rel = rel[k].item()
            where = (f"{name}[{k}]: {a.reshape(-1)[k].item()!r} against "
                     f"{b.reshape(-1)[k].item()!r}")
    del got, ref, pairs
    torch.cuda.synchronize()
    check(worst_rel <= K7_REL_TOL,
          f"{label}: K7 disagrees with kkt_fill_ref, rel {worst_rel:.3e} of "
          f"the row at {where}")
    note_rel("kkt_fill", worst_rel)
    return worst_abs, worst_rel


def k7_bound(kkt, args):
    """K7's least time: the tables its launches read (``kkt_fill._ARR``,
    ``_FILL`` and ``_TAB``) and the iterate read once; the values, d and
    the four blocks written once (the blocks as a whole: their zeros too);
    the row-maxima scratch is no output and not counted. The operations (a
    few tens a COO value, ~1,000 a flow row) are far below the bytes."""
    table = args[0]
    s = table.size
    arr = kkt.spec.arrays
    tables = [getattr(arr, name) for name in k7._ARR] \
        + [getattr(arr.fill, name) for name in k7._FILL] \
        + [getattr(table, name) for name in k7._TAB]
    inputs = [t for t in args[2:] if torch.is_tensor(t)]
    blocks = 8 * (s["k"] * s["ni"] * (s["ni"] + 2 * s["mbl"])
                  + s["mb"] * s["mb"])
    nbytes = tensor_bytes(*tables, *inputs) + blocks \
        + 8 * (s["n_entries"] + s["n_aug"])
    ops = K7_OPS_PER_ENTRY * s["n_entries"] + K7_OPS_PER_FLOW * s["n_fl"]
    return bound(nbytes, ops)


def k7_times(label, kkt, point, table=None, phase=18):
    """K7 at ``point`` (in ``kkt``'s tables or ``table``): ms a call (CUDA
    events; two memsets and two launches), its device time alone and host
    µs, the plain version, the bound. Returns (ms, plain_ms, (bound_ms,
    bound_by))."""
    args = k7_args(kkt, point, table)
    fn = lambda: k7.kkt_fill(*args)  # noqa: E731
    ms = cuda_ms(fn, reps=10)
    queued = queued_ms(fn, reps=10)
    host = host_us(fn, reps=10)
    plain_ms = cuda_ms(lambda: k7.kkt_fill_ref(*args), reps=3)
    least = k7_bound(kkt, args)
    print(f"phase {phase} {label} K7: {ms!r} ms per call (CUDA events, the "
          f"memsets and both launches), device {queued!r} ms queued, host "
          f"{host!r} us; kkt_fill_ref {plain_ms!r} ms; bound {least[0]!r} ms "
          f"by {least[1]}, share {least[0] / ms!r}")
    return ms, plain_ms, least


def kkt_layout(kkt):
    return (f"k {kkt.k}, ni {kkt.ni}, mb {kkt.mb}, mbl {kkt.mbl}, "
            f"{kkt.n_entries} COO entries, {kkt.table.size['n_dest']} block "
            f"elements written")


def k7_cells(rng):
    """Phase 18 (a): K7 against its plain version at case118 (4 blocks),
    case1354pegase (8) and the 10k cell (the automatic 19); times at each.
    Returns the worst abs error and the 10k cell's times."""
    worst, times = 0.0, None
    for label, system, blocks in (
            ("case118", case_system("case118"), 4),
            (OPF_PEGASE, power_system(str(DATA / OPF_PEGASE)), 8),
            ("10k AC OPF grid", synthetic_grid(*KKT_GRID, opf=True), None)):
        spec = ac_optimal_power_flow(system, device="cuda")._spec
        kkt = kkt_bbd.AcKktBbd(spec, blocks or max(8, spec.n // 512))
        point = k7_point(spec, spec.start(system), rng)
        err, rel = compare_k7(label, kkt, point)
        worst = max(worst, err)
        print(f"phase 18 {label} (n_x {spec.n_x}, m_E {spec.m_e}, m_I "
              f"{spec.m_i}, {len(spec.flows)} flow rows; {kkt_layout(kkt)}; "
              f"host build {kkt.build_s!r} s): K7 vs kkt_fill_ref max abs "
              f"diff {err!r}, max rel diff {rel!r} of the row")
        times = k7_times(label, kkt, point)
        del kkt, spec
    torch.cuda.empty_cache()
    return worst, times


def step_point(spec, system, rng):
    """An interior point near the start for one step: x, y, z from
    ``k7_point`` and slacks s, on the spec's device."""
    x, y, z, _, _, _, _, _ = k7_point(spec, spec.start(system), rng)
    s = rng.uniform(0.5, 2.0, spec.m_i)
    dev = spec.arrays.rows.device
    return tuple(torch.as_tensor(a, device=dev) for a in (x, y, z, s))


def step_dx(spec, point, kkt=None):
    """One interior-point step's dx at ``point`` (μ 0.1, δ 1e-6), through
    the structured KKT ``kkt`` or, without one, the dense KKT."""
    x, y, z, s = point
    fn_args = (spec.objective, spec.eq, spec.ineq, spec.n_x, spec.m_e,
               spec.m_i)
    if kkt is None:
        fns = ipm._make_fns(*fn_args, jac_e_fn=spec.jac_eq,
                            jac_i_fn=spec.jac_ineq, hess_fn=spec.hess)
    else:
        unit = {"sf": 1.0, "ge": None, "gi": None}
        fns = ipm._make_fns(*fn_args,
                            kkt_solve=lambda *a: kkt.solve(*a, unit))
    return fns.step(x, y, z, s, 0.1, 1e-6, spec.eq(x), spec.ineq(x) - s)[0]


def bbd_vs_dense(rng):
    """Phase 18 (b): the BBD KKT against the dense KKT on the card, at
    synthetic_grid(30, 30, opf=True): the two steps at one iterate, and
    both solves end to end in one process."""
    system = synthetic_grid(*KKT_SMALL_GRID, opf=True)
    spec = ac_optimal_power_flow(system, device="cuda")._spec
    kkt = kkt_bbd.AcKktBbd(spec, KKT_SMALL_BLOCKS)
    point = step_point(spec, system, rng)
    got, want = step_dx(spec, point, kkt), step_dx(spec, point)
    scale = max(1.0, want.abs().max().item())
    ddx = (got - want).abs().max().item() / scale
    check(ddx <= BBD_DENSE_STEP_TOL,
          f"30x30 AC OPF: BBD step dx differs from the dense step's by "
          f"{ddx:.3e} of its scale")
    runs = {}
    for blocks in (KKT_SMALL_BLOCKS, 0):
        analysis = ac_optimal_power_flow(synthetic_grid(*KKT_SMALL_GRID,
                                                        opf=True),
                                         device="cuda")
        wall, _ = wall_s(lambda: ac_mod.solve(analysis, kkt_blocks=blocks))
        runs[blocks] = (analysis, wall)
    (b, wb), (d, wd) = runs[KKT_SMALL_BLOCKS], runs[0]
    rb, rd = b.method.result, d.method.result
    dobj = abs(rb.objective - rd.objective) / max(1.0, abs(rd.objective))
    dstate = max(np.abs(b.voltage.magnitude - d.voltage.magnitude).max(),
                 np.abs(b.voltage.angle - d.voltage.angle).max())
    check(rb.status == rd.status and rd.status in ("optimal", "acceptable")
          and dobj <= BBD_DENSE_OBJ_RTOL and dstate <= BBD_DENSE_STATE_TOL,
          f"30x30 AC OPF: BBD {rb.status} vs dense {rd.status}, objective "
          f"rel {dobj:.3e}, V/θ {dstate:.3e}")
    print(f"phase 18 30x30 AC OPF (n_x {spec.n_x}, KKT order "
          f"{spec.n_x + spec.m_e}; BBD {kkt_layout(kkt)}): one step's dx BBD "
          f"vs dense {ddx!r} of its scale; BBD {rb.status} in "
          f"{rb.iterations} iterations, {wb!r} s; dense {rd.status} in "
          f"{rd.iterations} iterations, {wd!r} s; objective rel {dobj!r}, "
          f"V/θ {dstate!r}")


def kkt_10k_run():
    """Phase 18 (c), the main path: synthetic_grid(100, 100, opf=True)
    through ``power_flow(power=True)`` with kkt_blocks unset (the BBD KKT),
    K7's and K5's counts reset just before and read just after; then a
    live cost edit re-solved on the cached structure. Returns (K7
    launches, K5 launches)."""
    system = synthetic_grid(*KKT_GRID, opf=True)
    analysis = ac_optimal_power_flow(system, device="cuda")
    start = np.array(analysis._x0)
    steps = []
    solve = kkt_bbd.AcKktBbd.solve

    def recording(self, *args):
        out = solve(self, *args)
        dx = out[0]
        steps.append(torch.stack([out[2], out[3], dx @ dx,
                                  torch.isfinite(dx).all().to(dx.dtype)]))
        return out

    kkt_bbd.AcKktBbd.solve = recording
    try:
        torch.cuda.reset_peak_memory_stats()
        k7.kkt_fill.launches = 0
        k5.schur_gather.launches = 0
        with device_stages() as split:
            wall, _ = wall_s(lambda: power_flow(analysis, power=True))
        launches = (k7.kkt_fill.launches, k5.schur_gather.launches)
        peak = torch.cuda.max_memory_allocated()
    finally:
        kkt_bbd.AcKktBbd.solve = solve
    res = analysis.method.result
    kkt = analysis._kkt_cache[2]
    stats = torch.stack(steps).cpu().numpy() if steps else np.zeros((0, 4))
    # the steps the δ loop accepts: finite, lin_res < 1e-6, curvature held
    taken = (stats[:, 3] > 0.5) & (stats[:, 0] < 1e-6) & (
        (stats[:, 1] >= 1e-12 * stats[:, 2]) | (stats[:, 2] == 0.0))
    worst_lin = float(stats[taken, 0].max()) if taken.any() else np.inf
    balance, volt, power, flow, angle, _ = ac_feasibility(system, analysis)
    check(res.status in ("optimal", "acceptable")
          and balance <= KKT_BALANCE_TOL
          and max(volt, power, flow, angle) <= AC_FEAS_LIMIT_TOL
          and worst_lin <= KKT_LIN_RES_TOL and min(launches) > 0,
          f"10k AC OPF: status {res.status}, balance {balance:.3e}, limits "
          f"V {volt:.3e} PQ {power:.3e} flow {flow:.3e} angle {angle:.3e}, "
          f"worst accepted lin_res {worst_lin:.3e}, K7/K5 launches "
          f"{launches}")
    it = res.iterations
    spec = analysis._spec
    line = opf_line("10k AC OPF (the main path)", analysis, wall)
    print(f"phase 18 {line} (the reference: optimal in "
          f"{KKT_REF_ITERATIONS} at tol 1e-6); "
          f"n_x {spec.n_x}, m_E {spec.m_e}, m_I {spec.m_i}, KKT order "
          f"{spec.n_x + spec.m_e}; {kkt_layout(kkt)}; host build "
          f"{kkt.build_s!r} s; {len(stats)} KKT solves, {int(taken.sum())} "
          f"taken, worst lin_res of those {worst_lin!r}; worst balance "
          f"{balance!r} p.u. (raw Y bus), limits: V {volt!r}, Pg/Qg "
          f"{power!r}; K7 launches {launches[0]}, K5 {launches[1]}; peak "
          f"{peak / 1e9!r} GB; per iteration (CUDA events): "
          f"{stage_ms(split, it)}")
    # one input, one trajectory: the same solve again from a fresh build of
    # the same grid
    again = ac_optimal_power_flow(synthetic_grid(*KKT_GRID, opf=True),
                                  device="cuda")
    check(np.array_equal(again._x0, start),
          "10k AC OPF: the second build starts elsewhere")
    wall_again, _ = wall_s(lambda: power_flow(again, power=True))
    same_trajectory("phase 18 10k AC OPF", res, again.method.result,
                    wall, wall_again)
    del again
    # a numeric live edit keeps the routed structure: a new quadratic cost
    # for the generator that supplies most
    top = int(np.argmax(analysis.power.generator.active))
    update_cost(analysis, system.generator.label.label(top), active=2,
                polynomial=[0.05, 25.0, 0.0])
    wall2, _ = wall_s(lambda: power_flow(analysis, power=True))
    res2 = analysis.method.result
    check(analysis._kkt_cache[2] is kkt
          and res2.status in ("optimal", "acceptable"),
          f"10k AC OPF after a cost edit: status {res2.status}, cached "
          f"structure reused {analysis._kkt_cache[2] is kkt}")
    line = opf_line("10k AC OPF after update_cost", analysis, wall2)
    print(f"phase 18 {line}; the cached AcKktBbd reused")
    return launches


def same_trajectory(label, first, second, wall, wall_again):
    """Two solves of one input must take the same iterations to the same
    bits of x, y, z and the objective (the AC OPF's sums run in a fixed
    order, ``ops/segments.py``)."""
    same = {name: np.array_equal(getattr(first, name),
                                 getattr(second, name))
            for name in ("x", "y", "z", "s")}
    same["objective"] = first.objective == second.objective
    check(first.iterations == second.iterations and all(same.values()),
          f"{label}: two solves of one input differ: iterations "
          f"{first.iterations}/{second.iterations}, bit-equal {same}, "
          f"objective {first.objective!r}/{second.objective!r}")
    print(f"{label} solved again from the same start: {second.iterations} "
          f"iterations, status {second.status}, x, y, z, s and the "
          f"objective {second.objective!r} equal bit for bit; "
          f"{wall_again!r} s (first {wall!r} s)")


def phase18():
    """The structured KKT of the AC OPF: K7 against its plain version at
    case118, pegase and the 10k cell; the BBD KKT against the dense KKT at
    900 buses; the main path, the 10k AC OPF at full size, and a live edit.
    Returns K7's worst abs error, its times at the 10k cell, its launches
    and K5's on the main path."""
    rng = np.random.default_rng(SEED)
    worst, times = k7_cells(rng)
    bbd_vs_dense(rng)
    k7_launches, k5_launches = kkt_10k_run()
    return worst, times, k7_launches, k5_launches


# ---- phase 19: the product surface on the card -----------------------------

def entry_check():
    """``entry()``'s step on the card against the same step on the CPU.
    Returns its K1 launches."""
    k1.nr_fill.launches = 0
    fn, args = entry()
    wall, (vm, va) = wall_s(lambda: fn(*args))
    launches = k1.nr_fill.launches
    cfn, cargs = entry(device="cpu")
    cvm, cva = cfn(*cargs)
    err = max(float((vm.cpu() - cvm).abs().max()),
              float((va.cpu() - cva).abs().max()))
    check(args[0].cols.device.type == "cuda" and launches == 1
          and err <= ENTRY_TOL,
          f"entry(): device {args[0].cols.device}, {launches} K1 launches, "
          f"card vs CPU {err:.3e} (tol {ENTRY_TOL})")
    print(f"phase 19 entry(): one Newton-Raphson step on case14test, card "
          f"vs CPU max |d| {err!r}, K1 launches {launches}, wall {wall!r} s")
    return launches


def state_diff(a, b):
    return max(float(np.abs(a.voltage.magnitude - b.voltage.magnitude).max()),
               float(np.abs(a.voltage.angle - b.voltage.angle).max()))


def removable_branch(system):
    """An in-service branch whose outage leaves one island."""
    status = system.branch.layout.status
    for k in range(system.branch.number):
        if status[k] == 1:
            status[k] = 0
            connected = len(physical_island(system)) == 1
            status[k] = 1
            if connected:
                return k
    raise SmokeFailure("no removable branch")


def nr_edits():
    """Three live edits of the reuse matrix on a fresh 10k grid: the
    reused analysis re-solved against a fresh build of the edited grid,
    both on the card, and against ``oracle_nr``. Returns their K1
    launches: the first solve's, the re-solves' and the fresh builds'."""
    system = synthetic_grid(*GRID)
    k1.nr_fill.launches = 0
    live = newton_raphson(system, device="cuda")
    power_flow(live, tolerance=EDIT_TOL)
    check(live.method.converged, "10k edits: the first solve failed")
    labels = system.bus.label
    gen_bus = labels.label(GRID[0] * GRID[1] // 2 + GRID[1] // 2)
    demand_bus = labels.label(GRID[0] * GRID[1] // 3)
    n = system.bus.number
    edits = (
        ("branch out", lambda: update_branch(
            system, system.branch.label.label(removable_branch(system)),
            status=0)),
        ("generator added", lambda: add_generator(
            system, bus=gen_bus, active=0.2, reactive=0.05, max_active=0.5,
            min_active=0.0, max_reactive=0.2, min_reactive=-0.2,
            magnitude=1.0, status=1)),
        ("demand", lambda: update_bus(
            system, demand_bus,
            active=system.bus.demand.active.array[labels.index(demand_bus)]
            + 0.1, reactive=0.05)))
    for name, edit in edits:
        edit()
        t_live, _ = wall_s(lambda: power_flow(live, tolerance=EDIT_TOL))
        fresh = None

        def build_and_solve():
            nonlocal fresh
            fresh = newton_raphson(system, device="cuda")
            power_flow(fresh, tolerance=EDIT_TOL)

        t_fresh, _ = wall_s(build_and_solve)
        t0 = time.perf_counter()
        oracle = oracle_nr(system, tolerance=EDIT_TOL)
        t_oracle = time.perf_counter() - t0
        d = state_diff(live, fresh)
        check(live.method.converged and d <= REUSE_TOL,
              f"10k edit {name}: reused vs fresh {d:.3e} (tol {REUSE_TOL})")
        check_against_oracle(f"10k edit {name} (fresh)", fresh, oracle,
                             GRID_STATE_TOL)
        dvm = float(np.abs(live.voltage.magnitude - oracle.magnitude).max())
        dang = live.voltage.angle - oracle.angle
        dva = float(np.abs((dang + np.pi) % (2 * np.pi) - np.pi).max())
        check(max(dvm, dva) <= GRID_STATE_TOL,
              f"10k edit {name}: reused vs oracle {dvm:.3e}, {dva:.3e}")
        print(f"phase 19 10k NR edit '{name}' (n={n}): reused re-solve "
              f"{live.method.iteration} iterations in {t_live!r} s, fresh "
              f"build + solve {fresh.method.iteration} iterations (oracle "
              f"{oracle.iterations}) in {t_fresh!r} s, oracle_nr "
              f"{t_oracle!r} s; reused vs fresh max |d| {d!r}, reused vs "
              f"oracle {max(dvm, dva)!r}")
    return k1.nr_fill.launches


def se_edits():
    """Two live measurement edits on phase 6's 1,369-bus set, built anew
    with seeded noise so that each edit moves the estimate: the reused
    estimate against a fresh one, both on the card; then the edited set's
    wattmeter table. Returns the launches of K3's entry mode and K8 of the
    estimates (not of the power flow that makes the set, nor of the
    table)."""
    system = synthetic_grid(*SE_GRID)
    meter_devices.seed(SEED)
    mon, _ = scada_pmu(system, noise=True)
    zero_se_launches()
    live = gauss_newton(mon, device="cuda")
    state_estimation(live, tolerance=EDIT_TOL)
    check(live.method.converged, "SE edits: the first estimate failed")
    watt = mon.wattmeter.label.label(mon.wattmeter.number // 2)
    var = mon.varmeter.label.label(mon.varmeter.number // 3)
    edits = (("wattmeter off", lambda: update_wattmeter(mon, watt, status=0)),
             ("varmeter variance", lambda: update_varmeter(mon, var,
                                                           variance=4e-3)))
    for name, edit in edits:
        edit()
        t_live, _ = wall_s(lambda: state_estimation(live, tolerance=EDIT_TOL))
        fresh = None

        def build_and_solve():
            nonlocal fresh
            fresh = gauss_newton(mon, device="cuda")
            state_estimation(fresh, tolerance=EDIT_TOL)

        t_fresh, _ = wall_s(build_and_solve)
        d = state_diff(live, fresh)
        check(live.method.converged and fresh.method.converged
              and d <= REUSE_TOL,
              f"SE edit {name}: reused vs fresh {d:.3e} (tol {REUSE_TOL})")
        print(f"phase 19 {SE_GRID[0]}x{SE_GRID[1]} SE edit '{name}': reused "
              f"{live.method.iteration} iterations in {t_live!r} s, fresh "
              f"gauss_newton + state_estimation {fresh.method.iteration} "
              f"iterations in {t_fresh!r} s; reused vs fresh max |d| {d!r}")
    launches = se_launches()
    top, err, seconds = residual_table(
        f"{SE_GRID[0]}x{SE_GRID[1]} noisy SE after the edits", live, mon)
    check(top >= NOISY_RESIDUAL_MIN,
          f"noisy SE: residual column max |r| {top:.3e} under "
          f"{NOISY_RESIDUAL_MIN}: the gate cannot tell it from zeros")
    print(f"phase 19 {SE_GRID[0]}x{SE_GRID[1]} noisy SE print_wattmeter_data "
          f"({mon.wattmeter.number} rows) after the edits: Residual column "
          f"max |r| {top!r}, vs se_fill_ref on the CPU {err!r} of max(1, "
          f"|mean|); host {seconds!r} s")
    return launches


def render(printer, *args, **kw):
    """A table rendered into a StringIO: (column names, body rows, host
    s). The header block (names, then units where a column has one) lies
    between the first two border lines."""
    t0 = time.perf_counter()
    text = printer(*args, file=io.StringIO(), **kw)
    seconds = time.perf_counter() - t0
    lines = text.splitlines()
    first, second = [i for i, line in enumerate(lines)
                     if line.startswith("+")][:2]
    cells = [[c.strip() for c in line.strip("|").split("|")]
             for line in lines[second + 1:] if line.startswith("|")]
    names = [c.strip() for c in lines[first + 1].strip("|").split("|")]
    return names, cells, seconds


def column(header, rows, name):
    """The non-empty cells of column ``name`` as floats."""
    check(name in header, f"table has no column {name!r}: {header}")
    i = header.index(name)
    return np.array([float(r[i]) for r in rows if r[i] not in ("", "-")])


def residual_table(label, se, mon):
    """``print_wattmeter_data`` of an SE analysis, its Residual column held
    to mean - h(x) at the analysis's state from ``se_fill_ref`` on arrays
    compiled anew on the CPU. Returns the column's max |r|, its worst error
    of max(1, |mean|) and the table's host s."""
    header, rows, seconds = render(print_wattmeter_data, mon, analysis=se,
                                   fmt={"Residual": "{:.17e}"})
    got = column(header, rows, "Residual")
    arr, _, row_device = compile_se_arrays(se.system, mon, device="cpu")
    net = compile_ac_arrays(se.system, "cpu")
    vm, va = (torch.as_tensor(v)[None] for v in (se.voltage.magnitude,
                                                 se.voltage.angle))
    r = k3.se_fill_ref(arr, net, vm, va, arr.mean[None],
                       jacobian=False).r[0].numpy()
    mean = arr.mean.numpy()
    first = {}
    for row, (kind, dev) in enumerate(row_device):
        if kind == "wattmeter":
            first.setdefault(dev, row)
    rows_of = np.array([first[i] for i in range(mon.wattmeter.number)])
    err = float((np.abs(got - r[rows_of])
                 / np.maximum(1.0, np.abs(mean[rows_of]))).max())
    check(len(rows) == mon.wattmeter.number and len(got) == len(rows)
          and err <= RESIDUAL_TABLE_TOL,
          f"{label} print_wattmeter_data: {len(rows)} rows, {len(got)} "
          f"residuals for {mon.wattmeter.number} wattmeters, vs mean - h(x) "
          f"from se_fill_ref on the CPU {err:.3e} (tol {RESIDUAL_TABLE_TOL})")
    return float(np.abs(got).max()), err, seconds


def tables(nr, se, se_mon, dc_10k, pegase):
    """The report tables of the earlier phases' analyses, gated on their
    row counts, pegase's balance and flow columns and the SE residuals."""
    walls = []
    system = nr.system
    for printer, count in ((print_bus_data, system.bus.number),
                           (print_branch_data, system.branch.number),
                           (print_generator_data, system.generator.number),
                           (print_bus_summary, None),
                           (print_branch_summary, None),
                           (print_generator_summary, None)):
        header, rows, seconds = render(printer, nr)
        if count is None:   # one row a quantity: finite, min <= max
            low = column(header, rows, "Minimum")
            high = column(header, rows, "Maximum")
            check(len(rows) > 0 and np.all(np.isfinite(low))
                  and np.all(low <= high), f"10k {printer.__name__}: {rows}")
        else:
            check(len(rows) == count, f"10k {printer.__name__}: {len(rows)} "
                                      f"rows for {count} elements")
        walls.append((f"10k NR {printer.__name__}", len(rows), seconds))

    precise = {name: "{:.17e}" for name in (
        "Active Power Balance Solution", "Reactive Power Balance Solution",
        "Flow Solution")}
    spec, psys = pegase._spec, pegase.system
    header, rows, seconds = render(print_bus_constraint, pegase, fmt=precise)
    balance = max(float(np.abs(column(header, rows, name)).max()) for name in
                  ("Active Power Balance Solution",
                   "Reactive Power Balance Solution"))
    check(len(rows) == psys.bus.number and balance <= TABLE_BALANCE_TOL,
          f"pegase print_bus_constraint: {len(rows)} rows, balance "
          f"{balance:.3e} (tol {TABLE_BALANCE_TOL})")
    walls.append(("pegase AC OPF print_bus_constraint", len(rows), seconds))
    header, rows, seconds = render(print_branch_constraint, pegase,
                                   fmt=precise)
    flows = column(header, rows, "Flow Solution")
    x = torch.as_tensor(pegase._x0)
    want = ac_mod.flow_values(acopf_arrays_from_numpy(spec, "cpu"),
                              x[:spec.n], x[spec.n:2 * spec.n]).numpy()
    flow_err = float((np.abs(flows - want) / np.maximum(1.0, np.abs(want)))
                     .max())
    check(len(flows) == len(spec.fl_k) and flow_err <= FLOW_TABLE_REL_TOL,
          f"pegase print_branch_constraint: {len(flows)} flow rows for "
          f"{len(spec.fl_k)}, vs flow_values on the CPU {flow_err:.3e} of "
          f"the row (tol {FLOW_TABLE_REL_TOL})")
    walls.append(("pegase AC OPF print_branch_constraint", len(rows),
                  seconds))
    header, rows, seconds = render(print_generator_constraint, pegase)
    check(len(rows) == psys.generator.number,
          f"pegase print_generator_constraint: {len(rows)} rows")
    walls.append(("pegase AC OPF print_generator_constraint", len(rows),
                  seconds))

    for printer, count in (
            (print_bus_constraint, dc_10k.system.bus.number),
            (print_generator_constraint, dc_10k.system.generator.number)):
        header, rows, seconds = render(printer, dc_10k)
        check(len(rows) == count, f"ACTIVSg10k DC OPF {printer.__name__}: "
                                  f"{len(rows)} rows for {count}")
        walls.append((f"ACTIVSg10k DC OPF {printer.__name__}", len(rows),
                      seconds))

    top, res_err, seconds = residual_table(
        f"{SE_GRID[0]}x{SE_GRID[1]} SE", se, se_mon)
    walls.append((f"{SE_GRID[0]}x{SE_GRID[1]} SE print_wattmeter_data",
                  se_mon.wattmeter.number, seconds))
    print(f"phase 19 tables: pegase balance columns max |.| {balance!r} "
          f"p.u., Flow Solution vs flow_values on the CPU {flow_err!r} of "
          f"the row, SE Residual column (noiseless set, max |r| {top!r}) vs "
          f"se_fill_ref on the CPU {res_err!r} of max(1, |mean|); host s: "
          + ", ".join(f"{name} ({count} rows) {s!r}"
                      for name, count, s in walls))


def trace_run(nr):
    """Phase 3's 10k NR re-solved from its start, with and without a
    device trace around it: the trace must name the annotation and hold
    one K1 kernel event a launch. Returns its K1 launches."""
    set_initial_point(nr)
    t_plain, _ = wall_s(lambda: power_flow(nr))
    set_initial_point(nr)
    k1.nr_fill.launches = 0
    logdir = Path(__file__).resolve().parent / "build" / "phase19_trace"
    t0 = time.perf_counter()
    with trace(str(logdir)) as path:
        with annotate("phase19 power_flow"):
            t_traced, _ = wall_s(lambda: power_flow(nr))
    t_block = time.perf_counter() - t0
    launches = k1.nr_fill.launches
    t0 = time.perf_counter()
    events = json.loads(Path(path).read_text())["traceEvents"]
    t_read = time.perf_counter() - t0
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1_events = sum("nr_fill_kernel" in e.get("name", "") for e in kernels)
    named = any(e.get("name") == "phase19 power_flow" for e in events)
    check(nr.method.converged and named
          and k1_events == launches == nr.method.iteration + 1,
          f"trace: annotation found {named}, {k1_events} K1 kernel events "
          f"for {launches} launches ({nr.method.iteration} iterations)")
    print(f"phase 19 trace of the 10k NR power_flow: {len(events)} events, "
          f"{len(kernels)} kernels, {k1_events} K1 kernel events = "
          f"{launches} launches ({nr.method.iteration} iterations + 1), "
          f"annotation present; power_flow wall {t_plain!r} s without the "
          f"trace, {t_traced!r} s inside it; the trace block with its stop, "
          f"check and export {t_block!r} s ({Path(path).stat().st_size} "
          f"bytes), reading it back {t_read!r} s")
    return launches


def phase19(nr, se, se_mon, dc_10k, pegase):
    """The product surface: ``entry()``; live edits at full size (10k NR,
    the 1,369-bus SE), reused against fresh; the report tables of phases
    3, 6, 16 and 17's analyses; a device trace of phase 3's solve. Returns
    the K1 launches of the entry step, the edits and the trace, and the
    launches of K3's entry mode and K8 of the SE edits.
    ``checkpointed_map`` is not run: it writes HDF5, and the card's
    machine has no h5py."""
    walls = [time.perf_counter()]
    launches = entry_check()
    walls.append(time.perf_counter())
    tables(nr, se, se_mon, dc_10k, pegase)
    walls.append(time.perf_counter())
    launches += nr_edits()
    walls.append(time.perf_counter())
    se_counts = se_edits()
    walls.append(time.perf_counter())
    launches += trace_run(nr)
    walls.append(time.perf_counter())
    print("phase 19 split (s): " + ", ".join(
        f"{name} {b - a!r}" for name, a, b in zip(
            ("entry", "tables", "10k NR edits", "SE edits", "trace"),
            walls, walls[1:])))
    return launches, se_counts


# ---- phase 20: the mesh path, ranks that share the card ---------------------

#: the kernels a rank of phase 20 counts
MESH_KERNELS = {"K1": k1.nr_fill, "K2": k2.fleet_lu_solve,
                "K2c": k2.fleet_cholesky_solve, "K3": k3.se_fill,
                "K3e": k3.se_fill_entries, "K5": k5.schur_gather,
                "K7": k7.kkt_fill, "K8": k8.gain_fill}


def mesh_path(fn):
    """``fn()`` once on this rank with the kernels' counts at 0 and the peak
    memory reset: ``(result, wall s, launches, peak GB)``."""
    for kernel in MESH_KERNELS.values():
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    wall, out = wall_s(fn)
    launches = {name: kernel.launches
                for name, kernel in MESH_KERNELS.items()}
    return out, wall, launches, torch.cuda.max_memory_allocated() / 1e9


def cpu_all(values):
    return [v.cpu() for v in values]


def dc_schur_system(blocks):
    """The slack-masked DC nodal matrix of the 10k grid (scipy CSR), its
    injections and its BFS partition into ``blocks`` blocks."""
    from scipy import sparse
    system = synthetic_grid(*GRID)
    dc_model(system)
    n = system.bus.number
    nodal = system.model.dc.nodal.tocsr()
    m = np.ones(n)
    m[system.bus.layout.slack] = 0.0
    a = (sparse.diags(m) @ nodal @ sparse.diags(m)
         + sparse.diags(1.0 - m)).tocsr()
    rhs = (system.bus.supply.active.array[:n]
           - system.bus.demand.active.array[:n]) * m
    adj = nodal.copy()
    adj.eliminate_zeros()
    return a, rhs, *bbd_partition(adj, blocks)


def mesh_opf(blocks, mesh=None):
    """The 10k AC OPF through ``solve_opf`` (what ``power_flow`` calls) with
    ``kkt_blocks=blocks`` and, with ``mesh``, its KKT over the mesh, then
    the power post-processing; and one step's dx through the solve's
    cached KKT at a seeded point. A warm-up solve of MESH_WARM_ITER
    iterations on an analysis of its own comes first, so that the timed
    solve holds none of the process's first-use costs. Returns the results
    on the CPU and the timed solve's analysis."""
    warm = ac_optimal_power_flow(synthetic_grid(*KKT_GRID, opf=True),
                                 device="cuda")
    solve_opf(warm, kkt_blocks=blocks, kkt_mesh=mesh,
              max_iter=MESH_WARM_ITER)
    del warm
    torch.cuda.empty_cache()
    system = synthetic_grid(*KKT_GRID, opf=True)
    analysis = ac_optimal_power_flow(system, device="cuda")

    def solve():
        solve_opf(analysis, kkt_blocks=blocks, kkt_mesh=mesh)
        ac_post.power(analysis)

    with device_stages() as split:
        _, wall, launches, peak = mesh_path(solve)
    res = analysis.method.result
    kkt = analysis._kkt_cache[2]
    spec = analysis._spec
    point = step_point(spec, system, np.random.default_rng(MESH_SEED))
    dx = step_dx(spec, point, kkt).cpu()
    feasible = ac_feasibility(system, analysis)[:5]
    return {"x": res.x, "y": res.y, "z": res.z, "s": res.s,
            "objective": res.objective, "status": res.status,
            "iterations": res.iterations, "vm": analysis.voltage.magnitude,
            "va": analysis.voltage.angle, "dx": dx, "feasible": feasible,
            "wall": wall, "launches": launches, "peak": peak,
            "split": dict(split), "layout": kkt_layout(kkt)}, analysis


def mesh_kernels(analysis):
    """Phase 20's kernels at the shapes its ranks give them, against their
    plain versions, before the ranks launch: K7 in the single process's
    tables of the 10k AC OPF at k = 4 and in each rank's (its one block
    and ``a_bb``: ``kkt_fill_table(kkt, block=r)``); K5 on each block's
    own route, no base and sign -1, as ``bbd_solve_local_sharded`` calls
    it. Returns the worst abs errors of K7 and K5."""
    kkt = analysis._kkt_cache[2]
    spec = analysis._spec
    point = k7_point(spec, spec.start(analysis.system),
                     np.random.default_rng(MESH_SEED))
    k7_err, rel = compare_k7(f"phase 20 10k AC OPF k={kkt.k}", kkt, point)
    print(f"phase 20 10k AC OPF k={kkt.k} ({kkt_layout(kkt)}): K7 vs "
          f"kkt_fill_ref max abs diff {k7_err!r}, max rel diff {rel!r} of "
          f"the row")
    k7_times(f"10k AC OPF k={kkt.k}", kkt, point, phase=20)
    whole_gb, buffer_gb = (
        8 * sum(k7._block_sizes(k, kkt.ni, kkt.mb, kkt.mbl)) / 1e9
        for k in (kkt.k, 1))
    k5_err = 0.0
    for r in range(kkt.k):
        host = k7.kkt_fill_table(kkt, block=r)
        k7.check_route(host, kkt)
        table = k7.kkt_fill_table_tensors(host, kkt, "cuda")
        label = f"10k AC OPF k={kkt.k} rank {r}'s block"
        err, rel = compare_k7(f"phase 20 {label}", kkt, point, table)
        k7_err = max(k7_err, err)
        print(f"phase 20 {label} ({host['size']['n_dest']} block elements "
              f"written, a {buffer_gb!r} GB buffer against "
              f"{whole_gb!r} GB): K7 vs kkt_fill_ref max abs diff {err!r}, "
              f"max rel diff {rel!r} of the row")
        if r == 0:
            k7_times(label, kkt, point, table, phase=20)
        del table
        route = k5.schur_route(kkt.bsel[r:r + 1], kkt.mb, "cuda")
        k5_err = max(k5_err, compare_k5(
            f"10k AC OPF k={kkt.k} block {r}", route, base=False, phase=20,
            sign=-1.0)[0])
    torch.cuda.empty_cache()
    return k7_err, k5_err


def mesh_fleets_rank(mesh):
    """A phase-20 rank of the NCCL world of one: the case118 NR fleet
    through ``sharded_nr_solve``."""
    arr, inputs = nr_fleet_inputs()
    sharded_nr_solve(mesh, arr, *inputs)              # warm-up
    out, wall, launches, peak = mesh_path(
        lambda: sharded_nr_solve(mesh, arr, *inputs))
    return {"nr": cpu_all(out), "wall": wall, "launches": launches,
            "peak": peak}


def mesh_rank(mesh, blocks):
    """A phase-20 rank of the gloo mesh: the case118 NR and SE fleets
    through ``sharded_nr_solve``/``sharded_se_solve`` and the 10k DC Schur
    solve through ``bbd_solve_sharded`` (each after a warm-up call), and
    the 10k AC OPF with its KKT over the block mesh (after a short
    warm-up solve). Each path runs with the kernels' counts at 0 and its
    wall and peak memory taken."""
    out = {}
    arr, inputs = nr_fleet_inputs()
    sharded_nr_solve(mesh, arr, *inputs)
    res, *rest = mesh_path(lambda: sharded_nr_solve(mesh, arr, *inputs))
    out["nr"] = (cpu_all(res), *rest)
    del arr, inputs
    se_args = fleet_inputs(power_system(str(DATA / "case118.m")), SE_FLEET,
                           SE_FLEET)
    sharded_se_solve(mesh, *se_args)
    res, *rest = mesh_path(lambda: sharded_se_solve(mesh, *se_args))
    out["se"] = (cpu_all(res), *rest)
    del se_args
    bmesh = mesh.renamed("block")
    a, rhs, block_of, border = dc_schur_system(blocks)
    bbd = build_bbd_arrays(a, block_of, border, device="cuda")
    rhs_t = torch.as_tensor(rhs, device="cuda")
    bbd_solve_sharded(bmesh, bbd, rhs_t)
    res, *rest = mesh_path(lambda: bbd_solve_sharded(bmesh, bbd, rhs_t))
    out["schur"] = (res.cpu(), *rest)
    del bbd
    torch.cuda.empty_cache()
    out["opf"], _ = mesh_opf(blocks, bmesh)
    return out


def same_bits(label, values):
    """Every rank's results equal bit for bit."""
    def flat(v):
        if isinstance(v, dict):
            return [x for key in sorted(v) for x in flat(v[key])]
        if isinstance(v, (list, tuple)):
            return [x for item in v for x in flat(item)]
        if isinstance(v, (torch.Tensor, np.ndarray)):
            a = np.asarray(v)
            return [(a.dtype.str, a.shape, a.tobytes())]
        return [v]
    first = flat(values[0])
    check(all(flat(v) == first for v in values[1:]),
          f"{label}: the ranks' results differ in their bits")


def fleet_gate(label, got, want):
    """Sharded against single-process: counts equal, states within
    MESH_STATE_TOL."""
    check(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
          and bool(got[3].all()),
          f"{label}: iteration counts or flags differ from the "
          "single-process run")
    diff = max((got[0] - want[0]).abs().max().item(),
               (got[1] - want[1]).abs().max().item())
    check(diff <= MESH_STATE_TOL, f"{label}: states {diff:.3e} off the "
          "single-process run")
    return diff


def phase20(ranks=MESH_RANKS):
    """The mesh path (``parallel/mesh.py``) on the card, every rank a
    process of its own: (a) a world of one over NCCL runs
    ``sharded_nr_solve`` on phase 4's fleet, which must give the
    single-process run's bits and counts; (b) ``ranks`` gloo ranks that
    share the card run the case118 NR and SE fleets, ``bbd_solve_sharded``
    on the 10k grid's DC matrix at a block a rank and the 10k AC OPF with
    ``kkt_blocks=ranks`` and its KKT over the block mesh, each against its
    single-process twin in this process. K7 and K5 are first held to their
    plain versions at the shapes the ranks give them (``mesh_kernels``).
    Every rank's results must have the same bits. Prints the walls, the
    all-reduce stage's ms an iteration and each rank's peak memory, all
    of ranks that share one card. Returns the ranks' K1, K2 (LU, "K2";
    Cholesky, "K2c"), K3, K3's entry mode ("K3e"), K5, K7 and K8 launches
    and the worst K7 and K5 abs
    errors."""
    totals = dict.fromkeys(MESH_KERNELS, 0)

    def count(launches):
        for name, n in launches.items():
            totals[name] += n

    # single-process twins, in this process
    arr, inputs = nr_fleet_inputs()
    batched_nr_solve(arr, *inputs)
    nr_wall, nr_ref = wall_s(lambda: batched_nr_solve(arr, *inputs))
    nr_ref = cpu_all(nr_ref)
    se_args = fleet_inputs(power_system(str(DATA / "case118.m")), SE_FLEET,
                           SE_FLEET)
    batched_se_solve(*se_args)
    se_wall, se_ref = wall_s(lambda: batched_se_solve(*se_args))
    se_ref = cpu_all(se_ref)
    a, rhs, block_of, border = dc_schur_system(ranks)
    bbd = build_bbd_arrays(a, block_of, border, device="cuda")
    rhs_t = torch.as_tensor(rhs, device="cuda")
    bbd_solve(bbd, rhs_t)
    schur_wall, x_ref = wall_s(lambda: bbd_solve(bbd, rhs_t))
    x_ref = x_ref.cpu()
    del arr, inputs, se_args, bbd
    opf_ref, analysis = mesh_opf(ranks)
    errs = mesh_kernels(analysis)
    del analysis
    torch.cuda.empty_cache()

    # (a) a world of one over NCCL
    (one,) = launch(mesh_fleets_rank, 1, backend="nccl", device="cuda",
                    timeout=MESH_TIMEOUT)
    same_bits("phase 20 NCCL world of one vs the single-process fleet",
              [one["nr"], nr_ref])
    check(torch.equal(one["nr"][2], nr_ref[2]),
          "phase 20 world of one: iteration counts differ")
    count(one["launches"])
    print(f"phase 20 (a) nccl world of one: sharded_nr_solve case118 "
          f"x{FLEET} the single-process run's bits and counts "
          f"({int(one['nr'][2].sum())} NR iterations); wall "
          f"{one['wall']!r} s (single process {nr_wall!r} s); K1 launches "
          f"{one['launches']['K1']}; peak {one['peak']!r} GB")

    # (b) gloo ranks that share the card
    t0 = time.perf_counter()
    outs = launch(mesh_rank, ranks, backend="gloo", device="cuda",
                  args=(ranks,), timeout=MESH_TIMEOUT)
    launch_wall = time.perf_counter() - t0
    for name in ("nr", "se", "schur"):
        same_bits(f"phase 20 {name}", [o[name][0] for o in outs])
    same_bits("phase 20 AC OPF", [
        {k: o["opf"][k] for k in ("x", "y", "z", "s", "objective", "status",
                                  "iterations", "vm", "va", "dx")}
        for o in outs])
    for o in outs:
        for name in ("nr", "se", "schur"):
            count(o[name][2])
        count(o["opf"]["launches"])
    check(one["launches"]["K1"] and one["launches"]["K2"] and all(
        o["nr"][2]["K1"] and o["nr"][2]["K2"] and o["se"][2]["K3e"]
        and o["se"][2]["K8"] and o["se"][2]["K2c"]
        and o["opf"]["launches"]["K5"] and o["opf"]["launches"]["K7"]
        for o in outs),
        "phase 20: a rank launched no K1, K2, K3, K5, K7 or K8 on its path")

    def walls(name):
        return ", ".join(f"{o[name][1]!r}" for o in outs)

    def peaks(name):
        return ", ".join(f"{o[name][3]!r}" for o in outs)

    d_nr = fleet_gate("phase 20 NR fleet", outs[0]["nr"][0], nr_ref)
    d_se = fleet_gate("phase 20 SE fleet", outs[0]["se"][0], se_ref)
    x = outs[0]["schur"][0]
    d_x = (x - x_ref).abs().max().item()
    resid = float(np.abs(a @ x.numpy() - rhs).max())
    check(d_x <= MESH_SCHUR_TOL and resid <= MESH_SCHUR_RES,
          f"phase 20 Schur solve: {d_x:.3e} off bbd_solve, residual "
          f"{resid:.3e}")
    print(f"phase 20 (b) {ranks} gloo ranks sharing one card (launch "
          f"{launch_wall!r} s): NR fleet x{FLEET} states vs the single "
          f"process {d_nr!r}, same counts; walls {walls('nr')} s (single "
          f"process {nr_wall!r} s); K1 launches "
          f"{[o['nr'][2]['K1'] for o in outs]}, K2 (LU, "
          f"{FLEET // ranks} scenarios a rank) "
          f"{[o['nr'][2]['K2'] for o in outs]}; peaks {peaks('nr')} GB")
    print(f"phase 20 (b) SE fleet x{SE_FLEET}: states vs the single "
          f"process {d_se!r}, same counts; walls {walls('se')} s (single "
          f"process {se_wall!r} s); K3 entry-mode launches "
          f"{[o['se'][2]['K3e'] for o in outs]}, K8 "
          f"{[o['se'][2]['K8'] for o in outs]}, K2 (Cholesky) "
          f"{[o['se'][2]['K2c'] for o in outs]}; peaks {peaks('se')} GB")
    print(f"phase 20 (b) bbd_solve_sharded, {GRID[0]}x{GRID[1]} DC at "
          f"{ranks} blocks (ni "
          f"{int(np.bincount(block_of[block_of >= 0]).max())}, border "
          f"{len(border)}): vs bbd_solve {d_x!r}, |A x - r| {resid!r}; "
          f"walls {walls('schur')} s (single process {schur_wall!r} s); "
          f"peaks {peaks('schur')} GB")
    mesh_opf_gate(outs, opf_ref, ranks)
    return totals, errs


def mesh_opf_gate(outs, ref, ranks):
    """Phase 20's AC OPF over the mesh against the single-process solve at
    the same block count: phase 18's BBD gates, balance and limits."""
    got = outs[0]["opf"]
    scale = max(1.0, ref["dx"].abs().max().item())
    ddx = (got["dx"] - ref["dx"]).abs().max().item() / scale
    dobj = abs(got["objective"] - ref["objective"]) / max(
        1.0, abs(ref["objective"]))
    dstate = max(np.abs(got["vm"] - ref["vm"]).max(),
                 np.abs(got["va"] - ref["va"]).max())
    balance, volt, power, flow, angle = got["feasible"]
    check(ddx <= BBD_DENSE_STEP_TOL and got["status"] == ref["status"]
          and got["status"] in ("optimal", "acceptable")
          and dobj <= BBD_DENSE_OBJ_RTOL and dstate <= BBD_DENSE_STATE_TOL
          and balance <= KKT_BALANCE_TOL
          and max(volt, power, flow, angle) <= AC_FEAS_LIMIT_TOL,
          f"phase 20 AC OPF over the mesh: step dx {ddx:.3e} of its scale, "
          f"status {got['status']} vs {ref['status']}, objective rel "
          f"{dobj:.3e}, V/θ {dstate:.3e}, balance {balance:.3e}, limits "
          f"V {volt:.3e} PQ {power:.3e} flow {flow:.3e} angle {angle:.3e}")
    it = got["iterations"]
    reduce = [o["opf"]["split"].get("all-reduce", (0, 0.0)) for o in outs]
    k5_k7 = [(o["opf"]["launches"]["K5"], o["opf"]["launches"]["K7"])
             for o in outs]
    print(f"phase 20 (b) {KKT_GRID[0]}x{KKT_GRID[1]} AC OPF, "
          f"kkt_blocks={ranks} over the {ranks}-rank block mesh "
          f"({got['layout']}): {got['status']} in {it} iterations (single "
          f"process {ref['status']} in {ref['iterations']}), objective "
          f"{got['objective']!r} rel {dobj!r}, V/θ {dstate!r}, one step's "
          f"dx {ddx!r} of its scale; balance {balance!r} p.u. (raw Y bus), "
          f"limits V {volt!r} Pg/Qg {power!r} flow {flow!r} angle "
          f"{angle!r}; walls after a {MESH_WARM_ITER}-iteration warm-up "
          f"{[o['opf']['wall'] for o in outs]} s (single process "
          f"{ref['wall']!r} s); all-reduce ms an iteration "
          f"{[ms / it for _, ms in reduce]} ({reduce[0][0]} calls); "
          f"K5/K7 launches {k5_k7} "
          f"(single process {ref['launches']['K5']}/{ref['launches']['K7']});"
          f" peaks {[o['opf']['peak'] for o in outs]} GB (single process "
          f"{ref['peak']!r} GB)")
    print(f"phase 20 (b) AC OPF rank 0 per iteration (CUDA events, ranks "
          f"sharing one card): {stage_ms(got['split'], it)}")
    print(f"phase 20 single-process AC OPF per iteration (CUDA events): "
          f"{stage_ms(ref['split'], ref['iterations'])}")


def activsg10k_acopf(max_seconds=300.0, verbose=1):
    """The AC OPF of the real ACTIVSg10k grid on the card, which ``main``
    does not run (it stops short of acceptable; see PERF.md). Run it from
    the root of a checkout with

        python3 -c 'import chip_smoke; chip_smoke.activsg10k_acopf(300)'

    It solves ``ac_optimal_power_flow`` with ``kkt_blocks`` unset, which
    sends the 10,000 buses to the structured (BBD) KKT, within
    ``max_seconds`` of the interior point (its n_x is above 8,192, so it
    runs without restoration, as the JAX package's does), and prints the
    status, the exit that ended the loop (``IpmResult.stop``), iterations,
    final KKT error and objective, the KKT layout and host build, the ms an
    iteration by stage (CUDA events), the peak device memory, and the end
    point's worst bus balance (raw Y bus) and limit violations. Then it
    solves the same input again from a fresh build and fails unless the
    two take the same iterations to the same bits. ``verbose`` is the
    interior point's (3: every iteration's step lengths and KKT split)."""
    if not torch.cuda.is_available():
        raise SmokeFailure("no card: this run measures the card")
    results = []
    for run in (1, 2):
        system = power_system(str(DATA / OPF_10K))
        build, analysis = wall_s(lambda: ac_optimal_power_flow(
            system, device="cuda"))
        spec = analysis._spec
        print(f"ACTIVSg10k AC OPF, solve {run}: n {spec.n}, n_x {spec.n_x}, "
              f"m_E {spec.m_e}, m_I {spec.m_i}, KKT order "
              f"{spec.n_x + spec.m_e}, {len(spec.flows)} flow rows, "
              f"{len(spec.angles)} angle rows; ac_optimal_power_flow "
              f"{build!r} s", flush=True)
        torch.cuda.reset_peak_memory_stats()
        with device_stages() as split:
            wall, _ = wall_s(lambda: ac_mod.solve(
                analysis, max_seconds=max_seconds, verbose=verbose))
        res = analysis.method.result
        kkt = analysis._kkt_cache[2]
        print(f"ACTIVSg10k KKT layout: {kkt_layout(kkt)}; host build "
              f"{kkt.build_s!r} s")
        print(f"ACTIVSg10k solve {run}: status {res.status}, ended by "
              f"{res.stop!r}, {res.iterations} iterations, KKT error "
              f"{res.kkt_error!r}, objective {res.objective!r}, solve "
              f"{wall!r} s (max_seconds {max_seconds}); peak "
              f"{torch.cuda.max_memory_allocated() / 1e9!r} GB; per "
              f"iteration (CUDA events): {stage_ms(split, res.iterations)}")
        balance, volt, power, flow, angle, n_flow = ac_feasibility(
            system, analysis)
        print(f"ACTIVSg10k end point: worst balance {balance!r} p.u. (raw Y "
              f"bus), limits: V {volt!r}, Pg/Qg {power!r}, flow {flow!r} "
              f"({n_flow} limited ends), angle {angle!r}", flush=True)
        results.append((res, wall))
        del analysis, kkt
    same_trajectory("ACTIVSg10k AC OPF", results[0][0], results[1][0],
                    results[0][1], results[1][1])


def kernel_entry(name, replaces, launches, err, times, source=None,
                 library_ms=None):
    """One entry of the kernels line; ``rel_err`` is the worst relative
    error against the plain version in the measure the kernel's gate uses
    (``note_rel``): of max(1, |plain|) for K1, K3, K4 and K5 and their
    routed modes, of the row's largest for K6 and K7, of the scenario's
    max|x| for K2."""
    ms, plain_ms, (bound_ms, bound_by) = times
    return {"name": name, "route": "cuda",
            "source": f"juliagrid_tpu_torch/kernels/csrc/{source or name}.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "rel_err": REL_ERR[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def main():
    t0 = time.perf_counter()
    walls = {}

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        walls[phase.__name__] = time.perf_counter() - t
        return out

    card = timed(phase0)
    k1_err, *k1_times = timed(phase1)
    timed(phase2)
    k1_launches, dense_10k = timed(phase3)
    k2_lu_launches, k2_lu_err, (k2_lu_times, k2_lu_library) = timed(phase4)
    k3_err, k3_times = timed(phase5)
    (k3e_err, k3e_times), (k8_err, (k8_times, k8_dense)) = timed(phase5b)
    # the launches of K3 (dense), K3's entry mode and K8 on the main paths
    se_counts, se_1369, mon_1369 = timed(phase6)
    counts, k2_ch_err, (k2_ch_times, k2_ch_library) = timed(phase7)
    k2_ch_launches = counts.pop("K2c")
    se_counts += counts
    k4_err, k4_times = timed(phase8)
    k4_launches = timed(phase9)
    timed(phase10)
    se_counts["K8"] += timed(phase11)
    counts, k2_lnr = timed(phase12)
    se_counts += counts
    k2_ch_launches += k2_lnr
    (k1r_err, *k1r_times), (k5_err, *k5_times) = timed(phase13)
    k5_library_ms = k5_times.pop()
    nr_bbd, (k1r_launches, k5_launches) = timed(phase14, dense_10k)
    (k3r_err, *k3r_times), (k3r_launches, k5_se), k5_se_err = timed(
        phase15, nr_bbd)
    k5_launches += k5_se
    k5_err = max(k5_err, k5_se_err)
    k3_lav, dc_10k = timed(phase16)
    se_counts["K3"] += k3_lav
    k6_err, k6_times, k6_launches, pegase = timed(phase17)
    k7_err, k7_times, k7_launches, k5_kkt = timed(phase18)
    k5_launches += k5_kkt
    k1_surface, counts = timed(phase19, dense_10k, se_1369, mon_1369,
                               dc_10k, pegase)
    k1_launches += k1_surface
    se_counts += counts
    mesh, (k7_mesh_err, k5_mesh_err) = timed(phase20)
    k7_err = max(k7_err, k7_mesh_err)
    k5_err = max(k5_err, k5_mesh_err)
    k1_launches += mesh["K1"]
    k2_lu_launches += mesh["K2"]
    k2_ch_launches += mesh["K2c"]
    for name in ("K3", "K3e", "K8"):
        se_counts[name] += mesh[name]
    k5_launches += mesh["K5"]
    k7_launches += mesh["K7"]
    print("phase walls: " + ", ".join(f"{name} {seconds!r} s"
                                      for name, seconds in walls.items())
          + f"; whole run wall {time.perf_counter() - t0!r} s")
    print(card)
    # no single PyTorch call computes K1's, K3's, K4's, K6's or K7's
    # function, or the routed and entry modes': library_ms is null; K5's is
    # one index_put_, K2's one torch.linalg.solve_ex of the same systems
    # (its plain version is the two-call library route it replaced), K8's
    # the dense route's gain it replaced (the W½ scaling, rhs and one f64
    # GEMM over K3's dense H) at case118 x1024, where K8's times are. K6's times
    # are those of one Jacobian and one Hessian launch, the pair an
    # interior-point iteration takes; K7's those of one call (two memsets,
    # two launches) at the 10k cell; K2's those of case118 x1024. No TPU
    # kernel computed K2's function: "replaces" names the JAX package's
    # per-scenario solves (an f32 LU refined in f64, and the SE gain's f32
    # LU)
    print(json.dumps({"kernels": [
        kernel_entry("nr_fill", "juliagrid_tpu/powerflow/ac.py:92",
                     k1_launches, k1_err, k1_times),
        kernel_entry("fleet_lu_solve", "juliagrid_tpu/ops/linalg.py:147",
                     k2_lu_launches, k2_lu_err, k2_lu_times,
                     source="fleet_solve", library_ms=k2_lu_library),
        kernel_entry("fleet_cholesky_solve",
                     "juliagrid_tpu/estimation/acse.py:671", k2_ch_launches,
                     k2_ch_err, k2_ch_times, source="fleet_solve",
                     library_ms=k2_ch_library),
        kernel_entry("se_fill", "juliagrid_tpu/estimation/acse.py:463",
                     se_counts["K3"], k3_err, k3_times),
        kernel_entry("se_fill_entries",
                     "juliagrid_tpu/estimation/acse.py:642",
                     se_counts["K3e"], k3e_err, k3e_times, source="se_fill"),
        kernel_entry("gain_fill", "juliagrid_tpu/estimation/acse.py:658",
                     se_counts["K8"], k8_err, k8_times,
                     library_ms=k8_dense),
        kernel_entry("gs_sweep", "juliagrid_tpu/powerflow/gauss_seidel.py:97",
                     k4_launches, k4_err, k4_times),
        kernel_entry("nr_fill_routed",
                     "juliagrid_tpu/powerflow/newton_bbd.py:253",
                     k1r_launches, k1r_err, k1r_times, source="nr_fill"),
        kernel_entry("se_fill_routed",
                     "juliagrid_tpu/estimation/acse_bbd.py:286",
                     k3r_launches, k3r_err, k3r_times, source="se_fill"),
        kernel_entry("schur_gather",
                     "juliagrid_tpu/powerflow/newton_bbd.py:341",
                     k5_launches, k5_err, k5_times,
                     library_ms=k5_library_ms),
        kernel_entry("opf_fill", "juliagrid_tpu/opf/acopf.py:693",
                     k6_launches, k6_err, k6_times),
        kernel_entry("kkt_fill", "juliagrid_tpu/opf/kkt_bbd.py:335",
                     k7_launches, k7_err, k7_times)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
