"""juliagrid_tpu_torch — the PyTorch/CUDA port of juliagrid_tpu.

The same snake_case API as the JAX package, on PyTorch tensors in float64,
for an NVIDIA H100. The Newton-Raphson AC power flow runs through a
hand-written CUDA kernel (``kernels/csrc/nr_fill.cu``) for the injections,
mismatch and Jacobian fill, and ``torch.linalg`` for the f64 solve; the
fast decoupled power flow through the same kernel and two f64 LU factors
made once; the Gauss-Seidel power flow through a third
(``kernels/csrc/gs_sweep.cu``), which runs a whole solve in one launch; the
DC power flow through one f64 solve. The Gauss-Newton WLS AC state
estimation runs through a fourth (``kernels/csrc/se_fill.cu``) for the
measurement functions and Jacobian, then an f64 gain matmul and Cholesky;
the linear DC and PMU estimators through one f64 gain matmul and solve;
bad-data processing through the same kernel and a dense f64 projection (or
the host Takahashi path at scale). Single large grids take the
bordered-block-diagonal path (``newton_raphson_bbd``,
``fast_newton_raphson_bbd``, ``gauss_newton_bbd``): K1 and K3 write
straight into the blocks of a partition, the interiors factor in one
batched f64 LU, and a fifth kernel (``kernels/csrc/schur_gather.cu``)
gathers the border system. The in-house interior point (``opf/ipm.py``,
an f64 LU of the KKT system) solves the DC optimal power flow (derivatives
scattered from its constant data), the AC optimal power flow (Jacobians and
Lagrangian Hessian from a sixth kernel, ``kernels/csrc/opf_fill.cu``) and
the LAV estimators (the AC kind through K3, its Hessian from
``torch.func``). The
numpy host layer (parsers, data
model, measurements, post-processing, observability and PMU placement) is a
copy of the JAX package's, so the port imports no JAX.

Analyses run on ``config.device`` (``"cuda"`` by default); pass
``device="cpu"`` to run on the CPU, where each kernel's plain PyTorch
version takes its place.
"""

from .config import config, default_config, set_config
from .units import units

# power-system data layer
from .system.load import power_system
from .system.model import ac_model, dc_model

# measurement layer
from .measurement.load import ems, measurement
from .measurement.devices import (add_ammeter, add_pmu, add_varmeter,
                                  add_voltmeter, add_wattmeter,
                                  update_ammeter, update_pmu,
                                  update_varmeter, update_voltmeter,
                                  update_wattmeter)
from .measurement.configuration import (status, status_ammeter, status_pmu,
                                        status_varmeter, status_voltmeter,
                                        status_wattmeter)
from .measurement.hdf5io import save_measurement

# power flow
from .powerflow.ac import mismatch, newton_raphson, set_initial_point, solve
from .powerflow.fast_decoupled import (fast_newton_raphson_bx,
                                       fast_newton_raphson_xb)
from .powerflow.gauss_seidel import gauss_seidel
from .powerflow.newton_bbd import newton_raphson_bbd, power_flow_bbd
from .powerflow.dc import dc_power_flow
from .powerflow.driver import power_flow
from .powerflow.limits import adjust_angle, reactive_limit

# optimal power flow
from .opf import (ac_optimal_power_flow, dc_optimal_power_flow,
                  solve_opf)
from .system.builders import cost

# state estimation
from .estimation.acse import gauss_newton, increment, state_estimation
from .estimation.dcse import dc_state_estimation
from .estimation.pmuse import pmu_state_estimation
from .estimation.lav import (ac_lav_state_estimation, dc_lav_state_estimation,
                             pmu_lav_state_estimation)
from .estimation.baddata import chi_test, lnr_removal, residual_test
from .estimation.observability import (island_topological,
                                       island_topological_flow,
                                       pmu_placement, pmu_placement_apply,
                                       restoration_gram)

# postprocessing
from .postprocessing import ac as ac_post
from .postprocessing import dc as dc_post

__version__ = "0.1.0"
