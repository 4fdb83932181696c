"""State estimation subpackage: Gauss-Newton WLS AC (dense and BBD), DC and
PMU state estimation, the three LAV estimators, bad data and
observability."""

from .acse import gauss_newton, increment, solve, state_estimation
from .acse_bbd import gauss_newton_bbd, se_bbd_solve
from .dcse import dc_state_estimation
from .pmuse import pmu_state_estimation
from .lav import (ac_lav_state_estimation, dc_lav_state_estimation,
                  pmu_lav_state_estimation)
from .baddata import chi_test, lnr_removal, residual_test
from .observability import (island_topological, island_topological_flow,
                            pmu_placement, pmu_placement_apply,
                            restoration_gram)
