"""State estimation subpackage: Gauss-Newton WLS AC state estimation (the
PMU, DC and LAV estimators, bad data and observability are not ported
yet)."""

from .acse import gauss_newton, increment, solve, state_estimation
