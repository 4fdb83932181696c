"""Closed-form AC quantity library on PyTorch tensors.

Port of ``juliagrid_tpu/ops/equations.py``, itself a port of JuliaGrid
src/backend/equations.jl: the analytic expressions and partial derivatives
behind AC state estimation, mapped over arrays of branch/bus indices
instead of single elements. A branch "coefficient" is the reference's
``PiModel`` 4-tuple (A, B, C, D) packed as arrays; the state enters as
gathered (Vi, Vj, θi, θj). The coefficient functions and the PMU error
propagation run on the host in numpy; the ``eval_*`` functions are the
plain PyTorch versions of what kernel K3 (``kernels/se_fill.py``)
computes per measurement row.

All 21 AC-SE measurement row types (acStateEstimation.jl:131-236) evaluate
through these functions; group semantics:

  type  1: voltmeter V          12/13: PMU polar bus V/θ
  2/3: ammeter Iij/Iji           14/15: PMU polar current angle ψij/ψji
  4/5: squared Iij²/Iji²         16/17: PMU rect bus ReV/ImV
  6/9: injections Pi/Qi          18/19: PMU rect ReIij/ReIji
  7/8: flows Pij/Pji             20/21: PMU rect ImIij/ImIji
  10/11: flows Qij/Qji
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PiCoeff(NamedTuple):
    """Arrays of the reference PiModel coefficients for a branch set."""
    a: np.ndarray
    b: np.ndarray
    c: np.ndarray
    d: np.ndarray


def _branch_params(system, idx):
    prm = system.branch.parameter
    ac = system.model.ac
    g = ac.admittance[idx].real
    b = ac.admittance[idx].imag
    gsi = 0.5 * prm.conductance.array[idx]
    bsi = 0.5 * prm.susceptance.array[idx]
    tau_inv = 1.0 / prm.turns_ratio.array[idx]
    return g, b, gsi, bsi, tau_inv


# ---- coefficients (host-side, numpy) --------------------------------------

def pij_coeff(system, idx) -> PiCoeff:
    g, b, gsi, bsi, ti = _branch_params(system, idx)
    return PiCoeff(ti**2 * (g + gsi), ti * g, ti * b, np.zeros_like(g))


def pji_coeff(system, idx) -> PiCoeff:
    g, b, gsi, bsi, ti = _branch_params(system, idx)
    return PiCoeff(g + gsi, ti * g, ti * b, np.zeros_like(g))


def qij_coeff(system, idx) -> PiCoeff:
    g, b, gsi, bsi, ti = _branch_params(system, idx)
    return PiCoeff(ti**2 * (b + bsi), ti * g, ti * b, np.zeros_like(g))


def qji_coeff(system, idx) -> PiCoeff:
    g, b, gsi, bsi, ti = _branch_params(system, idx)
    return PiCoeff(b + bsi, ti * g, ti * b, np.zeros_like(g))


def iij_coeff(system, idx) -> PiCoeff:
    g, b, gsi, bsi, ti = _branch_params(system, idx)
    return PiCoeff(
        ti**4 * ((g + gsi)**2 + (b + bsi)**2),
        ti**2 * (g**2 + b**2),
        ti**3 * (g * (g + gsi) + b * (b + bsi)),
        ti**3 * (g * bsi - b * gsi))


def iji_coeff(system, idx) -> PiCoeff:
    g, b, gsi, bsi, ti = _branch_params(system, idx)
    return PiCoeff(
        ti**2 * (g**2 + b**2),
        (g + gsi)**2 + (b + bsi)**2,
        ti * (g * (g + gsi) + b * (b + bsi)),
        ti * (g * bsi - gsi * b))


def psi_ij_coeff(system, idx) -> PiCoeff:
    g, b, gsi, bsi, ti = _branch_params(system, idx)
    return PiCoeff(ti**2 * (g + gsi), ti**2 * (b + bsi), ti * g, ti * b)


def psi_ji_coeff(system, idx) -> PiCoeff:
    g, b, gsi, bsi, ti = _branch_params(system, idx)
    return PiCoeff(g + gsi, b + bsi, ti * g, ti * b)


# ---- evaluation (torch, elementwise; the state may carry a leading scenario
# axis that broadcasts against the per-row coefficients); each returns
# (h, dθi, dθj, dVi, dVj) --------------------------------------------------

def eval_pij(c, vi, vj, ti, tj):
    th = ti - tj
    st, ct = torch.sin(th), torch.cos(th)
    bc = c.b * ct + c.c * st
    h = c.a * vi**2 - bc * vi * vj
    dti = (c.b * st - c.c * ct) * vi * vj
    return h, dti, -dti, 2 * c.a * vi - bc * vj, -bc * vi


def eval_pji(c, vi, vj, ti, tj):
    th = ti - tj
    st, ct = torch.sin(th), torch.cos(th)
    bc = c.b * ct - c.c * st
    h = c.a * vj**2 - bc * vi * vj
    dti = (c.b * st + c.c * ct) * vi * vj
    return h, dti, -dti, -bc * vj, 2 * c.a * vj - bc * vi


def eval_qij(c, vi, vj, ti, tj):
    th = ti - tj
    st, ct = torch.sin(th), torch.cos(th)
    sc = c.b * st - c.c * ct
    h = -c.a * vi**2 - sc * vi * vj
    dti = -(c.b * ct + c.c * st) * vi * vj
    return h, dti, -dti, -2 * c.a * vi - sc * vj, -sc * vi


def eval_qji(c, vi, vj, ti, tj):
    th = ti - tj
    st, ct = torch.sin(th), torch.cos(th)
    sc = c.b * st + c.c * ct
    h = -c.a * vj**2 + sc * vi * vj
    dti = (c.b * ct - c.c * st) * vi * vj
    return h, dti, -dti, sc * vj, -2 * c.a * vj + sc * vi


def eval_iij(c, vi, vj, ti, tj):
    th = ti - tj
    st, ct = torch.sin(th), torch.cos(th)
    cd = c.c * ct - c.d * st
    mag2 = c.a * vi**2 + c.b * vj**2 - 2 * vi * vj * cd
    inv = 1.0 / torch.sqrt(mag2)
    h = torch.sqrt(mag2)
    dti = inv * (c.c * st + c.d * ct) * vi * vj
    dvi = inv * (c.a * vi - cd * vj)
    dvj = inv * (c.b * vj - cd * vi)
    return h, dti, -dti, dvi, dvj


def eval_iji(c, vi, vj, ti, tj):
    th = ti - tj
    st, ct = torch.sin(th), torch.cos(th)
    cd = c.c * ct + c.d * st
    mag2 = c.a * vi**2 + c.b * vj**2 - 2 * vi * vj * cd
    inv = 1.0 / torch.sqrt(mag2)
    h = torch.sqrt(mag2)
    dti = inv * (c.c * st - c.d * ct) * vi * vj
    dvi = inv * (c.a * vi - cd * vj)
    dvj = inv * (c.b * vj - cd * vi)
    return h, dti, -dti, dvi, dvj


def eval_iij2(c, vi, vj, ti, tj):
    th = ti - tj
    st, ct = torch.sin(th), torch.cos(th)
    cd = c.c * ct - c.d * st
    h = c.a * vi**2 + c.b * vj**2 - 2 * vi * vj * cd
    dti = 2 * (c.c * st + c.d * ct) * vi * vj
    return h, dti, -dti, 2 * (c.a * vi - cd * vj), 2 * (c.b * vj - cd * vi)


def eval_iji2(c, vi, vj, ti, tj):
    th = ti - tj
    st, ct = torch.sin(th), torch.cos(th)
    cd = c.c * ct + c.d * st
    h = c.a * vi**2 + c.b * vj**2 - 2 * vi * vj * cd
    dti = 2 * (c.c * st - c.d * ct) * vi * vj
    return h, dti, -dti, 2 * (c.a * vi - cd * vj), 2 * (c.b * vj - cd * vi)


def eval_psi_ij(c, vi, vj, ti, tj):
    """h is the current-phasor angle; the derivatives use the squared
    coefficient set (the reference pairs psi-ij rows with IijCoefficient,
    acStateEstimation.jl normalEquation! types 14/15)."""
    sti, cti = torch.sin(ti), torch.cos(ti)
    stj, ctj = torch.sin(tj), torch.cos(tj)
    re = (c.a * cti - c.b * sti) * vi - (c.c * ctj - c.d * stj) * vj
    im = (c.a * sti + c.b * cti) * vi - (c.c * stj + c.d * ctj) * vj
    inv2 = 1.0 / (re**2 + im**2)
    h = torch.atan2(im, re)
    a_sq = c.a**2 + c.b**2
    b_sq = c.c**2 + c.d**2
    c_sq = c.a * c.c + c.b * c.d
    d_sq = c.b * c.c - c.a * c.d
    th = ti - tj
    st, ct = torch.sin(th), torch.cos(th)
    cd = c_sq * ct - d_sq * st
    dti = inv2 * (a_sq * vi**2 - cd * vi * vj)
    dtj = inv2 * (b_sq * vj**2 - cd * vi * vj)
    dvi = -inv2 * (c_sq * st + d_sq * ct) * vj
    dvj = inv2 * (c_sq * st + d_sq * ct) * vi
    return h, dti, dtj, dvi, dvj


def eval_psi_ji(c, vi, vj, ti, tj):
    """To-side current-phasor angle; derivatives via the squared
    coefficient set (reference IjiCoefficient pairing)."""
    sti, cti = torch.sin(ti), torch.cos(ti)
    stj, ctj = torch.sin(tj), torch.cos(tj)
    re = (c.a * ctj - c.b * stj) * vj - (c.c * cti - c.d * sti) * vi
    im = (c.a * stj + c.b * ctj) * vj - (c.c * sti + c.d * cti) * vi
    inv2 = 1.0 / (re**2 + im**2)
    h = torch.atan2(im, re)
    a_sq = c.c**2 + c.d**2
    b_sq = c.a**2 + c.b**2
    c_sq = c.a * c.c + c.b * c.d
    d_sq = c.b * c.c - c.a * c.d
    th = ti - tj
    st, ct = torch.sin(th), torch.cos(th)
    cd = c_sq * ct + d_sq * st
    dti = inv2 * (a_sq * vi**2 - cd * vi * vj)
    dtj = inv2 * (b_sq * vj**2 - cd * vi * vj)
    dvi = -inv2 * (c_sq * st - d_sq * ct) * vj
    dvj = inv2 * (c_sq * st - d_sq * ct) * vi
    return h, dti, dtj, dvi, dvj


def eval_re_iij(c, vi, vj, ti, tj):
    sti, cti = torch.sin(ti), torch.cos(ti)
    stj, ctj = torch.sin(tj), torch.cos(tj)
    h = (c.a * cti - c.b * sti) * vi - (c.c * ctj - c.d * stj) * vj
    dti = -(c.a * sti + c.b * cti) * vi
    dtj = (c.c * stj + c.d * ctj) * vj
    dvi = c.a * cti - c.b * sti
    dvj = -c.c * ctj + c.d * stj
    return h, dti, dtj, dvi, dvj


def eval_im_iij(c, vi, vj, ti, tj):
    sti, cti = torch.sin(ti), torch.cos(ti)
    stj, ctj = torch.sin(tj), torch.cos(tj)
    h = (c.a * sti + c.b * cti) * vi - (c.c * stj + c.d * ctj) * vj
    dti = (c.a * cti - c.b * sti) * vi
    dtj = (-c.c * ctj + c.d * stj) * vj
    dvi = c.a * sti + c.b * cti
    dvj = -c.c * stj - c.d * ctj
    return h, dti, dtj, dvi, dvj


def eval_re_iji(c, vi, vj, ti, tj):
    sti, cti = torch.sin(ti), torch.cos(ti)
    stj, ctj = torch.sin(tj), torch.cos(tj)
    h = (c.a * ctj - c.b * stj) * vj - (c.c * cti - c.d * sti) * vi
    dti = (c.c * sti + c.d * cti) * vi
    dtj = -(c.a * stj + c.b * ctj) * vj
    dvi = -c.c * cti + c.d * sti
    dvj = c.a * ctj - c.b * stj
    return h, dti, dtj, dvi, dvj


def eval_im_iji(c, vi, vj, ti, tj):
    sti, cti = torch.sin(ti), torch.cos(ti)
    stj, ctj = torch.sin(tj), torch.cos(tj)
    h = (c.a * stj + c.b * ctj) * vj - (c.c * sti + c.d * cti) * vi
    dti = (-c.c * cti + c.d * sti) * vi
    dtj = (c.a * ctj - c.b * stj) * vj
    dvi = -c.c * sti - c.d * cti
    dvj = c.a * stj + c.b * ctj
    return h, dti, dtj, dvi, dvj


# PMU rectangular error propagation (equations.jl:576-677) ------------------

def variance_pmu(var_mag, var_ang, mag_mean, cos_t, sin_t):
    var_re = var_mag * cos_t**2 + var_ang * (mag_mean * sin_t) ** 2
    var_im = var_mag * sin_t**2 + var_ang * (mag_mean * cos_t) ** 2
    return var_re, var_im


def covariance_pmu(var_mag, var_ang, mag_mean, cos_t, sin_t,
                   var_re, var_im):
    """Returns the 2x2 precision block entries (w11, w22, w_off) via the
    reference's L-factor construction (covariancePmu/precision!)."""
    l1_inv = 1.0 / np.sqrt(var_re)
    l2 = sin_t * cos_t * (var_mag - var_ang * mag_mean**2) * l1_inv
    l3_inv2 = 1.0 / (var_im - l2**2)
    off = (-l2 * l1_inv) * l3_inv2
    w11 = (l1_inv - l2 * off) * l1_inv
    w22 = l3_inv2
    return w11, w22, off


#: Branch-row groups in evaluation order: (type code, coefficient function,
#: evaluation). ``estimation/acse.py`` groups the rows and kernel K3
#: (``kernels/se_fill.py``) evaluates them by these codes.
BRANCH_GROUPS = (
    (2, iij_coeff, eval_iij),
    (3, iji_coeff, eval_iji),
    (4, iij_coeff, eval_iij2),
    (5, iji_coeff, eval_iji2),
    (7, pij_coeff, eval_pij),
    (8, pji_coeff, eval_pji),
    (10, qij_coeff, eval_qij),
    (11, qji_coeff, eval_qji),
    (14, psi_ij_coeff, eval_psi_ij),
    (15, psi_ji_coeff, eval_psi_ji),
    (18, psi_ij_coeff, eval_re_iij),
    (19, psi_ji_coeff, eval_re_iji),
    (20, psi_ij_coeff, eval_im_iij),
    (21, psi_ji_coeff, eval_im_iji),
)
