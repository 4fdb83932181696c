"""Primal-dual interior-point method for NLP/QP/LP, on PyTorch tensors.

Port of ``juliagrid_tpu/opf/ipm.py``, the framework's own optimizer (the
component the reference delegates to Ipopt/HiGHS through JuMP). It solves

    min f(x)   s.t.  c_E(x) = 0,   c_I(x) >= 0

with slacks s > 0 on the inequalities and a log-barrier, following the
Ipopt algorithm (Wächter & Biegler, Math. Prog. 106, 2006): damped Newton
on the primal-dual system condensed to the augmented form

      [ W + J_Iᵀ Σ J_I + δI   J_Eᵀ ] [ dx ]   [ -r_d ]
      [ J_E                  -δc I ] [ -dy ] = [ -c_E ],      Σ = Z S⁻¹,

a filter line search on (θ, φ) with second-order corrections, the
monotone Fiacco-McCormick barrier with superlinear decrease, inertia-free
regularization, and a Levenberg-Marquardt feasibility restoration. The host
logic of ``solve_nlp`` is the JAX package's line for line, with one step
added at the end: a point that stops at the acceptable level is polished
onto the equality constraints (Gauss-Newton) and its duals refitted, so
that it satisfies c_E(x) = 0 to rounding rather than to the acceptable
tolerance.

Derivatives come from ``torch.func``: ``grad`` for the objective,
``jacfwd`` for the constraint Jacobians and the Lagrangian Hessian up to
``_CHUNK_THRESHOLD`` variables, and above it blocks of ``_CHUNK_BLOCK``
basis tangents pushed through ``vmap(jvp)`` (``jacfwd`` takes no chunk
size). Analytic ``jac_eq``/``jac_ineq``/``hess`` replace them where a
problem gives them. The augmented system is Jacobi-equilibrated and
factored by an f64 LU (cuSOLVER getrf on the card) from the first
iteration: the JAX package's f32 factor with refinement, its precision-wall
switch to an f64 LDLᵀ and its jit engine cache are TPU machinery and are
not ported. A singular system factors without raising (``check=False``),
so its step comes back non-finite and the loop escalates δ.

A problem with a structured KKT (``NlpProblem.kkt``: the AC OPF's BBD KKT,
``opf/kkt_bbd.py``, from 4,000 buses) takes the JAX package's structured
step instead: the right-hand side from vector-Jacobian products, the
system assembled and solved in bordered-block-diagonal form by the KKT
object, ds from a Jacobian-vector product, and the gradient-based scaling
from its closed-form row maxima. No (m, n_x) or (n_x, n_x) matrix is
formed on that path, apart from the restoration and the dual recovery,
which the caps below (``resto_ok``, ``recovery_ok``) keep to small
problems.

Problem callables take ``x`` of shape ``[..., n_x]`` and return
``[..., m]`` (the objective ``[...]``): the line search evaluates every
backtracking step length in one batched call. Each iteration reads the
device back once per step, metrics call and probe batch. The step's stages
are ``utils.profiling.mark``ed, so ``device_stages`` splits an iteration on
the card.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import grad, jacfwd, jvp, vjp, vmap

from ..config import resolve_device
from ..ops import linalg
from ..utils.profiling import mark

# Wächter-Biegler constants (their Table 1 defaults)
KAPPA_EPS = 10.0      # barrier decrease gate: E_mu <= KAPPA_EPS * mu
KAPPA_MU = 0.2        # linear mu decrease factor
THETA_MU = 1.5        # superlinear mu decrease exponent
GAMMA_THETA = 1e-5    # filter margin on theta
GAMMA_PHI = 1e-5      # filter margin on phi
ETA_PHI = 1e-4        # Armijo constant
S_THETA = 1.1         # switching-condition exponents
S_PHI = 2.3
DELTA_SW = 1.0        # switching-condition scale
KAPPA_SOC = 0.99      # SOC progress requirement
MAX_SOC = 2           # second-order corrections per iteration
GAMMA_ALPHA = 0.05    # alpha_min safety factor
KAPPA_SIGMA = 1e10    # dual projection band around the central path


@dataclass
class NlpProblem:
    """Problem functions on f64 tensors (``x`` is ``[..., n_x]``).

    When ``params`` is set, every callable takes ``(x, params)``."""

    objective: Callable            # x -> [...], or (x, p) -> [...]
    eq: Optional[Callable] = None  # x -> [..., mE] residuals, target 0
    ineq: Optional[Callable] = None  # x -> [..., mI] values, >= 0
    params: Optional[object] = None  # passed to every callable
    # analytic Jacobians, x -> (m, n_x) at one x (same calling convention
    # as the constraint functions); they replace torch.func where given
    jac_eq: Optional[Callable] = None
    jac_ineq: Optional[Callable] = None
    # optional re-boxing hook: np.ndarray -> np.ndarray (may mutate in
    # place and return its argument), called on the iterate after the
    # start-with-restoration phase, which can leave simple-bound rows a
    # hair outside their boxes
    push_inside: Optional[Callable] = None
    # analytic Lagrangian Hessian (x, y, z) -> (n_x, n_x) of the RAW
    # problem: ∇²f - Σ y_i ∇²c_E,i - Σ z_j ∇²c_I,j. The solver maps its
    # scaled duals into raw space before calling and rescales the result.
    hess: Optional[Callable] = None
    # structured KKT solver (opf/kkt_bbd.AcKktBbd): ``solve(x, y, z,
    # sigma, delta, rhs_x, rhs_e, pk) -> (dx, v, lin_res, curv)`` and
    # ``row_maxes(x) -> (max|J_E| rows, max|J_I| rows)``, ``pk`` holding
    # the scales ``sf``, ``ge``, ``gi``. With it set, the step, the dual
    # residuals and the scaling form no (m, n_x) or (n_x, n_x) matrix.
    kkt: Optional[object] = None


@dataclass
class IpmResult:
    x: np.ndarray
    y: np.ndarray          # equality duals
    z: np.ndarray          # inequality duals
    s: np.ndarray          # slacks
    objective: float
    converged: bool
    iterations: int
    kkt_error: float
    # "optimal": KKT error < tol; "acceptable": stopped at an Ipopt-style
    # acceptable point (degenerate active set, KKT error < acceptable_tol);
    # "failed": no acceptable iterate found.
    status: str = "optimal"
    # the exit that ended the loop: "tol", "acceptable stall", "degenerate
    # endgame", "cross candidate", "mid-loop dual recovery", "acceptable
    # run", "acceptable-run dual recovery", "no factorizable system",
    # "feasible yet unsteppable", "restoration off (n_x > 8192)",
    # "restoration failed", "max_seconds" or "max_iter" (a record only:
    # the status above does not read it)
    stop: str = "max_iter"


# problems larger than this take their Jacobians and Hessian in blocks of
# basis tangents: a plain jacfwd pushes all n_x tangents through the
# problem graph at once, n_x times its intermediates
_CHUNK_THRESHOLD = 768
_CHUNK_BLOCK = 256


def _chunked_jacfwd(fn, n_x: int, block: int = _CHUNK_BLOCK):
    """Forward-mode Jacobian, ``block`` basis tangents at a time through
    ``vmap(jvp)``. ``fn(x, *rest)`` returns a vector; the result matches
    ``torch.func.jacfwd(fn)(x, *rest)`` (shape (m, n_x))."""

    def jac(x, *rest):
        def push(v):
            return jvp(lambda xx: fn(xx, *rest), (x,), (v,))[1]

        rows = []
        for start in range(0, n_x, block):
            k = min(block, n_x - start)
            basis = torch.zeros((k, n_x), dtype=x.dtype, device=x.device)
            pos = torch.arange(k, device=x.device)
            basis[pos, start + pos] = 1.0
            rows.append(vmap(push)(basis))
        return torch.cat(rows).T

    return jac


def _jacobian(fn, n_x: int):
    return _chunked_jacfwd(fn, n_x) if n_x > _CHUNK_THRESHOLD \
        else jacfwd(fn)


def _make_fns(f, c_e, c_i, n_x: int, m_e: int, m_i: int,
              jac_e_fn=None, jac_i_fn=None, hess_fn=None, kkt_solve=None):
    """Every device function the loop needs, for the (scaled) problem
    ``f``/``c_e``/``c_i`` of ``x``; ``jac_e_fn``/``jac_i_fn``/``hess_fn``
    are optional analytic derivatives that replace ``torch.func``.
    ``kkt_solve(x, y, z, sigma, delta, rhs_x, rhs_e)`` is a structured KKT
    solve (``NlpProblem.kkt``): the step then goes through it, and every
    Jᵀ product is a vector-Jacobian product."""
    if not m_e:
        c_e = lambda x: x.new_zeros(x.shape[:-1] + (0,))  # noqa: E731
    if not m_i:
        c_i = lambda x: x.new_zeros(x.shape[:-1] + (0,))  # noqa: E731

    grad_f = grad(f)
    jac_e = jac_e_fn if (jac_e_fn is not None and m_e) \
        else _jacobian(c_e, n_x)
    jac_i = jac_i_fn if (jac_i_fn is not None and m_i) \
        else _jacobian(c_i, n_x)

    def lagrangian(x, y, z):
        val = f(x)
        if m_e:
            val = val - y @ c_e(x)
        if m_i:
            val = val - z @ c_i(x)
        return val

    hess_l = hess_fn if hess_fn is not None \
        else _jacobian(grad(lagrangian), n_x)

    def _jt(fn, given, x, cot):
        """Jᵀ·cot: from the analytic Jacobian where there is one, else a
        vector-Jacobian product that never materializes J."""
        if given is not None:
            return given(x).T @ cot
        return vjp(fn, x)[1](cot)[0]

    # the structured path never forms J: its Jᵀ products are vjps
    jt_e_fn = jac_e_fn if (m_e and kkt_solve is None) else None
    jt_i_fn = jac_i_fn if (m_i and kkt_solve is None) else None

    def metrics(x, s, mu):
        """Objective, violation theta, barrier phi, raw residual vectors;
        ``x`` may carry leading batch dimensions (``s`` with them)."""
        fval = f(x)
        ce = c_e(x)
        ci = c_i(x)
        theta = ce.abs().sum(-1)
        phi = fval
        ri = ci - s
        if m_i:
            theta = theta + ri.abs().sum(-1)
            phi = phi - mu * torch.log(s.clamp(min=1e-300)).sum(-1)
        return fval, theta, phi, ce, ri

    def _dual_residual(x, y, z):
        r_d = grad_f(x)
        dual_l1 = x.new_zeros(())
        if m_e:
            r_d = r_d - _jt(c_e, jt_e_fn, x, y)
            dual_l1 = dual_l1 + y.abs().sum()
        if m_i:
            r_d = r_d - _jt(c_i, jt_i_fn, x, z)
            dual_l1 = dual_l1 + z.abs().sum()
        s_d = (dual_l1 / max(m_e + m_i, 1)).clamp(min=100.0) / 100.0
        return r_d, s_d

    def kkt_error_multi(x, y, z, s, mus):
        """Ipopt's scaled optimality error E_mu (their eq. 5) at every
        barrier value of ``mus`` (a tensor): the whole mu ladder in one
        evaluation."""
        r_d, s_d = _dual_residual(x, y, z)
        err = r_d.abs().max() / s_d
        if m_e:
            err = torch.maximum(err, c_e(x).abs().max())
        if m_i:
            err = torch.maximum(err, (c_i(x) - s).abs().max())
            s_c = (z.abs().sum() / m_i).clamp(min=100.0) / 100.0
            comp = (s * z - mus[:, None]).abs().amax(-1) / s_c
            return torch.maximum(err, comp)
        return err.expand(mus.shape)

    def kkt_error(x, y, z, s, mu):
        mus = torch.tensor([float(mu)], dtype=x.dtype, device=x.device)
        return kkt_error_multi(x, y, z, s, mus)[0]

    def metrics_p(x, s, mu):
        """metrics with the scalars packed into one tensor (a single
        readback): [fval, theta, phi, max(ri)]."""
        fval, theta, phi, ce, ri = metrics(x, s, mu)
        max_ri = ri.max() if m_i else x.new_zeros(())
        return torch.stack([fval, theta, phi, max_ri]), ce, ri

    def ls_probe(x, s, mu, dx_t, ds_t, alphas):
        """(theta, phi) at EVERY backtracking step length of ``alphas`` in
        one batched evaluation."""
        a = alphas[:, None]
        x_t = x + a * dx_t
        s_t = (s + a * ds_t).clamp(min=1e-300) if m_i else s
        _, theta, phi, _, _ = metrics(x_t, s_t, mu)
        return theta, phi

    def kkt_components(x, y, z, s, mu):
        """Diagnostic split of E_mu: (scaled dual residual, worst
        stationarity row, primal violation, scaled complementarity, worst
        complementarity row)."""
        r_d, s_d = _dual_residual(x, y, z)
        prim = x.new_zeros(())
        if m_e:
            prim = torch.maximum(prim, c_e(x).abs().max())
        comp = x.new_zeros(())
        comp_row = torch.zeros((), dtype=torch.int64)
        if m_i:
            prim = torch.maximum(prim, (c_i(x) - s).abs().max())
            s_c = (z.abs().sum() / m_i).clamp(min=100.0) / 100.0
            cv = (s * z - mu).abs() / s_c
            comp = cv.max()
            comp_row = cv.argmax()
        return (r_d.abs().max() / s_d, r_d.abs().argmax(), prim, comp,
                comp_row)

    def step(x, y, z, s, mu, delta, ce, ri):
        """Newton step on the condensed barrier KKT system: ``(dx, dy, ds,
        dz, stats)`` with stats = [alpha_s, alpha_z, lin_res, curv, dphi,
        dx·dx, finite]. ``ce``/``ri`` are the right-hand side's residuals,
        so a second-order correction reuses this step with corrected
        ones."""
        mark("derivatives")
        w = hess_l(x, y, z)
        g = grad_f(x)
        je = jac_e(x) if m_e else None
        ji = jac_i(x) if m_i else None

        mark("KKT assembly")
        r_d = g
        if m_e:
            r_d = r_d - je.T @ y
        if m_i:
            r_d = r_d - ji.T @ z
            sigma = (z / s).clamp(1e-12, 1e12)
            w = w + ji.T @ (sigma[:, None] * ji)
            # folded RHS contribution:  Jiᵀ (Σ r_i + z - μ/s)
            r_d = r_d + ji.T @ (sigma * ri + z - mu / s)

        n_aug = n_x + m_e
        kkt = x.new_zeros((n_aug, n_aug))
        kkt[:n_x, :n_x] = w
        del w
        kkt[:n_x, :n_x].diagonal().add_(delta)
        rhs = x.new_zeros(n_aug)
        rhs[:n_x] = -r_d
        if m_e:
            kkt[:n_x, n_x:] = je.T
            kkt[n_x:, :n_x] = je
            kkt[n_x:, n_x:].diagonal().fill_(-1e-10)
            rhs[n_x:] = -ce
        # symmetric Jacobi equilibration: Σ = Z/S spans ~1e12 near
        # convergence; D A D compresses the dynamic range to O(1)
        d = 1.0 / torch.sqrt(kkt.abs().amax(dim=1).clamp(min=1e-12))
        kkt_s = d[:, None] * kkt * d[None, :]
        mark("LU")
        factor = linalg.factorize(kkt_s, linalg.LU, check=False)
        del kkt_s
        mark("solve")
        sol = d * linalg.solve(factor, d * rhs)
        del factor
        mark("step")
        # linear-solve quality: an inaccurate or singular factorization
        # shows up as a large relative residual; the loop escalates delta
        lin_res = (kkt @ sol - rhs).abs().max() / (1.0 + rhs.abs().max())
        dx = sol[:n_x]
        dy = -sol[n_x:] if m_e else x.new_zeros(0)

        # inertia-free curvature test (Chiang & Zavala): the condensed
        # Hessian must have positive curvature along dx
        curv = dx @ (kkt[:n_x, :n_x] @ dx)
        del kkt

        if m_i:
            ds = ji @ dx + ri
            dz = (mu - s * z - z * ds) / s
            tau = max(0.99, 1.0 - mu)
            alpha_s = torch.where(ds < 0, -tau * s / ds, 1.0).min()
            alpha_z = torch.where(dz < 0, -tau * z / dz, 1.0).min()
            alpha_s = alpha_s.clamp(0.0, 1.0)
            alpha_z = alpha_z.clamp(0.0, 1.0)
            dphi = g @ dx - mu * (ds / s).sum()
        else:
            ds = x.new_zeros(0)
            dz = x.new_zeros(0)
            alpha_s = x.new_ones(())
            alpha_z = x.new_ones(())
            dphi = g @ dx

        # every scalar the host logic needs in ONE tensor: one readback
        stats = torch.stack([
            alpha_s, alpha_z, lin_res, curv, dphi, dx @ dx,
            torch.isfinite(dx).all().to(dx.dtype)])
        return dx, dy, ds, dz, stats

    def bbd_step(x, y, z, s, mu, delta, ce, ri):
        """``step`` through the structured KKT solve: the JAX package's
        ``_bbd_step_body``. r_d from vector-Jacobian products, ds from a
        Jacobian-vector product; (dx, v, lin_res, curv) from
        ``kkt_solve``."""
        mark("derivatives")
        g = grad_f(x)
        r_d = g
        if m_e:
            r_d = r_d - vjp(c_e, x)[1](y)[0]
        if m_i:
            sigma = (z / s).clamp(1e-12, 1e12)
            pull = vjp(c_i, x)[1]
            r_d = r_d - pull(z)[0]
            r_d = r_d + pull(sigma * ri + z - mu / s)[0]
        else:
            sigma = x.new_zeros(0)
        rhs_e = -ce if m_e else x.new_zeros(0)
        dx, v, lin_res, curv = kkt_solve(x, y, z, sigma, delta, -r_d, rhs_e)
        dy = -v if m_e else x.new_zeros(0)
        if m_i:
            mark("derivatives")
            ds = jvp(c_i, (x,), (dx,))[1] + ri
            mark("step")
            dz = (mu - s * z - z * ds) / s
            tau = max(0.99, 1.0 - mu)
            alpha_s = torch.where(ds < 0, -tau * s / ds, 1.0).min()
            alpha_z = torch.where(dz < 0, -tau * z / dz, 1.0).min()
            alpha_s = alpha_s.clamp(0.0, 1.0)
            alpha_z = alpha_z.clamp(0.0, 1.0)
            dphi = g @ dx - mu * (ds / s).sum()
        else:
            mark("step")
            ds = x.new_zeros(0)
            dz = x.new_zeros(0)
            alpha_s = x.new_ones(())
            alpha_z = x.new_ones(())
            dphi = g @ dx
        stats = torch.stack([
            alpha_s, alpha_z, lin_res, curv, dphi, dx @ dx,
            torch.isfinite(dx).all().to(dx.dtype)])
        return dx, dy, ds, dz, stats

    def resto_step(x, lam):
        """Levenberg-Marquardt step for min ½‖c_E‖² + ½‖min(c_I,0)‖²."""
        r_parts = []
        j_parts = []
        if m_e:
            r_parts.append(c_e(x))
            j_parts.append(jac_e(x))
        if m_i:
            ci = c_i(x)
            r_parts.append(ci.clamp(max=0.0))
            j_parts.append(torch.where((ci < 0.0)[:, None], jac_i(x), 0.0))
        r = torch.cat(r_parts)
        jmat = torch.cat(j_parts, dim=0)
        a = jmat.T @ jmat
        a.diagonal().add_(lam)
        g = jmat.T @ r
        d = 1.0 / torch.sqrt(a.abs().amax(dim=1).clamp(min=1e-12))
        a_s = d[:, None] * a * d[None, :]
        dx = -d * linalg.solve(linalg.factorize(a_s, linalg.LU, check=False),
                               d * g)
        return dx, 0.5 * (r @ r)

    def grad_f_jvp(x, d):
        return jvp(grad_f, (x,), (d,))[1]

    def theta_of(x):
        t = x.new_zeros(())
        if m_e:
            t = t + c_e(x).abs().sum()
        if m_i:
            t = t + c_i(x).clamp(max=0.0).abs().sum()
        return t

    return SimpleNamespace(
        f=f, c_e=c_e, c_i=c_i, grad_f=grad_f, jac_e=jac_e, jac_i=jac_i,
        hess_l=hess_l, metrics=metrics, metrics_p=metrics_p,
        kkt_error=kkt_error, kkt_error_multi=kkt_error_multi,
        kkt_components=kkt_components, ls_probe=ls_probe,
        step=step if kkt_solve is None else bbd_step,
        resto_step=resto_step, grad_f_jvp=grad_f_jvp, theta_of=theta_of)


def _filter_accepts(filt, theta, phi):
    for th_f, ph_f in filt:
        if theta >= th_f and phi >= ph_f:
            return False
    return True


def _read(t: torch.Tensor):
    """One device-to-host readback of ``t`` (a list, or a float for a
    0-d tensor), marked as such for ``device_stages``."""
    mark("readback")
    out = t.tolist()
    mark("host")
    return out


def _row_max(fn_raw, jac_raw, n_x, x):
    """Per-row max|J| at x for gradient-based scaling, on x's device."""
    jac = jac_raw if jac_raw is not None else _jacobian(fn_raw, n_x)
    return jac(x).abs().amax(dim=1)


def _scale_of(row: np.ndarray) -> np.ndarray:
    return np.minimum(1.0, 100.0 / np.maximum(row, 1e-12))


def solve_nlp(problem: NlpProblem, x0: np.ndarray,
              max_iter: int = 200, tol: float = 1e-8,
              acceptable_tol: float = 1e-6, acceptable_iter: int = 25,
              mu0: float = 0.1, verbose: int = 0,
              warm_duals: Optional[tuple] = None,
              max_seconds: Optional[float] = None,
              device=None) -> IpmResult:
    """Outer IPM driver: a host loop over device steps on ``device``
    (default ``config.device``).

    ``warm_duals`` is an optional ``(y, z, s)`` triple from a previous
    solve of the same-shaped problem (the reference's ``setdual``/
    ``transferdual!`` carry): the equality duals seed y directly and the
    inequality duals/slacks are projected into the central-path band for
    the starting barrier.

    ``max_seconds`` is a wall-clock budget (counted from the second
    iteration): on expiry the loop stops and the best iterate is returned,
    flagged acceptable/failed by its KKT error.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x0, dtype=np.float64), device=dev)
    n_x = x.shape[0]
    p = problem.params

    def raw(fn):
        if fn is None:
            return None
        return (lambda xx: fn(xx, p)) if p is not None else fn

    f_raw = raw(problem.objective)
    eq_raw, ineq_raw = raw(problem.eq), raw(problem.ineq)
    je_raw, ji_raw = raw(problem.jac_eq), raw(problem.jac_ineq)
    if problem.hess is None:
        hess_raw = None
    elif p is not None:
        hess_raw = lambda xx, yy, zz: problem.hess(xx, yy, zz, p)  # noqa
    else:
        hess_raw = problem.hess
    # row counts from one evaluation on the device
    m_e = int(eq_raw(x).shape[-1]) if eq_raw is not None else 0
    m_i = int(ineq_raw(x).shape[-1]) if ineq_raw is not None else 0

    # Ipopt-style gradient-based scaling (their nlp_scaling_method =
    # "gradient-based"): keep max|∇f| near 100 so currency-unit cost
    # coefficients don't swamp the KKT tolerances, and scale every
    # constraint row the same way
    gmax = float(grad(f_raw)(x).abs().max()) if n_x else 1.0
    scale_f = min(1.0, 100.0 / gmax) if gmax > 0 else 1.0
    g_e = g_i = None
    if problem.kkt is not None and (m_e or m_i):
        # structured path: the row maxima from the KKT's closed forms, no
        # dense (m, n_x) Jacobian
        row_e, row_i = problem.kkt.row_maxes(x)
    else:
        row_e = _row_max(eq_raw, je_raw, n_x, x) if m_e else None
        row_i = _row_max(ineq_raw, ji_raw, n_x, x) if m_i else None
    if m_e:
        g_e = torch.as_tensor(_scale_of(row_e.cpu().numpy()), device=dev)
    if m_i:
        g_i = torch.as_tensor(_scale_of(row_i.cpu().numpy()), device=dev)

    f = lambda xx: scale_f * f_raw(xx)  # noqa: E731
    c_e = (lambda xx: g_e * eq_raw(xx)) if m_e else None
    c_i = (lambda xx: g_i * ineq_raw(xx)) if m_i else None
    # analytic derivatives get the same row scaling as the constraints
    jac_e_fn = (lambda xx: g_e[:, None] * je_raw(xx)) \
        if (m_e and je_raw is not None) else None
    jac_i_fn = (lambda xx: g_i[:, None] * ji_raw(xx)) \
        if (m_i and ji_raw is not None) else None
    # the user Hessian is the RAW Lagrangian's with duals mapped into raw
    # constraint space; rescaled by sf it is the scaled Lagrangian's
    hess_fn = (lambda xx, yy, zz: scale_f * hess_raw(
        xx, (g_e * yy / scale_f) if m_e else yy,
        (g_i * zz / scale_f) if m_i else zz)) \
        if hess_raw is not None else None
    kkt_solve = None
    if problem.kkt is not None:
        pk = {"sf": scale_f, "ge": g_e, "gi": g_i}

        def kkt_solve(xx, yy, zz, sigma, delta, rhs_x, rhs_e):
            return problem.kkt.solve(xx, yy, zz, sigma, delta, rhs_x, rhs_e,
                                     pk)
    fns = _make_fns(f, c_e, c_i, n_x, m_e, m_i, jac_e_fn=jac_e_fn,
                    jac_i_fn=jac_i_fn, hess_fn=hess_fn, kkt_solve=kkt_solve)
    step, kkt_error, metrics = fns.step, fns.kkt_error, fns.metrics
    kkt_error_multi, metrics_p, ls_probe = (fns.kkt_error_multi,
                                            fns.metrics_p, fns.ls_probe)
    resto_step = fns.resto_step
    c_e, c_i, grad_f, jac_e, jac_i = (fns.c_e, fns.c_i, fns.grad_f,
                                      fns.jac_e, fns.jac_i)

    def t64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    def host(t):
        return t.detach().cpu().numpy()

    # the restoration LM and the dual-recovery polish both materialize
    # dense (m, n_x)/(n_x, n_x) intermediates. The caps are the JAX
    # package's (sized for its 16 GB chip), kept so that both packages
    # take the same branches; below them they change nothing.
    resto_ok = n_x <= 8192
    recovery_ok = n_x <= 4096

    # start-with-restoration (Ipopt's start_with_resto): a badly infeasible
    # start pins the barrier iteration; a cheap Levenberg-Marquardt pass on
    # the violation first makes the barrier loop start near-feasible
    def _theta_of(xx):
        return _read(fns.theta_of(xx))

    theta_start = _theta_of(x)
    if (m_e or m_i) and theta_start > 1.0 and resto_ok:
        lam = 1e-6
        th = theta_start
        for _ in range(60):
            dxr, _ = resto_step(x, lam)
            if not bool(torch.isfinite(dxr).all()):
                lam *= 10.0
                continue
            x_try = x + dxr
            th_try = _theta_of(x_try)
            if th_try < th:
                x, th = x_try, th_try
                lam = max(lam / 3.0, 1e-10)
                if th < 1e-6 * max(1.0, theta_start):
                    break
            else:
                lam *= 10.0
                if lam > 1e12:
                    break
        if verbose >= 1:
            print(f"  ipm start-with-resto: theta {theta_start:.3e} "
                  f"-> {th:.3e}")
        if problem.push_inside is not None:
            # re-box: push the iterate strictly back inside its simple
            # bounds so the slacks start at healthy magnitudes
            x_np = host(x).copy()
            out = problem.push_inside(x_np)
            x = t64(out if out is not None else x_np)

    if m_i:
        ci0 = c_i(x)
        # floor the initial slacks at 0.01 (Ipopt's slack push)
        s = ci0.clamp(min=1e-2)
        z = (mu0 / s).clamp(1e-8, 1e6)
    else:
        s = x.new_zeros(0)
        z = x.new_zeros(0)
    y = x.new_zeros(m_e)

    if warm_duals is not None:
        y_w, z_w, s_w = warm_duals
        # the carried duals are unscaled (IpmResult form); map them into
        # this solve's scaled space, then project z into the central-path
        # band so a stale dual can't pin the first fraction-to-boundary
        if m_e and y_w is not None and len(y_w) == m_e:
            y = t64(y_w) * scale_f
            if g_e is not None:
                y = y / g_e
        if m_i and s_w is not None and len(s_w) == m_i:
            # carried slacks too (IpmResult reports s / g_i)
            s_c = t64(s_w)
            if g_i is not None:
                s_c = s_c * g_i
            s = s_c.clamp(min=1e-300)
        if m_i and z_w is not None and len(z_w) == m_i:
            z_c = t64(z_w) * scale_f
            if g_i is not None:
                z_c = z_c / g_i
            z = torch.clamp(z_c, mu0 / (KAPPA_SIGMA * s),
                            KAPPA_SIGMA * mu0 / s)
            z = z.clamp(min=1e-14)

    mu = mu0
    mu_min = tol / 11.0
    converged = False
    it = 0
    err = np.inf
    best = None
    stall = 0
    # which exit ended the loop (IpmResult.stop)
    stop = "max_iter"
    # most-FEASIBLE iterate seen, tracked separately from best-KKT: at a
    # degenerate endgame the duals thrash while the primal converges, and
    # dual recovery needs the feasible iterate
    best_feas = None
    best_feas_theta = np.inf

    theta0 = _read(metrics(x, s, mu)[1])
    prev_obj = None
    acceptable_run = 0
    theta_min = 1e-4 * max(1.0, theta0)
    theta_max = 1e4 * max(1.0, theta0)
    # the filter starts with the theta cap (W-B eq. 25)
    filt = [(theta_max, -np.inf)]
    delta_last = 0.0
    pinched = 0
    pinch_theta0 = np.inf
    t_start = None  # armed at the second iteration

    def _dual_recovery_corr(x_r, y_r, z_r, s_in):
        """Correction fit: keep the seed duals and lstsq only the
        correction on (y, strongly-active z). One lstsq per strength
        cut."""
        try:
            xj = t64(host(x_r))
            g_np = host(grad_f(xj))
            je_np = host(jac_e(xj)) if m_e else np.zeros((0, n_x))
            ji_np = host(jac_i(xj)) if m_i else np.zeros((0, n_x))
            ci_np = host(c_i(xj)) if m_i else np.zeros(0)
            y_np = np.asarray(host(y_r), dtype=np.float64)
            z_np = np.asarray(host(z_r), dtype=np.float64) if m_i \
                else np.zeros(0)
            s_r = t64(ci_np).clamp(min=1e-12) if m_i else s_in
            best_loc = None
            zmax = float(z_np.max()) if z_np.size else 0.0
            for frac in (1e-3, 1e-4, 1e-5):
                strong = z_np > frac * zmax if zmax > 0 else \
                    np.zeros(m_i, dtype=bool)
                cols = [je_np]
                if strong.any():
                    cols.append(ji_np[strong])
                a_mat = np.vstack(cols).T
                r = g_np - je_np.T @ y_np - ji_np.T @ z_np
                corr, *_ = np.linalg.lstsq(a_mat, r, rcond=None)
                y2 = y_np + corr[:m_e]
                z2 = z_np.copy()
                if strong.any():
                    z2[strong] = np.maximum(z2[strong] + corr[m_e:], 0.0)
                err_r = _read(kkt_error(xj, t64(y2), t64(z2), s_r, 0.0))
                if verbose >= 2:
                    print(f"      dual-corr frac={frac:.0e} "
                          f"strong={int(strong.sum())} -> err "
                          f"{err_r:.2e}")
                if best_loc is None or err_r < best_loc[0]:
                    best_loc = (err_r, xj, t64(y2), t64(z2), s_r)
                if err_r < tol:
                    break
            return best_loc
        except Exception as exc:
            if verbose >= 2:
                print(f"      dual-corr exception: {exc!r}")
            return None

    def _dual_recovery(x_r, s_in, err_now, y_seed=None, z_seed=None):
        """Degenerate active sets (LP vertices, piecewise breakpoints)
        leave the primal converged while the Newton duals thrash on a
        non-unique multiplier set: fit the multipliers directly. Returns
        (err, x, y, z, s) on improvement, else None."""
        best_rec = None
        if y_seed is not None and (m_e or m_i):
            best_rec = _dual_recovery_corr(x_r, y_seed, z_seed, s_in)
            # early out when the cheap correction already lands: always
            # at the strict tolerance; at the acceptable level too on
            # large problems
            if best_rec is not None and (
                    best_rec[0] < tol
                    or (n_x > 2048 and best_rec[0] < acceptable_tol)):
                return best_rec if best_rec[0] < err_now else None
        # fit-first sweep over generous candidate thresholds
        for thr in (1e-5, 1e-4, 1e-3, 1e-2):
            rec = _dual_recovery_at(x_r, s_in, thr)
            if rec is not None and (best_rec is None
                                    or rec[0] < best_rec[0]):
                best_rec = rec
                if best_rec[0] < tol:
                    break
        if (best_rec is None or best_rec[0] >= tol) \
                and n_x <= 2048:
            # small-problem fallback: the polish-first + simplex-style
            # crossover walk (handles epsilon-degenerate LP edges)
            for thr in (1e-5, 1e-4, 1e-6, 1e-3):
                rec = _dual_recovery_crossover(x_r, s_in, thr)
                if rec is not None and (best_rec is None
                                        or rec[0] < best_rec[0]):
                    best_rec = rec
                    if best_rec[0] < tol:
                        break
        if best_rec is not None and best_rec[0] < err_now:
            return best_rec
        return None

    def _polish(x_np, act_p):
        """Host Gauss-Newton of the iterate onto [c_E; c_A] = 0 (at most
        three steps, none longer than 1)."""
        for _ in range(3):
            xj = t64(x_np)
            parts_r, parts_j = [], []
            if m_e:
                parts_r.append(host(c_e(xj)))
                parts_j.append(host(jac_e(xj)))
            if m_i and act_p.any():
                parts_r.append(host(c_i(xj))[act_p])
                parts_j.append(host(jac_i(xj))[act_p])
            if not parts_r:
                return x_np
            r_all = np.concatenate(parts_r)
            if float(np.max(np.abs(r_all))) < 1e-13:
                return x_np
            j_all = np.vstack(parts_j)
            dx_p, *_ = np.linalg.lstsq(j_all, -r_all, rcond=None)
            if float(np.max(np.abs(dx_p))) > 1.0:
                return x_np
            x_np = x_np + dx_p
        return x_np

    def _nnls(g_np, je_np, ji_np, cand):
        """Multipliers on the candidate rows, pruning negative z."""
        act_try = cand.copy()
        sol = np.zeros(m_e)
        for _ in range(12):
            a_mat = np.vstack([je_np, ji_np[act_try]]).T
            sol, *_ = np.linalg.lstsq(a_mat, g_np, rcond=None)
            neg = sol[m_e:] < -1e-10
            if not neg.any():
                break
            idxs = np.flatnonzero(act_try)
            act_try[idxs[neg]] = False
        else:
            # exhausted with a prune on the last pass: realign
            a_mat = np.vstack([je_np, ji_np[act_try]]).T
            sol, *_ = np.linalg.lstsq(a_mat, g_np, rcond=None)
        return sol, act_try

    def _start_of(x_r, thr):
        x_np = np.asarray(host(x_r), dtype=np.float64)
        if m_i:
            ci0 = host(c_i(x_r))
            scale_ci = max(1.0, float(np.max(np.abs(ci0))))
            act = ci0 <= thr * scale_ci
        else:
            act = np.zeros(0, dtype=bool)
        return x_np, act, _read(f(t64(x_np)))

    def _point(x_np):
        """(xj, g, J_E, c_I, J_I) at ``x_np`` on the host."""
        xj = t64(x_np)
        g_np = host(grad_f(xj))
        je_np = host(jac_e(xj)) if m_e else np.zeros((0, n_x))
        if m_i:
            ci_np = host(c_i(xj))
            ji_np = host(jac_i(xj))
        else:
            ci_np = np.zeros(0)
            ji_np = np.zeros((0, n_x))
        return xj, g_np, je_np, ci_np, ji_np

    def _dual_recovery_at(x_r, s_in, thr):
        """Fit-first recovery: NNLS multipliers at the UNPOLISHED iterate
        over a generous candidate set (ci <= thr * scale), then polish the
        primal only onto the multiplier SUPPORT and refit."""
        try:
            x_np, act, f_old = _start_of(x_r, thr)
            best_loc = None
            for fit_pass in range(2):
                xj, g_np, je_np, ci_np, ji_np = _point(x_np)
                if m_i and bool(np.any(ci_np < -1e-9)):
                    break  # polish left feasibility; keep previous
                if _read(f(xj)) > f_old + 1e-6 * max(1.0, abs(f_old)):
                    break  # objective worsened; not a polish any more
                sol, act_try = _nnls(g_np, je_np, ji_np, act)
                y_r = t64(sol[:m_e])
                z_np = np.zeros(m_i)
                if m_i:
                    z_np[act_try] = np.maximum(sol[m_e:], 0.0)
                z_r = t64(z_np)
                s_r = t64(ci_np).clamp(min=1e-12) if m_i else s_in
                err_r = _read(kkt_error(xj, y_r, z_r, s_r, 0.0))
                if verbose >= 2:
                    print(f"      dual-recovery thr={thr:.0e} "
                          f"fit={fit_pass}: act={int(act_try.sum())} "
                          f"-> err {err_r:.2e}")
                if best_loc is None or err_r < best_loc[0]:
                    best_loc = (err_r, xj, y_r, z_r, s_r)
                if err_r < tol or not m_i:
                    break
                # polish onto the multiplier support, refit once
                zmax = float(z_np.max()) if m_i else 0.0
                supp = act_try & (z_np > 1e-8 * max(1.0, zmax))
                if not supp.any() or fit_pass == 1:
                    break
                x_np = _polish(x_np, supp)
                act = supp
            return best_loc
        except Exception as exc:
            if verbose >= 2:
                print(f"      dual-recovery exception: {exc!r}")
            return None  # best-effort: keep the iterate

    def _dual_recovery_crossover(x_r, s_in, thr):
        """Polish-first recovery + simplex-style crossover: descend along
        the active manifold's null space until a new inequality blocks,
        adopt it, repeat (small-scale fallback)."""
        try:
            x_np, act, f_old = _start_of(x_r, thr)
            x_np = _polish(x_np, act)
            best_loc = None
            for cross in range(8):
                xj, g_np, je_np, ci_np, ji_np = _point(x_np)
                if m_i and bool(np.any(ci_np < -1e-9)):
                    break  # infeasible point; keep previous best
                if _read(f(xj)) > f_old + 1e-6 * max(1.0, abs(f_old)):
                    break  # objective worsened; not a polish any more
                sol, act_try = _nnls(g_np, je_np, ji_np, act)
                y_r = t64(sol[:m_e])
                z_np = np.zeros(m_i)
                if m_i:
                    z_np[act_try] = np.maximum(sol[m_e:], 0.0)
                z_r = t64(z_np)
                s_r = t64(ci_np).clamp(min=1e-12) if m_i else s_in
                err_r = _read(kkt_error(xj, y_r, z_r, s_r, 0.0))
                if verbose >= 2:
                    print(f"      dual-recovery thr={thr:.0e} "
                          f"pass={cross}: act={int(act_try.sum())} "
                          f"-> err {err_r:.2e}")
                if best_loc is None or err_r < best_loc[0]:
                    best_loc = (err_r, xj, y_r, z_r, s_r)
                if err_r < tol or not m_i:
                    break
                # crossover: null-space descent until a new row blocks,
                # projected through the SVD row-space basis
                a_rows = np.vstack([je_np, ji_np[act]])
                if a_rows.size:
                    _, sv_s, sv_vt = np.linalg.svd(a_rows,
                                                   full_matrices=False)
                    keep = sv_s > (sv_s[0] * 1e-10 if sv_s.size else 0.0)
                    vr = sv_vt[keep]
                    d = -(g_np - vr.T @ (vr @ g_np))
                else:
                    d = -g_np
                d_norm = float(np.linalg.norm(d))
                if d_norm < 1e-12 * max(1.0, float(np.linalg.norm(g_np))):
                    break
                d = d / d_norm  # unit step so the ratio test is geometric
                # exact line search on the local quadratic model; the
                # slope is -|d| by construction (d = -(I-P)g)
                f_slope = -d_norm
                curv = float(d @ host(fns.grad_f_jvp(xj, t64(d))))
                t_star = -f_slope / curv if curv > 1e-12 else np.inf
                inact = np.flatnonzero(~act)
                slope = ji_np[~act] @ d
                blocking = slope < -1e-12
                t_block = np.inf
                j_block = -1
                if blocking.any():
                    ts = ci_np[~act][blocking] / (-slope[blocking])
                    t_block = float(np.min(ts))
                    j_block = inact[np.flatnonzero(blocking)[
                        int(np.argmin(ts))]]
                t_step = min(t_star, t_block)
                if not np.isfinite(t_step) or t_step > 1e3 \
                        or t_step <= 0.0:
                    break
                x_np = x_np + t_step * d
                if t_block <= t_star and j_block >= 0:
                    act[j_block] = True
                x_np = _polish(x_np, act)
            return best_loc
        except Exception as exc:
            if verbose >= 2:
                print(f"      dual-recovery exception: {exc!r}")
            return None  # best-effort: keep the iterate

    for it in range(1, max_iter + 1):
        if max_seconds is not None:
            if t_start is None and it == 2:
                t_start = _time.perf_counter()
            elif t_start is not None and \
                    _time.perf_counter() - t_start > max_seconds:
                stop = "max_seconds"
                break
        # E at mu=0 (the stopping error) AND at the whole deterministic
        # Fiacco-McCormick mu ladder, in one evaluation and one readback
        mu_ladder = [mu]
        while mu_ladder[-1] > mu_min:
            mc = mu_ladder[-1]
            # superlinear decrease, CAPPED at 50x per rung on large
            # problems (recentring z three decades at once thrashes a
            # large endgame); small problems keep the classic jump
            cap = mc / 50.0 if n_x > 1024 else 0.0
            mu_ladder.append(max(mu_min, cap,
                                 min(KAPPA_MU * mc, mc ** THETA_MU)))
        mark("kkt error")
        errs = _read(kkt_error_multi(x, y, z, s, t64([0.0] + mu_ladder)))
        err = float(errs[0])
        if best is None or err < best[0]:
            best = (err, x, y, z, s)
            stall = 0
        else:
            stall += 1
        if err < tol:
            converged = True
            stop = "tol"
            break
        # Ipopt-style acceptable-level stop once progress stalls below the
        # acceptable tolerance (degenerate active sets)
        if stall >= acceptable_iter and best[0] < acceptable_tol:
            converged = True
            stop = "acceptable stall"
            break
        # degenerate endgame: barrier at its floor, best already
        # acceptable, the last step blew the error up — return the best
        if mu <= mu_min * 1.01 and best[0] < acceptable_tol and \
                err > 10.0 * best[0]:
            converged = True
            stop = "degenerate endgame"
            break

        # monotone Fiacco-McCormick with superlinear decrease, gated on
        # the mu-scaled error (W-B eq. 7); the filter resets on mu change
        changed = False
        i_mu = 0
        while mu_ladder[i_mu] > mu_min and \
                float(errs[1 + i_mu]) <= KAPPA_EPS * mu_ladder[i_mu]:
            i_mu += 1
            changed = True
        mu = mu_ladder[i_mu]
        if changed:
            filt = [(theta_max, -np.inf)]

        mark("metrics")
        mstats, ce_k, ri_k = metrics_p(x, s, mu)
        fval, theta_k, phi_k, max_ri = _read(mstats)
        if theta_k < best_feas_theta:
            best_feas = (x, y, z, s)
            best_feas_theta = theta_k
        # mu near its floor, KKT stalled, primal (near-)feasible: the duals
        # are thrashing on a degenerate active set — recover multipliers
        # directly (tried every 16 stalled iterations)
        if mu <= max(mu_min * 1.01, 100.0 * tol) and recovery_ok \
                and theta_k <= 1e-5 \
                and stall >= 8 and (stall - 8) % 16 == 0:
            # cheap first: best-KKT duals on the most-feasible primal
            if best is not None and best_feas is not None:
                err_cross = _read(kkt_error(
                    best_feas[0], best[2], best[3], best_feas[3], 0.0))
                if err_cross < best[0]:
                    best = (err_cross, best_feas[0], best[2], best[3],
                            best_feas[3])
                    if verbose >= 1:
                        print(f"  ipm iter {it}: cross candidate "
                              f"kkt -> {err_cross:.3e}")
                    if err_cross < acceptable_tol:
                        err, x, y, z, s = best
                        converged = err < tol
                        stop = "cross candidate"
                        break
            # recover from the BEST iterate's primal
            rec = _dual_recovery(best[1], best[4], err,
                                 y_seed=best[2], z_seed=best[3])
            if rec is not None and rec[0] < best[0]:
                best = rec
                if verbose >= 1:
                    print(f"  ipm iter {it}: mid-loop dual recovery "
                          f"kkt -> {rec[0]:.3e}")
                if rec[0] < acceptable_tol:
                    err, x, y, z, s = rec
                    converged = err < tol
                    stop = "mid-loop dual recovery"
                    break

        # Ipopt acceptable-point heuristic: stop once the violation is
        # negligible and the objective has been stagnant for
        # `acceptable_iter` consecutive iterations
        fv = fval
        if theta_k <= max(10.0 * tol, 1e-7) and \
                prev_obj is not None and \
                abs(fv - prev_obj) <= 1e-7 * max(1.0, abs(fv)):
            acceptable_run += 1
            if acceptable_run >= acceptable_iter:
                if best is not None and best[0] < acceptable_tol:
                    converged = True
                    stop = "acceptable run"
                    break
                # primal stagnant but duals thrashing (degenerate vertex)
                rec = _dual_recovery(
                    x, s, err,
                    y_seed=best[2] if best is not None else y,
                    z_seed=best[3] if best is not None else z) \
                    if recovery_ok else None
                if rec is not None and rec[0] < acceptable_tol:
                    err, x, y, z, s = rec
                    best = (err, x, y, z, s)
                    converged = True
                    if verbose >= 1:
                        print(f"  ipm dual recovery: kkt -> {err:.3e}")
                    stop = "acceptable-run dual recovery"
                    break
                acceptable_run = 0  # recovery failed; keep iterating
        else:
            acceptable_run = 0
        prev_obj = fv

        if m_i and max_ri > 0.0:
            # slack lifting: raising s_i to c_I(x)_i wherever c_I(x)_i > s_i
            # strictly reduces both theta and phi
            s = torch.where(ri_k > 0.0, s + ri_k, s)
            z = torch.clamp(z, mu / (KAPPA_SIGMA * s), KAPPA_SIGMA * mu / s)
            z = z.clamp(min=1e-14)
            mark("metrics")
            mstats, ce_k, ri_k = metrics_p(x, s, mu)
            _, theta_k, phi_k, _ = _read(mstats)
        if verbose >= 2:
            print(f"  ipm iter {it}: kkt={err:.3e} mu={mu:.3e} "
                  f"theta={theta_k:.3e} phi={phi_k:.6e}")
            if verbose >= 3 or it % 10 == 0:
                du, drow, pr, co, crow = fns.kkt_components(x, y, z, s, 0.0)
                print(f"      kkt split: dual={float(du):.3e}"
                      f"@x[{int(drow)}] prim={float(pr):.3e} "
                      f"comp={float(co):.3e}@row[{int(crow)}]")

        # --- search direction with inertia-free delta escalation ---------
        delta = 0.0 if delta_last == 0.0 else max(1e-20, delta_last / 3.0)
        ok = False
        for attempt in range(30):
            dx, dy, ds, dz, sstats = step(x, y, z, s, mu, delta, ce_k, ri_k)
            # one readback for every scalar the host logic needs
            (alpha_s, alpha_z, lin_res, curv, dphi, dxn,
             finite) = _read(sstats)
            ok = finite > 0.5 and lin_res < 1e-6 \
                and (curv >= 1e-12 * dxn or dxn == 0.0)
            if ok:
                break
            delta = 1e-8 * max(1.0, _read(x.abs().max())) \
                if delta == 0.0 else delta * 8.0
        delta_last = delta
        if not ok:
            stop = "no factorizable system"
            break  # no factorizable system; return best iterate

        alpha_max = alpha_s

        # minimum trial step before feasibility restoration (W-B eq. 23)
        if dphi < 0.0:
            cands = [GAMMA_THETA]
            if theta_k > 0:
                cands.append(GAMMA_PHI * theta_k / (-dphi))
            if theta_k <= theta_min:
                cands.append(DELTA_SW * theta_k ** S_THETA
                             / (-dphi) ** S_PHI)
            alpha_min = GAMMA_ALPHA * min(cands)
        else:
            alpha_min = GAMMA_ALPHA * GAMMA_THETA
        alpha_min = min(alpha_min, alpha_max)

        # --- filter backtracking line search ------------------------------
        alpha = alpha_max
        accepted = False
        f_type = False
        soc_done = 0
        dx_t, ds_t = dx, ds
        theta_t = np.inf

        def _accept(th_t, ph_t, a):
            """Filter + switching/Armijo acceptance at one trial point."""
            if not (np.isfinite(th_t) and np.isfinite(ph_t)):
                return False, False
            if not _filter_accepts(filt, th_t, ph_t):
                return False, False
            switching = dphi < 0.0 and \
                a * (-dphi) ** S_PHI > DELTA_SW * theta_k ** S_THETA
            if theta_k <= theta_min and switching:
                return ph_t <= phi_k + ETA_PHI * a * dphi, True
            return (th_t <= (1.0 - GAMMA_THETA) * theta_k or
                    ph_t <= phi_k - GAMMA_PHI * theta_k), False

        # full-step phase: trial + second-order corrections (W-B §2.4) —
        # each SOC changes the DIRECTION so it needs its own step solve
        while True:
            mark("line-search probes")
            x_t = x + alpha * dx_t
            s_t = (s + alpha * ds_t).clamp(min=1e-300) if m_i else s
            tstats, ce_t, ri_t = metrics_p(x_t, s_t, mu)
            _, theta_t, phi_t, _ = _read(tstats)
            accepted, f_type = _accept(theta_t, phi_t, alpha)
            if accepted:
                break
            if alpha == alpha_max and soc_done < MAX_SOC and m_e + m_i and \
                    np.isfinite(theta_t) and theta_t >= theta_k:
                ce_soc = alpha * ce_k + ce_t if m_e else ce_k
                ri_soc = alpha * ri_k + ri_t if m_i else ri_k
                dx_c, _, ds_c, _, st_c = step(
                    x, y, z, s, mu, delta, ce_soc, ri_soc)
                st_c = _read(st_c)
                if st_c[6] > 0.5 and st_c[2] < 1e-6:
                    soc_done += 1
                    dx_t, ds_t = dx_c, ds_c
                    alpha = alpha_max = min(alpha_max, st_c[0])
                    continue
                soc_done = MAX_SOC
            if soc_done and (dx_t is not dx):
                # SOC trial failed: fall back to the uncorrected direction
                dx_t, ds_t = dx, ds
                alpha = alpha_max = alpha_s
                soc_done = MAX_SOC
                continue
            break

        if not accepted and alpha * 0.5 >= alpha_min:
            # backtracking phase: the direction is fixed, so every
            # remaining trial point is probed in ONE batched evaluation and
            # the filter logic walks the (theta, phi) results on the host
            n_bt = min(60, int(np.floor(np.log2(
                max(alpha / max(alpha_min, 1e-300), 2.0)))) + 1)
            alphas = alpha * 0.5 ** np.arange(1, n_bt + 1)
            alphas = alphas[alphas >= alpha_min]
            if len(alphas):
                mark("line-search probes")
                th_arr, ph_arr = ls_probe(x, s, mu, dx_t, ds_t, t64(alphas))
                th_arr, ph_arr = _read(torch.stack([th_arr, ph_arr]))
                for a_c, th_c, ph_c in zip(alphas, th_arr, ph_arr):
                    acc, ft = _accept(th_c, ph_c, float(a_c))
                    if acc:
                        accepted, f_type = True, ft
                        alpha = float(a_c)
                        theta_t = th_c
                        break

        # pinch detection: steps capped hard by the boundary while the
        # violation stalls CUMULATIVELY (over a 10-iteration window) mean
        # the Newton direction cannot mend the infeasibility —
        # restoration mends it directly
        if accepted and theta_k > max(10.0 * tol, 1e-8) and \
                alpha_max < 5e-2 and theta_t > 0.9 * theta_k:
            if pinched == 0:
                pinch_theta0 = theta_k
            pinched += 1
            if pinched >= 10 and theta_t > 0.98 * pinch_theta0:
                accepted = False
                pinched = 0
        else:
            pinched = 0

        if not accepted:
            # --- feasibility restoration (LM on the violation) ----------
            if theta_k <= max(10.0 * tol, 1e-8) and best is not None:
                stop = "feasible yet unsteppable"
                break  # feasible yet unsteppable: return best
            if not resto_ok:
                stop = "restoration off (n_x > 8192)"
                break  # dense LM gated at scale: return best iterate
            if verbose >= 2:
                print(f"      -> restoration from theta={theta_k:.3e}")
            lam = 1e-6
            x_r = x
            theta_r = theta_k
            improved = False
            for _ in range(40):
                dxr, _ = resto_step(x_r, lam)
                if not bool(torch.isfinite(dxr).all()):
                    lam *= 10.0
                    continue
                x_try = x_r + dxr
                s_try = c_i(x_try).clamp(min=mu) if m_i else s
                _, theta_try, phi_try, _ = _read(
                    metrics_p(x_try, s_try, mu)[0])
                if theta_try < theta_r:
                    x_r, theta_r = x_try, theta_try
                    lam = max(lam / 3.0, 1e-10)
                    if theta_r <= max(0.9 * theta_k,
                                      (1.0 - GAMMA_THETA) * theta_k) and \
                            _filter_accepts(filt, theta_r, phi_try):
                        improved = True
                        break
                else:
                    lam *= 10.0
                    if lam > 1e12:
                        break
            if not improved:
                if verbose >= 2:
                    print(f"      -> restoration failed at "
                          f"theta={theta_r:.3e} lam={lam:.1e}")
                stop = "restoration failed"
                break  # infeasible or stuck: return best iterate
            # re-enter the barrier loop from the restored point
            filt.append(((1.0 - GAMMA_THETA) * theta_k,
                         phi_k - GAMMA_PHI * theta_k))
            x = x_r
            if m_i:
                s = c_i(x).clamp(min=mu)
                z = torch.clamp(z, mu / (KAPPA_SIGMA * s),
                                KAPPA_SIGMA * mu / s)
                z = z.clamp(min=1e-14)
            continue

        if verbose >= 3:
            print(f"      alpha={alpha:.3e} alpha_max={alpha_max:.3e} "
                  f"delta={delta:.1e} dphi={dphi:.3e} soc={soc_done} "
                  f"theta_t={theta_t:.3e}")
        # --- accept ------------------------------------------------------
        mark("update")
        if not f_type:
            filt.append(((1.0 - GAMMA_THETA) * theta_k,
                         phi_k - GAMMA_PHI * theta_k))
        x = x + alpha * dx_t
        if m_e:
            y = y + alpha * dy
        if m_i:
            s = (s + alpha * ds_t).clamp(min=1e-300)
            z = z + alpha_z * dz
            # kappa_Sigma safeguard: project duals into a band around the
            # central path z ~ mu/s (W-B eq. 16)
            z = torch.clamp(z, mu / (KAPPA_SIGMA * s), KAPPA_SIGMA * mu / s)
            z = z.clamp(min=1e-14)
    mark(None)

    if best is not None and best[0] < err:
        err, x, y, z, s = best
        converged = converged or err < tol
    # cross candidate: the best-KKT duals evaluated at the most-feasible
    # primal can beat both parents (one cheap kkt_error call)
    if err >= tol and best is not None and best_feas is not None:
        err_cross = _read(kkt_error(
            best_feas[0], best[2], best[3], best_feas[3], 0.0))
        if err_cross < err:
            err = err_cross
            x, s = best_feas[0], best_feas[3]
            y, z = best[2], best[3]
            best = (err, x, y, z, s)
            converged = converged or err < tol
            if verbose >= 1:
                print(f"  ipm cross candidate: kkt -> {err:.3e}")
    if err >= tol and (m_e or m_i) and recovery_ok:
        # recovery candidates: the returned (best-KKT) iterate AND the
        # most-feasible iterate seen
        cands = [(x, s)]
        if best_feas is not None:
            cands.append((best_feas[0], best_feas[3]))
        # loose gate: the fit-first recovery guards internally against
        # infeasible or objective-worsening polish outcomes
        gate = max(100.0 * tol, 1e-3 * max(1.0, theta0))
        for x_c, s_c in cands:
            theta_x = _read(metrics(x_c, s_c, 0.0)[1])
            if theta_x > gate:
                continue
            rec = _dual_recovery(x_c, s_c, err, y_seed=y, z_seed=z)
            if rec is not None and rec[0] < err:
                err, x, y, z, s = rec
                best = rec          # status reads best: keep it in sync
                converged = converged or err < tol
                if verbose >= 1:
                    print(f"  ipm dual recovery: kkt -> {err:.3e}")
            if err < acceptable_tol:
                break
    if tol <= err < acceptable_tol and m_e and recovery_ok:
        # an acceptable end point keeps the equality residual of its
        # iterate (case1354pegase's AC OPF: 2.3e-8 p.u. of bus balance in
        # the JAX package): Gauss-Newton of the primal onto c_E = 0, the
        # duals refitted there, kept while the point stays acceptable
        x_np = _polish(host(x).astype(np.float64), np.zeros(m_i, dtype=bool))
        rec = _dual_recovery_corr(t64(x_np), y, z, s)
        if rec is not None and rec[0] < acceptable_tol:
            err, x, y, z, s = rec
            best = rec
            if verbose >= 1:
                print(f"  ipm primal polish: kkt -> {err:.3e}")
    # loop exits without a factorizable KKT, feasible-yet-unsteppable or
    # after a failed restoration report "acceptable" when the best iterate
    # is; `converged` keeps its strict meaning (KKT error < tol)
    converged = err < tol
    acceptable = best is not None and best[0] < acceptable_tol
    status = "optimal" if converged else (
        "acceptable" if acceptable else "failed")
    # un-scale the duals: min σf s.t. Gc(x) = 0 has multipliers Gỹ/σ for
    # the original constraints
    inv = 1.0 / scale_f
    y_out = host(y) * inv
    z_out = host(z) * inv
    s_out = host(s)
    if m_e and g_e is not None:
        y_out = y_out * host(g_e)
    if m_i and g_i is not None:
        z_out = z_out * host(g_i)
        s_out = s_out / host(g_i)
    return IpmResult(
        x=host(x), y=y_out, z=z_out, s=s_out,
        objective=_read(f(x)) / scale_f,
        converged=converged, iterations=it, kkt_error=float(err),
        status=status, stop=stop)
