"""LDDMM geodesic shooting for point sets (counterpart of
``difficp_tpu/models/lddmm.py``).

- Vector fields v(x) = sum_j [ p_j K(x - q_j) - eta (grad K)(x - q_j) ] with
  eta = 1/lambda (gradcomponent) or 0 (LDDMM.py:24-26, 100-116).
- Hamiltonian ODE dq/dt = v(q), dp/dt = -grad_q H with the logdet divergence
  cost accumulated along the trajectory (LDDMM.py:176-227), through the fused
  RHS of ``ops/backend.py``.
- ``shoot`` is a Python time loop; dL/dp0 comes from autograd through it.
- ``optimize`` minimizes trajloss + dataloss over p0 with the lane-batched
  L-BFGS of ``utils/lbfgs.py``: frames are lanes on the leading axis.
- With grid or custom support the data are advected as external points
  ``x0`` through the fused ext RHS; the dataloss then reads the warped data.
- ``v2p`` estimates momenta from a target field (pinv, ridge, CG ridge).
- ``random_p`` samples momenta from the Bayesian prior (svd, ridge, and the
  matrix-free rff_cg above the pair limit), drawing from an explicit
  ``torch.Generator``.

Shapes: q0, p0 (..., M, D), x0 (..., N, D), masks (..., M) / (..., N).
``optimize`` takes frames on a leading K axis.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, NamedTuple, Optional

import torch

from difficp_torch.ops import backend as red
from difficp_torch.ops.solvers import (
    _masked_gram, kpinv_solve, kridge_solve, kridge_solve_cg, rff_gaussian_field,
    svd_pow,
)
from difficp_torch.utils import profiling
from difficp_torch.utils.integrators import integrate
from difficp_torch.utils.lbfgs import lbfgs_optimize, seed_alpha_for


class LDDMMConfig(NamedTuple):
    """Static model configuration (reference LDDMM.py:33-65)."""
    sigma: float = 1.0
    lambd: float = 2.0
    gradcomponent: bool = True
    withlogdet: bool = True
    nt: int = 10
    scheme: str = "Ralston"

    @property
    def eta(self) -> float:
        return 1.0 / self.lambd if self.gradcomponent else 0.0


def make_config(
    sigma: float,
    lambd: float,
    version: Optional[str] = None,
    gradcomponent: bool = True,
    withlogdet: bool = True,
    nt: int = 10,
    scheme: str = "Ralston",
) -> LDDMMConfig:
    """Version shortcut resolution (reference LDDMM.py:43-49):
    classic = no gradcomponent, no logdet; logdet = both; hybrid = logdet
    energy with a classic vector field."""
    if version == "classic":
        gradcomponent, withlogdet = False, False
    elif version == "logdet":
        gradcomponent, withlogdet = True, True
    elif version == "hybrid":
        gradcomponent, withlogdet = False, True
    elif version is not None:
        raise ValueError(f"unknown LDDMM version: {version}")
    return LDDMMConfig(
        sigma=float(sigma), lambd=float(lambd), gradcomponent=gradcomponent,
        withlogdet=withlogdet, nt=int(nt), scheme=scheme,
    )


def v(cfg: LDDMMConfig, x, q, p, qmask=None):
    """RKHS vector field at points x (LDDMM.py:100-116)."""
    return red.v_field(x, q, p, cfg.sigma, cfg.eta, qmask)


def hamiltonian(cfg: LDDMMConfig, q, p, qmask=None, order=None):
    """H(q, p) (LDDMM.py:142-159); ``order`` the rows' order at q for the
    kernels (``backend.row_order``), computed by them when None."""
    return red.hamiltonian(q, p, cfg.sigma, cfg.eta, qmask, order)


def mdivsum(cfg: LDDMMConfig, x, q, p, qmask=None, xmask=None):
    """Sum of -div(v) over data points x, per frame (LDDMM.py:120-138)."""
    return red.mdivsum(x, q, p, cfg.sigma, cfg.eta, qmask, xmask)


class ShootState(NamedTuple):
    q: torch.Tensor
    p: torch.Tensor
    cost: torch.Tensor               # accumulated divergence cost, per frame
    x: Optional[torch.Tensor] = None  # advected external points, or None


def _ode(cfg: LDDMMConfig, qmask, xmask, order, xorder):
    """Hamiltonian ODE right-hand side (LDDMM.py:176-227), fused; every step
    keeps the rows' orders of q0 and x0."""
    def fn(s: ShootState) -> ShootState:
        if s.x is None:
            vq, mgq, dcost = red.lddmm_rhs_self(
                s.q, s.p, cfg.sigma, cfg.eta, cfg.withlogdet, qmask, order)
            return ShootState(q=vq, p=mgq, cost=dcost, x=None)
        vq, mgq, dcost, vx = red.lddmm_rhs_ext(
            s.q, s.p, s.x, cfg.sigma, cfg.eta, cfg.withlogdet, qmask, xmask, order,
            xorder)
        return ShootState(q=vq, p=mgq, cost=dcost, x=vx)

    return fn


def shoot(cfg: LDDMMConfig, q0, p0, x0=None, qmask=None, xmask=None,
          save_traj: bool = False, order=None, xorder=None):
    """Simulate the geodesic ODE from (q0, p0), optionally advecting an
    external point set x0 (LDDMM.py:286-299).  ``order``: the rows' order of
    the eta = 0 self kernels at q0 (``backend.row_order``), ``xorder`` that of
    the data rows at x0 (``backend.data_order``), each computed here when
    None; one for every step, since the points move little from q0 and x0.

    :return: (final ShootState, trajectory ShootState with nt+1 leading dim
        or None)
    """
    if order is None:
        order = red.row_order(q0, cfg.sigma, qmask, cfg.eta, x0)
    if xorder is None and x0 is not None:
        xorder = red.data_order(x0, q0, cfg.sigma, xmask, cfg.eta)
    state0 = ShootState(
        q=q0, p=p0, cost=torch.zeros(q0.shape[:-2], dtype=q0.dtype,
                                     device=q0.device), x=x0)
    return integrate(_ode(cfg, qmask, xmask, order, xorder), state0, nt=cfg.nt,
                     scheme=cfg.scheme, save_traj=save_traj)


def trajloss(cfg: LDDMMConfig, q0, p0, final_cost, qmask=None, order=None):
    """LDDMM trajectory energy lambda * H(q0, p0) + divcost (LDDMM.py:318-334)."""
    return cfg.lambd * hamiltonian(cfg, q0, p0, qmask, order) + final_cost


class OptimizeResult(NamedTuple):
    """Per-frame results of ``optimize``; fields as in the JAX package."""
    p0: torch.Tensor
    final: ShootState      # arrival state of the best evaluation
    trajl: torch.Tensor
    datal: torch.Tensor
    n_steps: torch.Tensor
    change: torch.Tensor
    alpha: torch.Tensor    # warm start of the next call's first line search
    alpha_qn: torch.Tensor  # adaptive quasi-Newton trial scale
    memory: any            # L-BFGS curvature memory (utils/lbfgs.LBFGSMemory)
    grad: torch.Tensor     # dL/dp0 at the returned p0
    n_evals: torch.Tensor  # line-search loss+grad evaluations this call
    stalled: torch.Tensor  # lane converged at f32 resolution this call


def _make_lossfn_aux(cfg, dataloss, q0, x0, qmask, xmask):
    """p -> (trajloss + dataloss(arrival points), (final, trajl, datal)); the
    arrival points are the warped data x1 when x0 is given, else q1.  q0 and
    x0 are fixed, so the rows' orders are computed once here for every
    evaluation."""
    with profiling.span("lddmm.row_order"):
        order = red.row_order(q0, cfg.sigma, qmask, cfg.eta, x0)
        xorder = None if x0 is None else red.data_order(x0, q0, cfg.sigma, xmask, cfg.eta)

    def lossfn(p):
        final, _ = shoot(cfg, q0, p, x0, qmask, xmask, order=order, xorder=xorder)
        trajl = trajloss(cfg, q0, p, final.cost, qmask, order)
        datal = dataloss(final.q if x0 is None else final.x)
        return trajl + datal, (final, trajl, datal)

    return lossfn


def seed_alpha(cfg, dataloss, q0, p0, x0=None, qmask=None, xmask=None):
    """Per-frame zoom line-search seed ~ min(1, 1/||g0||) for ``optimize``."""
    lossfn = _make_lossfn_aux(cfg, dataloss, q0.detach(),
                              None if x0 is None else x0.detach(), qmask, xmask)
    return seed_alpha_for(lambda p: lossfn(p)[0], p0)


def optimize(
    cfg: LDDMMConfig,
    dataloss: Callable,
    q0,
    p0,
    x0=None,
    qmask=None,
    xmask=None,
    nmax: int = 10,
    tol: float = 1e-3,
    errthresh: float = 1e8,
    inner: int = 20,
    max_linesearch_steps: int = 25,
    alpha0=None,
    alpha_qn0=None,
    memory0=None,
    warm_vg=None,
    stall0=None,
) -> OptimizeResult:
    """min_{p0} trajloss(p0) + dataloss(arrival points) (LDDMM.py:338-398),
    for K frames in lockstep: q0, p0 (K, M, D), ``dataloss(pts)`` -> (K,).
    ``dataloss`` reads the warped data points x1 when ``x0`` is given, else
    the arrival support q1.

    ``warm_vg``: ``(grad, final, trajl, datal)`` of a previous result at
    ``p0`` on the IDENTICAL objective; skips the entry value+grad.
    """
    lossfn_aux = _make_lossfn_aux(cfg, dataloss, q0.detach(),
                                  None if x0 is None else x0.detach(), qmask,
                                  xmask)

    if warm_vg is not None:
        grad0, final0, trajl0, datal0 = warm_vg
        value0 = trajl0 + datal0
        aux0 = (final0, trajl0, datal0)
    else:
        grad0 = value0 = aux0 = None
    res = lbfgs_optimize(
        lossfn_aux, p0, nmax=nmax, inner=inner, tol=tol,
        errthresh=errthresh, max_linesearch_steps=max_linesearch_steps,
        alpha0=alpha0, alpha_qn0=alpha_qn0, has_aux=True, memory0=memory0,
        value0=value0, grad0=grad0, aux0=aux0, stall0=stall0,
    )
    final, trajl, datal = res.aux
    return OptimizeResult(
        p0=res.params, final=final, trajl=trajl, datal=datal,
        n_steps=res.n_steps, change=res.change, alpha=res.alpha,
        alpha_qn=res.alpha_qn, memory=res.memory, grad=res.grad,
        n_evals=res.n_evals, stalled=res.stalled,
    )


def v2p(cfg: LDDMMConfig, q, v_target, rcond=1e-3, alpha=1e-4,
        version: str = "pinv", qmask=None):
    """Estimate momenta p with v(q, q, p) ~= v_target (ill-posed; pinv or
    ridge regularized, LDDMM.py:235-253).  Above the dense pair limit the
    O(M^3) solves are out of reach: "pinv" and "ridge" then switch to the
    matrix-free CG ridge solve, as in the JAX package.  With the
    gradcomponent field the right-hand side is v_target + eta grad_kred(q,
    q), through the dispatched grad_kred."""
    if cfg.eta != 0.0:
        v_target = v_target + cfg.eta * red.grad_kred(q, q, cfg.sigma, qmask)
    m = q.shape[-2]
    if version in ("pinv", "ridge", "ridge_keops", "ridge_pytorch") and (
            m * m > red.DENSE_PAIR_LIMIT):
        version = "ridge_cg"
    if version == "pinv":
        return kpinv_solve(q, v_target, cfg.sigma, rcond=rcond, mask=qmask)
    if version in ("ridge", "ridge_keops", "ridge_pytorch"):
        return kridge_solve(q, v_target, cfg.sigma, alpha=alpha, mask=qmask)
    if version == "ridge_cg":
        return kridge_solve_cg(q, v_target, cfg.sigma, alpha=alpha, mask=qmask)
    raise ValueError(f"unknown v2p version: {version}")


def random_p(cfg: LDDMMConfig, q, generator: Optional[torch.Generator] = None,
             rcond=1e-3, alpha=1e-4, version: str = "svd", qmask=None,
             n_features=2048, cg_tol=1e-6, cg_maxiter=500, zeta=None):
    """Momenta sampled from the Bayesian prior P(p) ~ exp(-lambda H(q, p))
    (LDDMM.py:257-280), eta == 0 only.  q (..., M, D), frames on leading
    axes; draws come from ``generator`` on q's device.

    'svd' and 'ridge' take a dense root of K(q, q) (O(M^2) memory, O(M^3)
    compute), applied to standard normals ``zeta`` (drawn when None).
    Above the dense pair limit 'ridge' re-routes to 'rff_cg' with a warning:
    u ~ N(0, K + alpha I) as a random-Fourier-feature field plus sqrt(alpha)
    white noise, then p = (K + alpha I)^{-1} u / sqrt(lambda) by the
    matrix-free CG ridge solve, whose matvec is the dispatched kernel-sum
    (the same law as 'ridge' up to the O(1/sqrt(n_features)) RFF covariance
    error).  'svd' has no matrix-free form and raises there."""
    if cfg.eta != 0.0:
        raise NotImplementedError("random_p requires gradcomponent=False")
    m = q.shape[-2]
    if m * m > red.DENSE_PAIR_LIMIT and version == "ridge":
        warnings.warn(
            f"random_p: M={m} exceeds the dense pair limit; rerouting "
            "version='ridge' to the matrix-free 'rff_cg' sampler (same "
            "target distribution, up to O(1/sqrt(n_features)) RFF "
            "covariance error). Pass version='rff_cg' to silence.",
            stacklevel=2)
        version = "rff_cg"
    if version == "rff_cg":
        f = rff_gaussian_field(q, cfg.sigma, q.shape[-1], n_features, generator)
        xi = torch.randn(q.shape, generator=generator, dtype=q.dtype, device=q.device)
        u = f + math.sqrt(alpha) * xi
        if qmask is not None:
            u = u * qmask[..., None]
        with torch.no_grad():
            p = kridge_solve_cg(q, u, cfg.sigma, alpha=alpha, mask=qmask, tol=cg_tol,
                                maxiter=cg_maxiter)
        return p / math.sqrt(cfg.lambd)
    if m * m > red.DENSE_PAIR_LIMIT:
        raise ValueError(
            f"random_p version='{version}' needs a dense (M, M) kernel matrix "
            f"root; M={m} is above the dense pair limit ({red.DENSE_PAIR_LIMIT} "
            "pairs). Use version='rff_cg' (matrix-free pathwise sampling, same "
            "distribution as 'ridge'), or sample on a decimated or grid "
            "support set.")
    if version not in ("svd", "ridge"):
        raise ValueError(f"unknown random_p version: {version}")
    k = _masked_gram(q, cfg.sigma, qmask)
    if zeta is None:
        zeta = torch.randn(q.shape, generator=generator, dtype=q.dtype, device=q.device)
    zeta = zeta / math.sqrt(cfg.lambd)
    if version == "svd":
        p = svd_pow(k, -0.5, rcond) @ zeta
    else:
        eye = torch.eye(m, dtype=q.dtype, device=q.device)
        chol = torch.linalg.cholesky(k + alpha * eye)
        p = torch.linalg.solve_triangular(chol, zeta, upper=False)
    if qmask is not None:
        p = p * qmask[..., None]
    return p


def quad_dataloss(y, cmul: float = 1.0):
    """Basic quadratic landmark dataloss functor: x -> cmul * |x - y|^2 / 2
    per frame (reference BasicQuadLossFunctor, LDDMM.py:303-314)."""
    y = y.detach()

    def dataloss(x):
        return ((x - y) ** 2).sum((-2, -1)) * cmul / 2.0

    return dataloss
