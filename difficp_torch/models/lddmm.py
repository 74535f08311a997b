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

Shapes: q0, p0 (..., M, D), masks (..., M).  ``optimize`` takes frames on a
leading K axis.  External advected points (``x0``) come with the grid-support
slice and raise here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from difficp_torch.ops import backend as red
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


def hamiltonian(cfg: LDDMMConfig, q, p, qmask=None):
    """H(q, p) (LDDMM.py:142-159)."""
    return red.hamiltonian(q, p, cfg.sigma, cfg.eta, qmask)


class ShootState(NamedTuple):
    q: torch.Tensor
    p: torch.Tensor
    cost: torch.Tensor               # accumulated divergence cost, per frame
    x: Optional[torch.Tensor] = None  # advected external points (not ported)


def _ode(cfg: LDDMMConfig, qmask):
    def fn(s: ShootState) -> ShootState:
        vq, mgq, dcost = red.lddmm_rhs_self(
            s.q, s.p, cfg.sigma, cfg.eta, cfg.withlogdet, qmask)
        return ShootState(q=vq, p=mgq, cost=dcost, x=None)

    return fn


def shoot(cfg: LDDMMConfig, q0, p0, x0=None, qmask=None, xmask=None,
          save_traj: bool = False):
    """Simulate the geodesic ODE from (q0, p0) (LDDMM.py:286-299).

    :return: (final ShootState, trajectory ShootState with nt+1 leading dim
        or None)
    """
    if x0 is not None:
        raise NotImplementedError(
            "advecting external points (grid or decim support) is not ported "
            "yet: it comes with the grid-support slice")
    state0 = ShootState(
        q=q0, p=p0, cost=torch.zeros(q0.shape[:-2], dtype=q0.dtype,
                                     device=q0.device), x=None)
    return integrate(_ode(cfg, qmask), state0, nt=cfg.nt, scheme=cfg.scheme,
                     save_traj=save_traj)


def trajloss(cfg: LDDMMConfig, q0, p0, final_cost, qmask=None):
    """LDDMM trajectory energy lambda * H(q0, p0) + divcost (LDDMM.py:318-334)."""
    return cfg.lambd * hamiltonian(cfg, q0, p0, qmask) + final_cost


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


def _make_lossfn(cfg, dataloss, q0, qmask):
    def lossfn(p):
        final, _ = shoot(cfg, q0, p, None, qmask)
        return trajloss(cfg, q0, p, final.cost, qmask) + dataloss(final.q)

    return lossfn


def seed_alpha(cfg, dataloss, q0, p0, x0=None, qmask=None, xmask=None):
    """Per-frame zoom line-search seed ~ min(1, 1/||g0||) for ``optimize``."""
    if x0 is not None:
        raise NotImplementedError(
            "external points come with the grid-support slice")
    return seed_alpha_for(_make_lossfn(cfg, dataloss, q0.detach(), qmask), p0)


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

    ``warm_vg``: ``(grad, final, trajl, datal)`` of a previous result at
    ``p0`` on the IDENTICAL objective; skips the entry value+grad.
    """
    if x0 is not None:
        raise NotImplementedError(
            "external points (grid or decim support) come with the "
            "grid-support slice")
    q0 = q0.detach()

    def lossfn_aux(p):
        final, _ = shoot(cfg, q0, p, None, qmask)
        trajl = trajloss(cfg, q0, p, final.cost, qmask)
        datal = dataloss(final.q)
        return trajl + datal, (final, trajl, datal)

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


def quad_dataloss(y, cmul: float = 1.0):
    """Basic quadratic landmark dataloss functor: x -> cmul * |x - y|^2 / 2
    per frame (reference BasicQuadLossFunctor, LDDMM.py:303-314)."""
    y = y.detach()

    def dataloss(x):
        return ((x - y) ** 2).sum((-2, -1)) * cmul / 2.0

    return dataloss
