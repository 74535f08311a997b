"""Ad hoc auto-calibration of lambda_LDDMM (counterpart of
``calibrate_lambda_lddmm`` in ``difficp_tpu/models/calibration.py``;
reference diffICP/core/calibration.py:25-79, flagged experimental there).

A cheap general-affine ICP of x onto x2 gives a reference quadratic loss
L_ref; v2p gives start momenta for the affine displacement and their energy
H0_ref; the relaxed objective H0_ref * exp(quadloss / L_ref) + ||a0||^2 is
then minimized over the momenta, and lambda = L_ref / H(q, p0).  At eta = 0
above the dense pair limit, v2p's CG matvec and every Ralston stage of the
shoots run the self RHS forward kernel, and each gradient its backward.

``calibrate_noise_std`` does the same for the standard algorithm's noise_std:
a general-affine standard two-set gives the reference RKHS loss L_ref, and
noise_std = sqrt(L_ref / H(q, p0)) after the same relaxed optimization on the
RKHS loss (calibration.py:64-99 of the JAX package).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from difficp_torch.models import lddmm as lddmm_mod
from difficp_torch.utils.spec import as_tensor, resolve_device


class AffineReference(NamedTuple):
    x: torch.Tensor   # (N, D) the points to register
    y: torch.Tensor   # (N, D) their GMM targets after the affine ICP
    sigref: float     # the ICP's final GMM sigma
    l_ref: float      # sum |x1 - y|^2 / (2 sigref^2)


class LambdaCalibration(NamedTuple):
    lam: float
    l_ref: float
    h0_ref: float       # H(x, a0) of v2p's momenta for y - x
    deformation: float  # H(x, p0) at the optimum


def affine_reference(x, x2, device=None) -> AffineReference:
    """The general-affine ICP of x onto x2's points (calibration.py:28-45):
    its targets, final sigma and quadratic loss."""
    from difficp_torch.api.icp_two_set import icp_two_set

    device = resolve_device(device)
    if isinstance(x2, torch.Tensor):
        x2 = x2.detach().cpu().numpy()
    psr, _ = icp_two_set(
        x, x2, {"sigma": None, "optimize_sigma": True, "outlier_weight": None},
        {"type": "general_affine"},
        optim_options={"max_iterations": 30, "convergence_tolerance": 1e-4,
                       "max_repeat_GMM": 25},
        printstuff=False, device=device)
    n0 = int(psr.structs[0].n[0])
    y = psr.struct_view(psr.y, 0)[0][:n0]
    x1 = psr.struct_view(psr.x1, 0)[0][:n0]
    sigref = float(psr.gmm[0].sigma)
    l_ref = float(((x1 - y) ** 2).sum() / (2.0 * sigref**2))
    return AffineReference(x=as_tensor(x, device), y=y, sigref=sigref, l_ref=l_ref)


def start_momenta(ref: AffineReference, sigma_lddmm):
    """The calibration's LDDMM config (classic, Ralston, nt = 10), v2p's
    momenta (rcond 1e-2) for the affine displacement y - x, as one frame, and
    their energy H0_ref (calibration.py:47-51)."""
    lcfg = lddmm_mod.make_config(sigma=sigma_lddmm, lambd=1.0, version="classic",
                                 scheme="Ralston", nt=10)
    q = ref.x[None]
    with torch.no_grad():
        a0 = lddmm_mod.v2p(lcfg, q, ref.y[None] - q, rcond=1e-2)
        h0_ref = float(lddmm_mod.hamiltonian(lcfg, q, a0)[0])
    return lcfg, a0, h0_ref


def lambda_from_reference(ref: AffineReference, sigma_lddmm) -> LambdaCalibration:
    """lambda = L_ref / H(x, p0) from the affine reference
    (calibration.py:47-63), from ``start_momenta``; the exponential loss's
    exponent clipped at 30 (the reference notes it overflows,
    calibration.py:56-57)."""
    lcfg, a0, h0_ref = start_momenta(ref, sigma_lddmm)
    q, y, l_ref = ref.x[None], ref.y[None], ref.l_ref

    def exp_loss(pts):
        ql = ((pts - y) ** 2).sum((-2, -1)) / (2.0 * ref.sigref**2)
        return h0_ref * torch.exp(torch.clamp(ql / l_ref, max=30.0))

    res = lddmm_mod.optimize(lcfg, exp_loss, q, a0, tol=1e-3, nmax=20)
    with torch.no_grad():
        deformation = float(lddmm_mod.hamiltonian(lcfg, q, res.p0)[0])
    return LambdaCalibration(lam=l_ref / deformation, l_ref=l_ref, h0_ref=h0_ref,
                             deformation=deformation)


def calibrate_lambda_lddmm(x, x2, sigma_lddmm, device=None) -> float:
    """Predict lambda_LDDMM for diffICP registration of x onto x2."""
    return lambda_from_reference(affine_reference(x, x2, device), sigma_lddmm).lam


def calibrate_noise_std(x, x2, sigma_lddmm, device=None) -> float:
    """Predict noise_std for 'standard' diffeomorphic registration of the
    template x onto the data x2 (the JAX package's calibration.py:64-99): a
    general-affine standard_two_set at sigma_data = x2's intrinsic scale
    gives L_ref; v2p (rcond 1e-2) gives start momenta for the affine
    displacement, and H0_ref; noise_std = sqrt(L_ref / H(x, p0)) after the
    classic Euler (nt = 10) optimization of H0_ref exp(L / L_ref) over the
    momenta, the exponent clipped at 30."""
    from difficp_torch.api.standard_two_set import standard_two_set
    from difficp_torch.models.psr_standard import data_distance
    from difficp_torch.utils.point_sets import intrinsic_scale

    device = resolve_device(device)
    xt, x2t = as_tensor(x, device), as_tensor(x2, device)
    psr, _ = standard_two_set(
        xt, x2t, {"type": "general_affine", "sigma_data": intrinsic_scale(x2t)},
        optim_options={"max_iterations": 30, "convergence_tolerance": 1e-4},
        printstuff=False, device=device)
    l_ref = float(psr.E)

    lcfg = lddmm_mod.make_config(sigma=sigma_lddmm, lambd=1.0, version="classic",
                                 scheme="Euler", nt=10)
    q = xt[None]
    with torch.no_grad():
        tx = psr.Registration().apply(xt)[None]
        a0 = lddmm_mod.v2p(lcfg, q, tx - q, rcond=1e-2)
        h0_ref = float(lddmm_mod.hamiltonian(lcfg, q, a0)[0])
    y = x2t[None]

    def exp_loss(pts):
        loss = data_distance(pts, y, psr.data_sigma)
        return h0_ref * torch.exp(torch.clamp(loss / l_ref, max=30.0))

    res = lddmm_mod.optimize(lcfg, exp_loss, q, a0, tol=1e-3, nmax=20)
    with torch.no_grad():
        regl = float(lddmm_mod.hamiltonian(lcfg, q, res.p0)[0])
    return math.sqrt(l_ref / regl)
