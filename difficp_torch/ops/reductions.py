"""Masked Gaussian pair reductions, dense (counterpart of
``difficp_tpu/ops/reductions.py``).

The (M, N) pair matrices are materialized, so these are for problems under
``backend.DENSE_PAIR_LIMIT``.  Gaussian kernel K(z) = exp(-|z|^2 / 2 s^2).
Shapes: x (..., M, D), y (..., N, D), masks (..., M) / (..., N) float
(1 = real point).  Leading dimensions are frames.
"""

from __future__ import annotations

import torch


def _kmat(x, y, sigma, mask_y=None):
    """diff (..., M, N, D), sqdist (..., M, N), K (..., M, N) with mask_y
    folded into K."""
    diff = x[..., :, None, :] - y[..., None, :, :]
    d2 = (diff * diff).sum(-1)
    k = torch.exp(-d2 / (2.0 * sigma**2))
    if mask_y is not None:
        k = k * mask_y[..., None, :]
    return diff, d2, k


def hamiltonian(q, p, sigma, eta, mask_q=None):
    """H(q,p) = 1/2 sum_ij [ (p_i.p_j) K - eta (p_i-p_j).(grad K) - eta^2 Lap K ]
    over K(q_i - q_j).  (reference LDDMM.py:142-159)"""
    diff, d2, k = _kmat(q, q, sigma, mask_q)
    if mask_q is not None:
        k = k * mask_q[..., :, None]
    h = 0.5 * (k * (p @ p.transpose(-1, -2))).sum((-2, -1))
    if eta != 0.0:
        dim = q.shape[-1]
        bsum = (k[..., None] * -diff * p[..., :, None, :]).sum((-3, -2, -1)) / sigma**2
        csum = (k * (d2 / sigma**4 - dim / sigma**2)).sum((-2, -1))
        h = h - eta * bsum - 0.5 * eta**2 * csum
    return h


def lddmm_rhs_self(q, p, sigma, eta, withlogdet, mask_q=None):
    """Fused ODE right-hand side when data points == support points q.

    Returns (vq, minus_Gq, dcost):
      vq_i   = sum_j [p_j K_ij - eta gradK_ij]                  (LDDMM.py:100-116)
      Gq_i   = GenDKRed - eta HessKRed - eta^2 GradLapKRed      (LDDMM.py:196-203)
      dcost  = mdivsum(q, q, p) if withlogdet else 0            (LDDMM.py:210-216)
    """
    diff, d2, k = _kmat(q, q, sigma, mask_q)
    dim = q.shape[-1]
    sig2 = sigma**2

    vq = k @ p
    dots = p @ p.transpose(-1, -2)
    gq = ((k * dots)[..., None] * -diff).sum(-2) / sig2

    if eta != 0.0:
        grad_red = (k[..., None] * -diff).sum(-2) / sig2
        vq = vq - eta * grad_red
        cb = p[..., :, None, :] - p[..., None, :, :]
        proj = (diff * cb).sum(-1)
        hess = (k[..., None] * (diff * proj[..., None] / sig2**2 - cb / sig2)).sum(-2)
        coef = k * (d2 / sigma**6 - (dim + 2) / sigma**4)
        glap = (coef[..., None] * -diff).sum(-2)
        gq = gq - eta * hess - eta**2 * glap

    if withlogdet:
        km = k * mask_q[..., :, None] if mask_q is not None else k
        dcost = (km[..., None] * -diff * p[..., :, None, :]).sum((-3, -2, -1)) / sig2
        if eta != 0.0:
            dcost = dcost + eta * (km * (d2 / sigma**4 - dim / sigma**2)).sum((-2, -1))
    else:
        dcost = torch.zeros(q.shape[:-2], dtype=q.dtype, device=q.device)

    if mask_q is not None:
        vq = vq * mask_q[..., None]
        gq = gq * mask_q[..., None]
    return vq, -gq, dcost


def min_sqdist(x, y, mask_y=None):
    """min_j |x_i - y_j|^2 (masked y excluded)."""
    diff = x[..., :, None, :] - y[..., None, :, :]
    d2 = (diff * diff).sum(-1)
    if mask_y is not None:
        d2 = torch.where(mask_y[..., None, :] > 0, d2, torch.inf)
    return d2.min(-1).values


def second_min_sqdist(x, mask=None):
    """Second-smallest |x_i - x_j|^2 over j (nearest neighbour excluding
    self), the intrinsic scale of a point set (reference point_sets.py:23-25)."""
    diff = x[..., :, None, :] - x[..., None, :, :]
    d2 = (diff * diff).sum(-1)
    n = x.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d2 = torch.where(eye, torch.inf, d2)
    if mask is not None:
        d2 = torch.where(mask[..., None, :] > 0, d2, torch.inf)
    return d2.min(-1).values
