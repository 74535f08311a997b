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


def kbase(x, y, sigma, mask_y=None):
    """sum_j K(x_i - y_j) m_j (reference kernel.py:131,178)."""
    _, _, k = _kmat(x, y, sigma, mask_y)
    return k.sum(-1)


def kred_scal(x, y, d, sigma, mask_y=None):
    """sum_j K(x_i - y_j) m_j d_j, scalar payload d (..., N) (reference
    kernel.py:134,182)."""
    _, _, k = _kmat(x, y, sigma, mask_y)
    return (k @ d[..., None])[..., 0]


def kred(x, y, b, sigma, mask_y=None):
    """sum_j K(x_i - y_j) m_j b_j, the kernel-sum convolution (reference
    kernel.py:138)."""
    _, _, k = _kmat(x, y, sigma, mask_y)
    return k @ b


def grad_kred(x, y, sigma, mask_y=None):
    """sum_j (grad K)(x_i - y_j) m_j = sum_j (y_j - x_i) K m_j / s^2
    (reference kernel.py:142,190)."""
    diff, _, k = _kmat(x, y, sigma, mask_y)
    return -(k[..., None] * diff).sum(-2) / sigma**2


def grad_kred_rev(x, y, d, sigma, mask_x=None):
    """Y(j) = sum_i sum_e (grad_e K)(x_i - y_j) m_i d_i^e, the reversed-axis
    sum (reference kernel.py:146,194)."""
    diff, _, k = _kmat(x, y, sigma, None)
    if mask_x is not None:
        k = k * mask_x[..., :, None]
    proj = (-diff * d[..., :, None, :]).sum(-1) / sigma**2
    return (k * proj).sum(-2)


def ddkred(x, y, b, sigma, mask_y=None):
    """X(i, e) = sum_j (grad_e K)(x_i - y_j) m_j b_j^e, the diagonal
    differential (reference kernel.py:150,198)."""
    diff, _, k = _kmat(x, y, sigma, mask_y)
    return (k[..., None] * -diff * b[..., None, :, :]).sum(-2) / sigma**2


def gendk_red(x, y, b, c, sigma, mask_y=None):
    """X(i) = sum_j (grad K)(x_i - y_j) m_j (c_i . b_j) (reference
    kernel.py:154,202)."""
    diff, _, k = _kmat(x, y, sigma, mask_y)
    dots = c @ b.transpose(-1, -2)
    return ((k * dots)[..., None] * -diff).sum(-2) / sigma**2


def hessk_red(x, y, b, c, sigma, mask_y=None):
    """X(i) = sum_j (Hess K)(x_i - y_j) m_j (c_i - b_j)
           = sum_j ([(x_i - y_j).(c_i - b_j)] (x_i - y_j) / s^4
                    - (c_i - b_j) / s^2) K m_j
    (reference kernel.py:158,284-286)."""
    diff, _, k = _kmat(x, y, sigma, mask_y)
    cb = c[..., :, None, :] - b[..., None, :, :]
    proj = (diff * cb).sum(-1)
    term = diff * proj[..., None] / sigma**4 - cb / sigma**2
    return (k[..., None] * term).sum(-2)


def lapk_red(x, y, sigma, mask_y=None):
    """X(i) = sum_j (Lap K)(x_i - y_j) m_j (reference kernel.py:163,206,
    LapK kernel.py:265-267)."""
    _, d2, k = _kmat(x, y, sigma, mask_y)
    dim = x.shape[-1]
    return (k * (d2 / sigma**4 - dim / sigma**2)).sum(-1)


def gradlapk_red(x, y, sigma, mask_y=None):
    """X(i) = sum_j (grad Lap K)(x_i - y_j) m_j
           = sum_j (|z|^2 / s^6 - (D + 2) / s^4) (y_j - x_i) K m_j,
    z = x_i - y_j (reference kernel.py:167,289-292)."""
    diff, d2, k = _kmat(x, y, sigma, mask_y)
    dim = x.shape[-1]
    coef = k * (d2 / sigma**6 - (dim + 2) / sigma**4)
    return (coef[..., None] * -diff).sum(-2)


def v_field(x, q, p, sigma, eta, mask_q=None):
    """RKHS vector field at points x (LDDMM.py:100-116):
    v(x_i) = sum_j [ p_j K(x_i - q_j) - eta (grad K)(x_i - q_j) ]."""
    diff, _, k = _kmat(x, q, sigma, mask_q)
    out = k @ p
    if eta != 0.0:
        out = out - eta * (k[..., None] * -diff).sum(-2) / sigma**2
    return out


def mdivsum(x, q, p, sigma, eta, mask_q=None, mask_x=None):
    """sum over the data points x of -div(v)(x_i), per frame (reference
    LDDMM.py:120-138, ``(p * GradKRed(q, x)).sum() + eta *
    LapKRed(q, x).sum()`` there): reductions over the data x_j for each
    support point q_i."""
    diff, d2, k = _kmat(q, x, sigma, mask_x)
    if mask_q is not None:
        k = k * mask_q[..., :, None]
    grad_term = (k[..., None] * -diff * p[..., :, None, :]).sum((-3, -2, -1)) / sigma**2
    if eta == 0.0:
        return grad_term
    dim = q.shape[-1]
    return grad_term + eta * (k * (d2 / sigma**4 - dim / sigma**2)).sum((-2, -1))


def lddmm_rhs_ext(q, p, x, sigma, eta, withlogdet, mask_q=None, mask_x=None):
    """Fused ODE right-hand side with an external advected point set x:
    (vq, -Gq, dcost, vx), the divergence cost evaluated at the data points
    (LDDMM.py:219-227)."""
    vq, mgq, _ = lddmm_rhs_self(q, p, sigma, eta, False, mask_q)
    diff, d2, k = _kmat(x, q, sigma, mask_q)  # (..., N, M)
    sig2 = sigma**2
    vx = k @ p
    if eta != 0.0:
        vx = vx - eta * (k[..., None] * -diff).sum(-2) / sig2
    if withlogdet:
        km = k * mask_x[..., :, None] if mask_x is not None else k
        # -div v(x_i) = sum_j p_j.(x_i - q_j) K / s^2 (+ the eta Laplacian)
        dcost = -(km[..., None] * -diff * p[..., None, :, :]).sum((-3, -2, -1)) / sig2
        if eta != 0.0:
            dim = q.shape[-1]
            dcost = dcost + eta * (km * (d2 / sigma**4 - dim / sig2)).sum((-2, -1))
    else:
        dcost = torch.zeros(q.shape[:-2], dtype=q.dtype, device=q.device)
    if mask_x is not None:
        vx = vx * mask_x[..., None]
    return vq, mgq, dcost, vx


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


def check_coverage(x, y, sigma, r_threshold, mask_x=None, mask_y=None):
    """True for points x_i farther than r_threshold * sigma from every y_j
    (kernel.py:324-328)."""
    uncov = min_sqdist(x, y, mask_y) > (r_threshold * sigma) ** 2
    if mask_x is not None:
        uncov = uncov & (mask_x > 0)
    return uncov
