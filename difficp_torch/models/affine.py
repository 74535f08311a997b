"""Affine registration model (rigid / similarity / general affine /
translation) with an optional logdet term: closed-form weighted fits
(counterpart of ``difficp_tpu/models/affine.py``; reference
diffICP/core/affine.py:21-172).

The registration energy is

    E(M, t) = sum_n z_n |M x_n + t - y_n|^2 - sum_n w_n log |M|

minimized in closed form per version (affine.py:100-166): SVD Procrustes with
a determinant correction for rigid and similarity, a linear solve, or
completing the square with two Cholesky factors and an SVD for general affine
with logdet.  Frames are on leading axes: every fit of an atlas runs in one
batched call of ``torch.linalg`` on D x D matrices.  Masked points enter with
zero weights z and w.  A frame whose A or F is not positive definite, or
whose system is singular, gets NaN factors, as ``jnp.linalg`` gives, and so
a NaN fit; the other frames of the batch are not touched.

``shoot`` (the continuous trajectory, matrix logarithm) and ``skew_log`` run
on the host with scipy, as in the JAX package and the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class AffineConfig(NamedTuple):
    version: str = "rigid"  # rigid | similarity | general_affine | translation
    withlogdet: bool = True
    with_t: bool = True
    nt: int = 10


class AffineFit(NamedTuple):
    m: torch.Tensor      # (..., D, D)
    t: torch.Tensor      # (..., D)
    tx: torch.Tensor     # (..., N, D) transformed points
    datal: torch.Tensor  # (...) quadratic data loss
    regl: torch.Tensor   # (...) logdet regularization loss


def regloss(cfg: AffineConfig, m, w):
    """- sum(w) * log|det M| if withlogdet (affine.py:76-80)."""
    if not cfg.withlogdet:
        return torch.zeros(m.shape[:-2], dtype=m.dtype, device=m.device)
    _, logabs = torch.linalg.slogdet(m)
    return -w.sum(-1) * logabs


def _tr(a):
    return a.transpose(-1, -2)


def _nan_where(info, out):
    """out, NaN in each frame whose factorization failed (info != 0): what
    jnp.linalg returns there, where torch.linalg would raise for the whole
    batch."""
    return torch.where((info != 0).reshape(info.shape + (1,) * (out.dim() - info.dim())),
                       torch.nan, out)


def _cholesky(a):
    return _nan_where(*reversed(torch.linalg.cholesky_ex(a)))


def _solve(a, b):
    return _nan_where(*reversed(torch.linalg.solve_ex(a, b)))


def _inv(a):
    return _nan_where(*reversed(torch.linalg.inv_ex(a)))


def _svd(a):
    """(u, vh) of a, NaN in each frame where a is not finite (torch.linalg.svd
    raises on such input)."""
    bad = ~torch.isfinite(a).all(-1).all(-1)
    u, _, vh = torch.linalg.svd(torch.where(bad[..., None, None], 0.0, a))
    return _nan_where(bad, u), _nan_where(bad, vh)


def optimize(cfg: AffineConfig, x, y, z, w=None, mask=None) -> AffineFit:
    """Closed-form minimization of E(M, t) (affine.py:89-172).

    :param x: (..., N, D) data points; :param y: (..., N, D) targets.
    :param z: (..., N) data weights; :param w: (..., N) logdet weights
        (default 1).  :param mask: (..., N) padding mask folded into both.
    """
    d = x.shape[-1]
    if w is None:
        w = torch.ones_like(z)
    if mask is not None:
        z = z * mask
        w = w * mask
    zx = z[..., None]
    if cfg.with_t:
        zsum = z.sum(-1)[..., None]
        xm = (x * zx).sum(-2) / zsum
        ym = (y * zx).sum(-2) / zsum
        xc, yc = x - xm[..., None, :], y - ym[..., None, :]
    else:
        xc, yc = x, y

    # E = Tr(A M' M) - 2 Tr(B' M) - c log|M| + const  (affine.py:108-111)
    b = _tr(yc) @ (zx * xc)
    c = w.sum(-1)[..., None, None]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)

    if cfg.version in ("rigid", "similarity"):
        u, vh = _svd(b)
        corr = eye.expand(b.shape).clone()
        corr[..., -1, -1] = torch.linalg.det(u) * torch.linalg.det(vh)
        r = u @ corr @ vh
        if cfg.version == "rigid":
            m = r
        else:
            tr_a = ((xc**2).sum(-1) * z).sum(-1)
            tr_br = (b * r).sum((-2, -1))
            if cfg.withlogdet:
                lam = (tr_br + torch.sqrt(tr_br**2 + 2 * c[..., 0, 0] * d * tr_a)) / (2 * tr_a)
            else:
                lam = tr_br / tr_a
            m = lam[..., None, None] * r
    elif cfg.version == "general_affine":
        a = _tr(xc) @ (zx * xc)
        if not cfg.withlogdet:
            # M = B A^{-1}
            m = _tr(_solve(_tr(a), _tr(b)))
        else:
            # complete the square (affine.py:140-158)
            k = 0.5 * _tr(_solve(_tr(a), _tr(b)))
            f = 0.5 * (b @ _tr(k) + c * eye)
            f = 0.5 * (f + _tr(f))
            ar = _cholesky(a)
            fr = _cholesky(f)
            wmat = _tr(ar) @ _inv(b) @ fr
            u, vh = _svd(wmat)
            q = _tr(u @ vh)
            m = k + fr @ q @ _inv(ar)
    elif cfg.version == "translation":
        m = eye.expand(b.shape).clone()
    else:
        raise ValueError(f"unknown affine version: {cfg.version}")

    if cfg.with_t:
        t = ym - (m @ xm[..., None])[..., 0]
    else:
        t = torch.zeros(x.shape[:-2] + (d,), dtype=x.dtype, device=x.device)

    tx = apply(m, t, x)
    datal = (((y - tx) ** 2).sum(-1) * z).sum(-1)
    return AffineFit(m=m, t=t, tx=tx, datal=datal, regl=regloss(cfg, m, w))


def apply(m, t, x):
    """T(X) = X M' + t'."""
    return x @ _tr(m) + t[..., None, :]


def backward(m, t, y):
    """Inverse transform: X with T(X) = Y (reference registrations.py:117-122):
    solve M Z = (Y - t)'."""
    return _tr(torch.linalg.solve(m, _tr(y - t[..., None, :])))


def _host64(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def shoot(cfg: AffineConfig, m, t, x, nt: Optional[int] = None):
    """Continuous interpolation path of the affine map (affine.py:50-71):
    around the invariant point p = (I - M)^{-1} t, the positions at time u
    are p + (x - p) exp(u log M)'.  On the host (scipy logm / expm, as the
    reference); a list of nt numpy position arrays.  Visualization only."""
    from scipy.linalg import expm, logm

    nt = cfg.nt if nt is None else nt
    m_np, t_np, x_np = _host64(m), _host64(t), _host64(x)
    d = m_np.shape[0]
    ts = np.linspace(0.0, 1.0, nt)
    if np.allclose(m_np, np.eye(d)):
        return [x_np + u * t_np[None, :] for u in ts]
    p = np.linalg.solve(np.eye(d) - m_np, t_np)
    log_m = logm(m_np, disp=False)[0].real
    return [p[None, :] + (x_np - p[None, :]) @ expm(u * log_m).T for u in ts]


def skew_log(m):
    """Host-side skew-symmetric part of log(M), the rigid-motion
    parametrization of the standard algorithm's iterative affine fit
    (reference PSR_standard.py:653-666)."""
    from scipy.linalg import logm

    lm = logm(_host64(m), disp=False)[0].real
    return ((lm - lm.T) / 2).astype(np.float32)
