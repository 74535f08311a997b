"""RKHS kernel solves (counterpart of ``difficp_tpu/ops/solvers.py``):
``SVDpow`` (kernel.py:31-44), ``KpinvSolve`` (kernel.py:227-232) and
``KridgeSolve`` (kernel.py:234-242) with ``torch.linalg``, a matrix-free
conjugate-gradient ridge solve whose matvec is the dispatched
``backend.kred``, and a random-Fourier-feature Gaussian field.  They run at
set-up time only (momentum initialization and projection, prior sampling,
LDDMM.py:235-280).

Masked convention: padded support rows are replaced by identity rows in the
kernel matrix and zeroed right-hand sides, so solutions carry exact zeros in
padded slots.  Shapes: q, v (..., M, D), mask (..., M); leading dimensions
are frames.
"""

from __future__ import annotations

import torch


def svd_pow(m, alpha: float, rcond: float | None = None):
    """SVD-based (pseudo-)power of a hermitian matrix, m ** alpha; with
    ``rcond`` the singular values below rcond * s_max are dropped (crucial
    when alpha < 0; reference kernel.py:31-44)."""
    u, s, vh = torch.linalg.svd(m)
    if rcond is not None:
        keep = s > rcond * s[..., :1]
        spow = torch.where(keep, torch.where(keep, s, torch.ones_like(s)) ** alpha,
                           torch.zeros_like(s))
    else:
        spow = s**alpha
    return (u * spow[..., None, :]) @ vh


def _masked_gram(q, sigma, mask=None, diag_boost=0.0):
    d2 = ((q[..., :, None, :] - q[..., None, :, :]) ** 2).sum(-1)
    k = torch.exp(-d2 / (2.0 * sigma**2))
    eye = torch.eye(q.shape[-2], dtype=q.dtype, device=q.device)
    if mask is not None:
        mm = mask[..., :, None] * mask[..., None, :]
        k = k * mm + (1.0 - mask)[..., :, None] * eye  # identity rows for padding
    if diag_boost:
        k = k + diag_boost * eye
    return k


def kpinv_solve(q, v, sigma, rcond=None, mask=None):
    """Least-squares solve of K(q, q) b = v via the SVD pseudo-inverse with
    relative cutoff rcond (reference KpinvSolve, kernel.py:227-232)."""
    k = _masked_gram(q, sigma, mask)
    if mask is not None:
        v = v * mask[..., None]
    u, s, vh = torch.linalg.svd(k)
    s0 = s[..., :1]
    if rcond is None:
        cutoff = torch.finfo(k.dtype).eps * k.shape[-1] * s0
    else:
        cutoff = rcond * s0
    keep = s > cutoff
    sinv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                       torch.zeros_like(s))
    sol = vh.transpose(-1, -2) @ (sinv[..., None] * (u.transpose(-1, -2) @ v))
    if mask is not None:
        sol = sol * mask[..., None]
    return sol


def kridge_solve(q, v, sigma, alpha=1e-4, mask=None):
    """Ridge solve (K + alpha I) b = v (reference KridgeSolve,
    kernel.py:234-242)."""
    k = _masked_gram(q, sigma, mask, diag_boost=alpha)
    if mask is not None:
        v = v * mask[..., None]
    sol = torch.linalg.solve(k, v)
    if mask is not None:
        sol = sol * mask[..., None]
    return sol


def kridge_solve_cg(q, v, sigma, alpha=1e-4, mask=None, tol=1e-6, maxiter=500):
    """Matrix-free ridge solve (K + alpha I) b = v by conjugate gradients, the
    large-M path where the Gram matrix cannot exist.  K is PSD and alpha > 0,
    so the system is SPD.  Each frame stops once its residual norm is at most
    tol times the norm of its right-hand side (the stopping rule of
    jax.scipy.sparse.linalg.cg), or after maxiter iterations."""
    from difficp_torch.ops import backend as _red

    if mask is not None:
        v = v * mask[..., None]
    # the rows' order of the self kernel-sum (q is fixed over the solve)
    order = _red.row_order(q, sigma, mask)

    def matvec(b):
        out = _red.kred(q, q, b if mask is None else b * mask[..., None], sigma, mask,
                        order)
        if mask is not None:
            # identity rows for padded slots (same convention as _masked_gram)
            out = mask[..., None] * out + (1.0 - mask)[..., None] * b
        return out + alpha * b

    def dot(a, b):
        return (a * b).sum((-2, -1), keepdim=True)

    tiny = torch.finfo(v.dtype).tiny
    x = torch.zeros_like(v)
    r = v.clone()
    d = r.clone()
    rs = dot(r, r)
    stop = (tol * tol) * dot(v, v)
    for _ in range(maxiter):
        active = rs > stop
        if not bool(active.any()):
            break
        ad = matvec(d)
        step = torch.where(active, rs / dot(d, ad).clamp_min(tiny),
                           torch.zeros_like(rs))
        x = x + step * d
        r = r - step * ad
        rs_new = dot(r, r)
        beta = torch.where(active, rs_new / rs.clamp_min(tiny), torch.zeros_like(rs))
        d = r + beta * d
        rs = torch.where(active, rs_new, rs)
    if mask is not None:
        x = x * mask[..., None]
    return x


def rff_gaussian_field(q, sigma, n_cols, n_features=2048, generator=None):
    """f of shape (..., M, n_cols): each column an independent sample of a
    Gaussian field with Cov(f_i, f_j) ~= K_ij = exp(-|q_i - q_j|^2 / 2
    sigma^2), by random Fourier features (Rahimi & Recht 2007): O(M F)
    compute and memory, no (M, M) matrix.  phi_f(x) = sqrt(2/F) cos(w_f . x
    + b_f) with w ~ N(0, I / sigma^2), b ~ U[0, 2 pi) gives E[phi(x) .
    phi(y)] = K(x, y), so f = Phi gamma with gamma ~ N(0, I_F); the error is
    O(1 / sqrt(F)) in each entry.  Drawn from ``generator`` (w, b, gamma in
    that order) on q's device, independently for each leading frame."""
    lead, d = q.shape[:-2], q.shape[-1]

    def draw(*shape):
        return torch.randn(lead + shape, generator=generator, dtype=q.dtype,
                           device=q.device)

    w = draw(n_features, d) / sigma
    b = 2.0 * torch.pi * torch.rand(lead + (n_features,), generator=generator,
                                    dtype=q.dtype, device=q.device)
    gamma = draw(n_features, n_cols)
    phi = (2.0 / n_features) ** 0.5 * torch.cos(q @ w.transpose(-1, -2) + b[..., None, :])
    return phi @ gamma
