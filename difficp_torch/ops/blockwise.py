"""Blockwise (tiled) Gaussian pair reductions for large point sets
(counterpart of ``difficp_tpu/ops/blockwise.py``).

Same signatures and semantics as ``ops/reductions.py``, but the (M, N) pair
matrices are never materialized: a Python loop streams column tiles and
accumulates the per-row outputs, in O(M + N) memory besides one tile's
(M, tile) temporaries.  When a gradient is taken each tile body is
checkpointed (``_Recomputed``): the forward keeps the tile's inputs only, and
the backward recomputes its temporaries and takes the VJP of the outputs
that receive a gradient, one tile at a time, so it never holds every tile's
(M, tile, D) residuals at once.  ``torch.utils.checkpoint`` (non-reentrant)
recomputes every tensor a tile saved and frees each when its node runs, so
the nodes of an output that gets no gradient (the last Euler step's -Gq)
keep theirs until the whole backward ends: at 65,536 points that held
every tile of that step, 77 GB.

This is a plain PyTorch route that users choose (``backend.set_backend(
"blockwise")``, the API's ``computversion="blockwise"`` / ``"keops"``), and
the VJP the kernels' ``"accurate"`` backward takes (``backend.
set_bwd_precision``).  Shapes: x (..., M, D), y (..., N, D), masks (..., M)
/ (..., N) float (1 = real point); leading dimensions are frames.
"""

from __future__ import annotations

from functools import partial

import torch


def vjp(fn, inputs, cotangents, needs):
    """The VJP of ``fn(*inputs)`` (a tensor or a tuple of them) for the
    cotangents given (None: no gradient reaches that output), with respect
    to the inputs whose ``needs`` is set (None for the others): fn is run
    again with autograd on, and its graph is freed on return."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, c) for o, c in zip(outs, cotangents) if c is not None and o.requires_grad]
        wrt = [x for x, n in zip(xs, needs) if n]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [c for _, c in pairs],
                                         allow_unused=True)
                     if pairs and wrt else [None] * len(wrt))
    return [next(grads) if n else None for n in needs]


class _Recomputed(torch.autograd.Function):
    """fn(*args) with its temporaries recomputed in the backward: the forward
    runs without a graph and saves the inputs; the backward is ``vjp`` at
    them."""

    @staticmethod
    def forward(ctx, fn, *args):
        ctx.fn = fn
        ctx.save_for_backward(*args)
        ctx.set_materialize_grads(False)
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *vjp(ctx.fn, ctx.saved_tensors, grads, ctx.needs_input_grad[1:]))


def _ckpt(fn, *args):
    """fn(*args), checkpointed (``_Recomputed``) when a gradient flows
    through any of the tensors."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _Recomputed.apply(fn, *args)
    return fn(*args)


def _bounds(n, tile):
    return [(lo, min(lo + tile, n)) for lo in range(0, n, tile)]


def _ones(x):
    return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


def _kernel_tile(x, yj, mj, sigma):
    """diff (..., M, T, D), sqdist (..., M, T), K (..., M, T) with the column
    mask folded into K."""
    diff = x[..., :, None, :] - yj[..., None, :, :]
    d2 = (diff * diff).sum(-1)
    k = torch.exp(-d2 / (2.0 * sigma**2)) * mj[..., None, :]
    return diff, d2, k


def _row_sum(k, diff):
    """sum_t k_mt diff_mtd, without a (..., M, T, D) product."""
    return torch.einsum("...mt,...mtd->...md", k, diff)


def _rhs_cross_tile(qr, pr, mr, qj, pj, mj, sigma, eta, withlogdet):
    """One column tile's share of (vq, Gq, dcost) of the fused RHS."""
    d = qr.shape[-1]
    sig2 = sigma**2
    diff, d2, k = _kernel_tile(qr, qj, mj, sigma)
    vq = k @ pj
    dots = pr @ pj.transpose(-1, -2)
    gq = -_row_sum(k * dots, diff) / sig2
    if eta != 0.0:
        vq = vq + eta * (_row_sum(k, diff) / sig2)
        cb = pr[..., :, None, :] - pj[..., None, :, :]
        proj = (diff * cb).sum(-1)
        hess = _row_sum(k, diff * proj[..., None] / sig2**2 - cb / sig2)
        coef = k * (d2 / sigma**6 - (d + 2) / sigma**4)
        glap = -_row_sum(coef, diff)
        gq = gq - eta * hess - eta**2 * glap
    if withlogdet:
        km = k * mr[..., :, None]
        dc = -(_row_sum(km, diff) * pr).sum((-2, -1)) / sig2
        if eta != 0.0:
            dc = dc + eta * (km * (d2 / sigma**4 - d / sigma**2)).sum((-2, -1))
    else:
        dc = torch.zeros(qr.shape[:-2], dtype=qr.dtype, device=qr.device)
    return vq, gq, dc


def _rhs_cross_blockwise(qr, pr, mr, qc, pc, mc, sigma, eta, withlogdet, tile):
    """Fused RHS of the rows (qr, pr) against the columns (qc, pc), the
    columns streamed in tiles: (vq, Gq, dcost).  ``mr`` weights only the
    logdet cost (the caller masks the rows of vq and Gq)."""
    body = partial(_rhs_cross_tile, sigma=float(sigma), eta=float(eta),
                   withlogdet=bool(withlogdet))
    vq = gq = dcost = 0.0
    for lo, hi in _bounds(qc.shape[-2], tile):
        v, g, c = _ckpt(body, qr, pr, mr, qc[..., lo:hi, :], pc[..., lo:hi, :],
                        mc[..., lo:hi])
        vq, gq, dcost = vq + v, gq + g, dcost + c
    return vq, gq, dcost


def lddmm_rhs_cross(qr, pr, qc, pc, sigma, eta, withlogdet, mask_r=None, mask_c=None,
                    tile=1024):
    """The rows' share of the fused RHS against the column set qc: (vq, -Gq,
    dcost); summed over a partition of the columns it is
    ``lddmm_rhs_self`` (the ring schedule of ``parallel/ring.py``)."""
    mr = _ones(qr) if mask_r is None else mask_r
    mc = _ones(qc) if mask_c is None else mask_c
    vq, gq, dcost = _rhs_cross_blockwise(qr, pr, mr, qc, pc, mc, sigma, eta, withlogdet,
                                         tile)
    if mask_r is not None:
        vq = vq * mask_r[..., None]
        gq = gq * mask_r[..., None]
    return vq, -gq, dcost


def lddmm_rhs_self(q, p, sigma, eta, withlogdet, mask_q=None, tile=1024):
    """Blockwise ``reductions.lddmm_rhs_self``: (vq, -Gq, dcost)."""
    return lddmm_rhs_cross(q, p, q, p, sigma, eta, withlogdet, mask_q,
                           _ones(q) if mask_q is None else mask_q, tile)


def _rhs_ext_tile(x, mx, qj, pj, mj, sigma, eta, withlogdet):
    """One support tile's share of (vx, dcost at x)."""
    d = x.shape[-1]
    sig2 = sigma**2
    diff, d2, k = _kernel_tile(x, qj, mj, sigma)
    vx = k @ pj
    if eta != 0.0:
        vx = vx + eta * (_row_sum(k, diff) / sig2)
    if withlogdet:
        km = k * mx[..., :, None]
        dc = (torch.einsum("...nt,...ntd->...td", km, diff) * pj).sum((-2, -1)) / sig2
        if eta != 0.0:
            dc = dc + eta * (km * (d2 / sigma**4 - d / sigma**2)).sum((-2, -1))
    else:
        dc = torch.zeros(x.shape[:-2], dtype=x.dtype, device=x.device)
    return vx, dc


def _rhs_ext_blockwise(x, q, p, maskq, maskx, sigma, eta, withlogdet, tile=1024):
    """v at the external points x and the logdet cost there, the support
    streamed in tiles."""
    body = partial(_rhs_ext_tile, sigma=float(sigma), eta=float(eta),
                   withlogdet=bool(withlogdet))
    vx = dcost = 0.0
    for lo, hi in _bounds(q.shape[-2], tile):
        v, c = _ckpt(body, x, maskx, q[..., lo:hi, :], p[..., lo:hi, :], maskq[..., lo:hi])
        vx, dcost = vx + v, dcost + c
    return vx, dcost


def lddmm_rhs_ext(q, p, x, sigma, eta, withlogdet, mask_q=None, mask_x=None, tile=1024):
    """Blockwise ``reductions.lddmm_rhs_ext``: (vq, -Gq, dcost, vx)."""
    vq, mgq, _ = lddmm_rhs_self(q, p, sigma, eta, False, mask_q, tile)
    maskq = _ones(q) if mask_q is None else mask_q
    maskx = _ones(x) if mask_x is None else mask_x
    vx, dcost = _rhs_ext_blockwise(x, q, p, maskq, maskx, sigma, eta, withlogdet, tile)
    if not withlogdet:
        dcost = torch.zeros(q.shape[:-2], dtype=q.dtype, device=q.device)
    if mask_x is not None:
        vx = vx * mask_x[..., None]
    return vq, mgq, dcost, vx


def v_field(x, q, p, sigma, eta, mask_q=None, tile=1024):
    """v(x_i) = sum_j m_j [p_j K(x_i - q_j) - eta (grad K)(x_i - q_j)]."""
    vx, _ = _rhs_ext_blockwise(x, q, p, _ones(q) if mask_q is None else mask_q, _ones(x),
                               sigma, eta, False, tile)
    return vx


def _kred_tile(x, yj, mj, bj, sigma):
    _, _, k = _kernel_tile(x, yj, mj, sigma)
    return k @ bj


def kred(x, y, b, sigma, mask_y=None, tile=1024):
    """sum_j K(x_i - y_j) m_j b_j (reference kernel.py:138)."""
    my = _ones(y) if mask_y is None else mask_y
    body = partial(_kred_tile, sigma=float(sigma))
    out = 0.0
    for lo, hi in _bounds(y.shape[-2], tile):
        out = out + _ckpt(body, x, y[..., lo:hi, :], my[..., lo:hi], b[..., lo:hi, :])
    return out


def kred_scal(x, y, d, sigma, mask_y=None, tile=1024):
    """sum_j K(x_i - y_j) m_j d_j, scalar payload (reference kernel.py:134)."""
    return kred(x, y, d[..., None], sigma, mask_y, tile)[..., 0]


def _grad_kred_tile(x, yj, mj, sigma):
    diff, _, k = _kernel_tile(x, yj, mj, sigma)
    return -_row_sum(k, diff) / sigma**2


def grad_kred(x, y, sigma, mask_y=None, tile=1024):
    """sum_j (grad K)(x_i - y_j) m_j (reference kernel.py:142)."""
    my = _ones(y) if mask_y is None else mask_y
    body = partial(_grad_kred_tile, sigma=float(sigma))
    out = 0.0
    for lo, hi in _bounds(y.shape[-2], tile):
        out = out + _ckpt(body, x, y[..., lo:hi, :], my[..., lo:hi])
    return out


def _mdivsum_tile(q, p, mq, xj, mj, sigma, eta):
    d = q.shape[-1]
    sig2 = sigma**2
    diff, d2, k = _kernel_tile(q, xj, mj, sigma)
    k = k * mq[..., :, None]
    g = -(_row_sum(k, diff) * p).sum((-2, -1)) / sig2
    if eta != 0.0:
        g = g + eta * (k * (d2 / sig2**2 - d / sig2)).sum((-2, -1))
    return g


def mdivsum(x, q, p, sigma, eta, mask_q=None, mask_x=None, tile=1024):
    """-sum_i div(v)(x_i) per frame (reference LDDMM.py:120-138), the data
    points x streamed in tiles against the resident support (q, p)."""
    mq = _ones(q) if mask_q is None else mask_q
    mx = _ones(x) if mask_x is None else mask_x
    body = partial(_mdivsum_tile, sigma=float(sigma), eta=float(eta))
    out = 0.0
    for lo, hi in _bounds(x.shape[-2], tile):
        out = out + _ckpt(body, q, p, mq, x[..., lo:hi, :], mx[..., lo:hi])
    return out


def _hamiltonian_tile(qr, pr, mr, qj, pj, mj, sigma, eta):
    d = qr.shape[-1]
    sig2 = sigma**2
    diff, d2, k = _kernel_tile(qr, qj, mj, sigma)
    k = k * mr[..., :, None]
    h = 0.5 * ((k @ pj) * pr).sum((-2, -1))
    if eta != 0.0:
        bsum = -(_row_sum(k, diff) * pr).sum((-2, -1)) / sig2
        csum = (k * (d2 / sig2**2 - d / sig2)).sum((-2, -1))
        h = h - eta * bsum - 0.5 * eta**2 * csum
    return h


def hamiltonian_cross(qr, pr, qc, pc, sigma, eta, mask_r=None, mask_c=None, tile=1024):
    """The rows' share of the Hamiltonian against the columns qc: summed
    over a partition of the columns it is ``hamiltonian``."""
    mr = _ones(qr) if mask_r is None else mask_r
    mc = _ones(qc) if mask_c is None else mask_c
    body = partial(_hamiltonian_tile, sigma=float(sigma), eta=float(eta))
    h = 0.0
    for lo, hi in _bounds(qc.shape[-2], tile):
        h = h + _ckpt(body, qr, pr, mr, qc[..., lo:hi, :], pc[..., lo:hi, :], mc[..., lo:hi])
    return h


def hamiltonian(q, p, sigma, eta, mask_q=None, tile=1024):
    """H(q, p) with the gradcomponent eta terms (LDDMM.py:142-159)."""
    return hamiltonian_cross(q, p, q, p, sigma, eta, mask_q, mask_q, tile)


# ---------------------------------------------------------------------------
# Tiled nearest-neighbour reductions (reference kernel.py:324-328,
# point_sets.py:23-25): a running min / top-2 over column tiles.  No
# gradient flows through them.
# ---------------------------------------------------------------------------

def _masked_d2(x, yj, mj):
    d2 = ((x[..., :, None, :] - yj[..., None, :, :]) ** 2).sum(-1)
    return torch.where(mj[..., None, :] > 0, d2, torch.inf)


def min_sqdist(x, y, mask_y=None, tile=2048):
    """min_j |x_i - y_j|^2 over the unmasked y_j."""
    my = _ones(y) if mask_y is None else mask_y
    out = torch.full(x.shape[:-1], torch.inf, dtype=x.dtype, device=x.device)
    for lo, hi in _bounds(y.shape[-2], tile):
        out = torch.minimum(out, _masked_d2(x, y[..., lo:hi, :], my[..., lo:hi]).amin(-1))
    return out


def _top2_scan(x, y, mask_y, tile, self_indices=None):
    """Running (min1, min2) of the masked |x_i - y_j|^2 over column tiles;
    ``self_indices`` (M,): the pair (i, j == self_indices[i]) is excluded.
    Each tile keeps its own two smallest (duplicates included) and merges
    them into the running pair; a last tile of one column gets one masked
    column beside it (the JAX package pads every tile to its width)."""
    n = y.shape[-2]
    m1 = torch.full(x.shape[:-1], torch.inf, dtype=x.dtype, device=x.device)
    m2 = m1.clone()
    for lo in range(0, n, tile):
        hi = min(lo + tile, n)
        d2 = _masked_d2(x, y[..., lo:hi, :], mask_y[..., lo:hi])
        if self_indices is not None:
            cols = torch.arange(lo, hi, device=x.device)
            d2 = torch.where(cols[None, :] == self_indices[:, None], torch.inf, d2)
        if hi - lo < 2:
            d2 = torch.cat([d2, torch.full_like(d2, torch.inf)], -1)
        t = torch.topk(d2, 2, dim=-1, largest=False, sorted=True).values
        merged = torch.sort(torch.stack([m1, m2, t[..., 0], t[..., 1]], -1), -1).values
        m1, m2 = merged[..., 0], merged[..., 1]
    return m1, m2


def second_min_sqdist(x, mask=None, tile=2048):
    """Nearest-neighbour squared distance excluding self (the KeOps Kmin(2)
    of reference point_sets.py:23-25): self is excluded outright, so the
    first of the streamed top-2 is the answer."""
    m = _ones(x) if mask is None else mask
    idx = torch.arange(x.shape[-2], device=x.device)
    m1, _ = _top2_scan(x, x, m, tile, idx)
    return m1
