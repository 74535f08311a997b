"""Plain LDDMM geodesic shooting at eta = 0 with the logdet energy
("hybrid"), Euler steps, its loss and the loss's gradient, written again in
plain PyTorch from the model's equations (reference LDDMM.py:100-334, as
``difficp_torch/models/lddmm.py`` and the dense sums of
``difficp_torch/ops/reductions.py`` state them).  With u = 1/sigma^2,
k_ij = exp(-u |q_i - q_j|^2 / 2) and masks m:

    v_i     = m_i sum_j m_j k_ij p_j                      dq/dt
    w_i     = u m_i sum_j m_j k_ij (p_i.p_j)(q_i - q_j)   dp/dt
    dcost   = u sum_i m_i sum_j m_j k_ij (q_j - q_i).p_i  (support = data)
    H       = 1/2 sum_i m_i p_i.v_i
    trajl   = lambda H(q0, p0) + cost(1)
    datal   = sum_n w_n |q1_n - y_n|^2 / (2 sigma_gmm^2)

Every pair sum runs in blocks of rows against all columns, so that memory
stays O(block x columns); the gradient recomputes each block in the
backward (``RowBlocks``).  Frames are a leading axis.  ``prec`` is a
precision of ``precision.py``.
"""

from __future__ import annotations

import torch

from perfbench.reference.precision import mm

# elements of one (frames, block rows, columns) pair array
BLOCK_ELEMENTS = 1 << 25


class RowBlocks(torch.autograd.Function):
    """``fn(*row_args, *col_args)`` over blocks of rows (axis 1 of every row
    argument), its outputs concatenated on axis 1; the backward recomputes
    each block and takes its VJP at once, so no block's pair arrays outlive
    it."""

    @staticmethod
    def forward(ctx, fn, n_rows, block, *args):
        rows, cols = args[:n_rows], args[n_rows:]
        n = rows[0].shape[1]
        parts = [fn(*(r[:, lo:lo + block] for r in rows), *cols)
                 for lo in range(0, n, block)]
        ctx.fn, ctx.n_rows, ctx.block = fn, n_rows, block
        ctx.save_for_backward(*args)
        return tuple(torch.cat(o, 1) for o in zip(*parts))

    @staticmethod
    def backward(ctx, *gouts):
        args = ctx.saved_tensors
        n_rows, block = ctx.n_rows, ctx.block
        need = ctx.needs_input_grad[3:]
        grads = [torch.zeros_like(a) if nd else None for a, nd in zip(args, need)]
        cols = [c.detach().requires_grad_(nd) for c, nd in zip(args[n_rows:], need[n_rows:])]
        n = args[0].shape[1]
        for lo in range(0, n, block):
            rows = [r[:, lo:lo + block].detach().requires_grad_(nd)
                    for r, nd in zip(args[:n_rows], need[:n_rows])]
            with torch.enable_grad():
                outs = ctx.fn(*rows, *cols)
            pairs = [(o, g[:, lo:lo + block]) for o, g in zip(outs, gouts)
                     if g is not None and o.requires_grad]
            leaves = [t for t in rows + cols if t.requires_grad]
            if not pairs or not leaves:
                continue
            got = iter(torch.autograd.grad([o for o, _ in pairs], leaves,
                                           [g for _, g in pairs], allow_unused=True))
            for i, t in enumerate(rows + cols):
                if not t.requires_grad:
                    continue
                g = next(got)
                if g is None:
                    continue
                if i < n_rows:
                    grads[i][:, lo:lo + block] += g
                else:
                    grads[i] += g
        return (None, None, None, *grads)


def _block_rows(frames: int, cols: int) -> int:
    return max(1, BLOCK_ELEMENTS // max(1, frames * cols))


def _kernel(ri, c, sig2, prec):
    """k(r_i, c_j) (frames, rows, cols).  In float64 the exponent is one
    product of augmented coordinates (its cancellation costs ~1e-14 at these
    scales); in TF32 it takes the difference form, as the kernels do, since
    the expanded form would lose the exponent in float32."""
    if prec == "float64":
        a = torch.cat([ri / sig2, -(ri * ri).sum(-1, keepdim=True) / (2 * sig2),
                       torch.ones_like(ri[..., :1])], -1)
        b = torch.cat([c, torch.ones_like(c[..., :1]),
                       -(c * c).sum(-1, keepdim=True) / (2 * sig2)], -1)
        return torch.exp(a @ b.transpose(-1, -2))
    r2 = sum((ri[..., :, None, e] - c[..., None, :, e]) ** 2 for e in range(ri.shape[-1]))
    return torch.exp(-r2 / (2.0 * sig2))


def _centre(q, m):
    """The masked centroid of each frame's support, which coordinates are
    taken about (the results do not depend on it)."""
    return ((q * m[..., None]).sum(1, keepdim=True)
            / m.sum(1, keepdim=True)[..., None]).detach()


def self_rhs(q, p, m, sigma, logdet, prec):
    """(v, w, dcost per frame) of the self RHS at (q, p).  Every sum over j
    is one product of the kernel block with a table of payload columns
    (p, 1, q, p_e q_f, each times m_j), as the JAX package's table kernels
    take them: w_i = u sum_e p_ie (q_i S[p_e] - S[p_e q]), dcost_i = u m_i
    p_i.(S[q] - q_i S[1])."""
    sig2 = sigma ** 2
    centre = _centre(q, m)
    d = q.shape[-1]

    def rows_fn(qi, pi, mi, qc, pc, mc):
        qci, qcc = qi - centre, qc - centre
        k = _kernel(qci, qcc, sig2, prec)
        table = torch.cat([pc, torch.ones_like(mc[..., None]), qcc,
                           (pc[..., :, None] * qcc[..., None, :]).flatten(-2)], -1)
        s = mm(k, table * mc[..., None], prec)
        sp, s1, sq = s[..., :d], s[..., d:d + 1], s[..., d + 1:2 * d + 1]
        spq = s[..., 2 * d + 1:].unflatten(-1, (d, d))
        v = sp * mi[..., None]
        w = (pi[..., :, None] * (qci[..., None, :] * sp[..., :, None] - spq)).sum(-2)
        w = w / sig2 * mi[..., None]
        if logdet:
            dc = (pi * (sq - qci * s1)).sum(-1) / sig2 * mi
        else:
            dc = torch.zeros_like(mi)
        return v, w, dc

    v, w, dc = RowBlocks.apply(rows_fn, 3, _block_rows(q.shape[0], q.shape[1]),
                               q, p, m, q, p, m)
    return v, w, dc.sum(1)


def shoot(cfg: dict, q0, p0, m, prec="float64"):
    """Euler steps from (q0, p0): (q1, p1, cost)."""
    nt = int(cfg["nt"])
    dt = 1.0 / nt
    sigma = float(cfg["sigma"])
    q, p = q0, p0
    cost = torch.zeros(q0.shape[0], dtype=q0.dtype, device=q0.device)
    for _ in range(nt):
        v, w, dc = self_rhs(q, p, m, sigma, True, prec)
        q, p, cost = q + dt * v, p + dt * w, cost + dt * dc
    return q, p, cost


def hamiltonian(cfg: dict, q, p, m, prec):
    v, _, _ = self_rhs(q, p, m, float(cfg["sigma"]), False, prec)
    return 0.5 * (m[..., None] * p * v).sum((1, 2))


def loss(cfg: dict, q0, p0, m, y, wts, sig2_gmm, prec):
    """Per frame (trajl, datal, warped points q1): the registration
    objective trajl + datal at p0, the support being the data."""
    q1, _, cost = shoot(cfg, q0, p0, m, prec)
    pts = q1
    trajl = float(cfg["lambd"]) * hamiltonian(cfg, q0, p0, m, prec) + cost
    datal = (wts[..., None] * (pts - y) ** 2).sum((1, 2)) / (2.0 * sig2_gmm)
    return trajl, datal, pts
