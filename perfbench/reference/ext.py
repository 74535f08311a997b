"""Plain LDDMM shooting with external points at eta = 0 with the logdet energy
("hybrid"), Euler steps, for grid support: the support q (M points, the
same grid for every frame) carries the momenta p, and the data x (N points a
frame) are advected by its field.  Written again in plain PyTorch from the
model's equations (reference LDDMM.py:176-227, 286-334, as
``difficp_torch/ops/reductions.py``'s ``lddmm_rhs_ext`` and
``difficp_torch/models/lddmm.py``'s ``shoot`` and ``trajloss`` state them).
With u = 1/sigma^2, k(a, b) = exp(-u |a - b|^2 / 2), support masks m and data
masks mx:

    v_i     = m_i sum_j m_j k(q_i, q_j) p_j                     dq/dt
    w_i     = u m_i sum_j m_j k(q_i, q_j) (p_i.p_j)(q_i - q_j)  dp/dt
    vx_n    = mx_n sum_j m_j k(x_n, q_j) p_j                    dx/dt
    dcost   = u sum_n mx_n sum_j m_j k(x_n, q_j) p_j.(x_n - q_j)
                                       (-div v summed over the data)
    H       = 1/2 sum_i m_i p_i.v_i
    trajl   = lambda H(q0, p0) + cost(1)
    datal   = sum_n w_n |x1_n - y_n|^2 / (2 sigma_gmm^2)

and the coverage pass (``ops/reductions.py``'s ``check_coverage`` over the
saved trajectory, ``models/psr.py``'s ``_reg_opt_lddmm``): per frame and
Euler state t = 0..nt, the data points with min_j m_j |x_n(t) - q_j(t)|^2 >
(2 sigma)^2.

Where this departs from the program's equations (none changes the
mathematics):

- every pair sum over the data runs in blocks of data rows against all
  support columns (``lddmm.RowBlocks``, whose backward recomputes each
  block), and is one product of the kernel block with a payload table
  (p, p.(q - c)), so that dcost_n = u mx_n ((x_n - c).S[p] - S[p.(q - c)]),
  c the support's masked centroid (the results do not depend on it);
- the kernel is ``lddmm._kernel``'s: in float64 the exponent is one product
  of augmented coordinates about c, in TF32 the difference form; the
  program takes the difference form in float32 (its dense route at this
  shape);
- the self terms (v, w) and H are ``lddmm.self_rhs`` and
  ``lddmm.hamiltonian``, the same sums the dense two-set's reference takes;
- the coverage pass is worked out in the reference's own precision, and a
  point whose float64 squared distance lies within ``cover_band`` of the
  threshold may be counted either way (see there: the band is measured
  against a float32 witness shoot).

Frames are a leading axis.  ``prec`` is a precision of ``precision.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.lddmm import RowBlocks, _block_rows, _centre, _kernel, hamiltonian, \
    self_rhs
from perfbench.reference.precision import mm

# the coverage pass's radius in units of sigma_LDDMM (``_reg_opt_lddmm``'s
# r_cover_warn)
R_COVER = 2.0
# float32's unit roundoff
U32 = 2.0 ** -24


def grid_support(points, rcover, relmargin=0.1, ticks=None) -> np.ndarray:
    """Frozen copy of ``difficp_torch/utils/point_sets.py``'s ``grid_support``
    (reference PSR.py:472-482), which ``DiffPSR.set_support_scheme("grid")``
    calls: a rectangular grid of step ``rcover`` over the data's bounding
    box widened by ``relmargin`` on each side.  Same operations in the same
    order, so that the support compares exactly."""
    if ticks is None:
        if isinstance(points, (list, tuple)):
            pts = np.concatenate([np.asarray(p).reshape(-1, np.asarray(p).shape[-1])
                                  for p in points], axis=0)
        else:
            pts = np.asarray(points).reshape(-1, np.asarray(points).shape[-1])
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        mid_lo = (1 + relmargin) * lo - relmargin * hi
        mid_hi = (1 + relmargin) * hi - relmargin * lo
        ticks = [
            np.arange(mid_lo[d] - rcover / 2, mid_hi[d] + rcover / 2, rcover)
            for d in range(pts.shape[1])
        ]
    mesh = np.meshgrid(*ticks, indexing="xy")
    grid = np.stack(mesh, axis=-1).reshape(-1, len(ticks), order="F")
    return np.ascontiguousarray(grid, np.float32)


def support(config: dict, x0: np.ndarray):
    """(q0, qmask) of grid support at rho * sigma_LDDMM over the frames
    ``x0`` (K, N, D) float32: one grid, the same for every frame, as
    ``set_support_scheme`` builds it from all frames' points."""
    k, _, d = x0.shape
    pts = grid_support(x0.reshape(-1, d), float(config["support"]["rho"])
                       * float(config["lddmm"]["sigma"]))
    q0 = np.ascontiguousarray(np.broadcast_to(pts, (k,) + pts.shape))
    return q0, np.ones(q0.shape[:2], np.float32)


def ext_rhs(x, mx, q, p, m, sigma, prec):
    """(vx (frames, N, D), dcost per frame) of the data x advected by the
    field of (q, p)."""
    sig2 = sigma ** 2
    centre = _centre(q, m)
    d = q.shape[-1]

    def rows_fn(xi, mxi, qc, pc, mc):
        xci, qcc = xi - centre, qc - centre
        k = _kernel(xci, qcc, sig2, prec)
        table = torch.cat([pc, (pc * qcc).sum(-1, keepdim=True)], -1)
        s = mm(k, table * mc[..., None], prec)
        sp, spq = s[..., :d], s[..., d]
        vx = sp * mxi[..., None]
        dc = ((xci * sp).sum(-1) - spq) / sig2 * mxi
        return vx, dc

    vx, dc = RowBlocks.apply(rows_fn, 2, _block_rows(q.shape[0], q.shape[1]),
                             x, mx, q, p, m)
    return vx, dc.sum(1)


def shoot(cfg: dict, q0, p0, m, x0, mx, prec="float64", keep=False):
    """Euler steps from (q0, p0, x0): (q1, p1, x1, cost, states), states the
    detached (q, p, x) at t = 0..nt where ``keep``, else None."""
    nt = int(cfg["nt"])
    dt = 1.0 / nt
    sigma = float(cfg["sigma"])
    q, p, x = q0, p0, x0
    cost = torch.zeros(q0.shape[0], dtype=q0.dtype, device=q0.device)
    states = [(q.detach(), p.detach(), x.detach())] if keep else None
    for _ in range(nt):
        v, w, _ = self_rhs(q, p, m, sigma, False, prec)
        vx, dc = ext_rhs(x, mx, q, p, m, sigma, prec)
        q, p, x, cost = q + dt * v, p + dt * w, x + dt * vx, cost + dt * dc
        if keep:
            states.append((q.detach(), p.detach(), x.detach()))
    return q, p, x, cost, states


def loss(cfg: dict, q0, p0, m, x0, mx, y, wts, sig2_gmm, prec, keep=False):
    """Per frame (trajl, datal, warped data x1, states): the registration
    objective trajl + datal at p0; ``states`` as in ``shoot``."""
    _, _, x1, cost, states = shoot(cfg, q0, p0, m, x0, mx, prec, keep)
    trajl = float(cfg["lambd"]) * hamiltonian(cfg, q0, p0, m, prec) + cost
    datal = (wts[..., None] * (x1 - y) ** 2).sum((1, 2)) / (2.0 * sig2_gmm)
    return trajl, datal, x1, states


def min_sqdist(states, m):
    """(nt + 1, frames, N): each data point's least squared distance to the
    unmasked support at every Euler state, in the states' own precision, in
    blocks of data rows."""
    out = []
    for q, _, x in states:
        block = _block_rows(q.shape[0], q.shape[1])
        parts = []
        for lo in range(0, x.shape[1], block):
            xi = x[:, lo:lo + block]
            d2 = ((xi[:, :, None, :] - q[:, None, :, :]) ** 2).sum(-1)
            parts.append(torch.where(m[:, None, :] > 0, d2, torch.inf).min(-1).values)
        out.append(torch.cat(parts, 1))
    return torch.stack(out)


def cover_threshold(cfg: dict) -> float:
    """The coverage pass's squared radius (R_COVER sigma)^2."""
    return (R_COVER * float(cfg["sigma"])) ** 2


# how far the program's float32 distances may depart from the float64 ones,
# as a multiple of the float32 witness's departure (``cover_band``)
WITNESS_FACTOR = 8


def cover_band(cfg: dict, d2, d2_witness) -> float:
    """Relative band around the threshold r^2 = (2 sigma)^2 inside which the
    program's float32 squared distance may fall on either side of the
    float64 one ``d2``.  Its derivation:

    - the program's d^2 = fl(sum_e fl(x_e - q_e)^2) from its float32 states;
      the squares and the sum add at most 3u d^2 (u = 2^-24);
    - its states carry the rounding of nt float32 Euler steps, carried on
      through the field.  A bound a priori is vacuous at a registration's
      momenta: the field's gradient reaches ~10 where momenta concentrate,
      and its growth factor exp(10) would make any count sound.  So it is
      measured: ``d2_witness``, the distances of a float32 witness (this
      reference's own shoot in float32 at the same momenta: the kernel's
      difference form and plain float32 products, as the program's dense
      route takes them), depart from ``d2`` by at most delta, relative to
      the larger of the distance and r^2, over every point and state;
    - the program rounds in another order than the witness, each rounding
      of the same size: the band gives it WITNESS_FACTOR times delta.

    Together: band = 3u + WITNESS_FACTOR delta."""
    thr = cover_threshold(cfg)
    dev = ((d2_witness.double() - d2.double()).abs() / d2.double().clamp_min(thr)).max()
    return 3 * U32 + WITNESS_FACTOR * float(dev)


def cover_counts(cfg: dict, d2, mx, band=0.0):
    """Per frame and Euler state (frames, nt + 1): the unmasked data points
    beyond the threshold by more than ``band`` (relative), and those beyond
    it by more than -``band``: a count between the two is sound."""
    thr = cover_threshold(cfg)
    real = mx[None] > 0
    sure = ((d2 > thr * (1.0 + band)) & real).sum(-1).T
    maybe = ((d2 > thr * (1.0 - band)) & real).sum(-1).T
    return sure.cpu().numpy(), maybe.cpu().numpy()
