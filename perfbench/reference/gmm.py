"""Plain EM of a GMM with one isotropic sigma and no outlier term, the
semantics of the reference GMM.py:236-357 as the port states them
(``difficp_torch/models/gmm.py``: ``create``, ``_e_step``, ``_m_stats``,
``_apply_stats``, ``_em_values``, ``em_optimization``), written again in
plain PyTorch over all points at once."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from perfbench.reference.precision import mm


class State(NamedTuple):
    mu: torch.Tensor     # (C, D)
    w: torch.Tensor      # (C,) log-scores
    sigma: torch.Tensor  # ()


class Targets(NamedTuple):
    y: torch.Tensor      # (N, D) quadratic targets
    cfe: torch.Tensor    # () free-energy offset
    fe: torch.Tensor     # () cfe + quad
    gamt: torch.Tensor   # (N,) inlier weight (ones: no outlier term)


def start_sigma(mu: torch.Tensor) -> float:
    """gmm.create's ad hoc start: 0.1 x the centroids' radius / C^(1/D)."""
    c, d = mu.shape
    r = float(torch.sqrt(mu.double().var(0, unbiased=False).sum()))
    return max(0.1 * (r / c ** (1.0 / d)), 1e-6)


def em_step(state: State, x, mask, opt: dict, prec: str, skip_m=False):
    """One E step with the old parameters, the M step, and the targets and
    free-energy terms with the new ones: (new state, Targets)."""
    n, d = x.shape
    d2 = ((x[:, None, :] - state.mu[None, :, :]) ** 2).sum(-1)
    log_norm = d * (torch.log(state.sigma) + 0.5 * math.log(2.0 * math.pi))
    t = state.w[None, :] - torch.logsumexp(state.w, 0) - d2 / (2 * state.sigma ** 2) - log_norm
    lgam = t - torch.logsumexp(t, 1)[:, None]
    gam = torch.exp(lgam)
    new = state
    if not skip_m:
        gm = gam * mask[:, None]
        s_gam = gm.sum(0)
        mu, w, sigma = state.mu, state.w, state.sigma
        if opt["optimize_mu"]:
            mu = mm(gm.T, x, prec) / torch.clamp_min(s_gam, 1e-30)[:, None]
        if opt["optimize_w"]:
            w = torch.log(torch.clamp_min(s_gam, 1e-30))
        if opt["optimize_sigma"]:
            sigma = torch.sqrt((gm * d2).sum() / (d * mask.sum()))
        new = State(mu, w, sigma)
    y = mm(gam, new.mu, prec)
    lpi = new.w - torch.logsumexp(new.w, 0)
    log_norm_new = d * (torch.log(new.sigma) + 0.5 * math.log(2.0 * math.pi))
    inner = ((new.mu ** 2).sum(-1)[None, :] - (y ** 2).sum(-1)[:, None]) / (2 * new.sigma ** 2) \
        + lgam - lpi[None, :]
    inner = torch.where(gam > 0, inner, torch.zeros_like(inner))
    cfe = (mask * ((gam * inner).sum(1) + log_norm_new)).sum()
    quad = (mask * ((x - y) ** 2).sum(-1)).sum() / (2 * new.sigma ** 2)
    return new, Targets(y=y, cfe=cfe, fe=cfe + quad, gamt=torch.ones_like(mask))


# a stop decision this close to the tolerance (relative) may fall the other
# way in float32 than in float64: both outcomes are then candidates
BORDERLINE = 5e-2


def em_optimization(state: State, x, mask, opt: dict, max_iterations: int, tol: float,
                    prec: str):
    """EM to the free-energy tolerance: at least two steps, then stop once
    |fe - last_fe| < tol |last_fe|, at most ``max_iterations``.  Returns the
    list of candidate (steps, state, Targets): every step count at which the
    stop test could end the EM in float32.  A decision within BORDERLINE of
    the tolerance may go either way: where it may stop, its step count is a
    candidate, and the EM is followed on past it, until a decision that
    stops for certain or the step limit (which stops it too)."""
    steps = [(state, None)]
    fe, last_fe = math.inf, 0.0
    cands = []
    i = 0
    while i < max_iterations:
        if i >= 2:
            rel = abs(fe - last_fe) / max(abs(last_fe), 1e-300)
            if rel < tol * (1.0 + BORDERLINE):
                cands.append(i)
                if rel < tol * (1.0 - BORDERLINE):
                    break
        state, tg = em_step(state, x, mask, opt, prec)
        steps.append((state, tg))
        last_fe, fe = fe, float(tg.fe)
        i += 1
    if i == max_iterations:
        cands.append(i)
    return [(c, steps[c][0], steps[c][1]) for c in sorted(set(cands))]
