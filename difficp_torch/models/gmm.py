"""Gaussian Mixture Model with uniform isotropic covariances, functional EM
(counterpart of ``difficp_tpu/models/gmm.py``).

- State: centroids ``mu`` (C, D), component log-scores ``w`` (C,), a single
  isotropic std ``sigma``, and optionally an outlier component with log-odds
  ``eta0`` against a uniform density 1/vol0 (GMM.py:56-64, 97-103).
- Formulas in the log domain as the reference: E step (GMM.py:263-282), M step
  (GMM.py:286-299), quadratic targets Y and free-energy offset Cfe
  (GMM.py:301-323 / 475-496), the M step from ``MStats`` sufficient sums.
- Points are padded with a ``mask`` (1 = real point); a masked point
  contributes exactly zero to every sum.
- Above the dense pair limit (N C entries) the E step streams point tiles
  instead of materializing (N, C).
- With a process ``group`` the points are this rank's shard: the M-step
  statistics and the free-energy sums are all-reduced over the group, so
  every rank applies the same update (the JAX package's ``axis_name``).
- ``fit``, ``sample`` and ``symm_kl_div`` draw from an explicit
  ``torch.Generator`` on the points' device (the JAX package's PRNG keys);
  ``fit`` also takes the start indices from the caller.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from difficp_torch.ops import backend as _backend
from difficp_torch.ops.reductions import second_min_sqdist
from difficp_torch.utils import profiling


class GMMConfig(NamedTuple):
    """Static configuration."""
    use_outliers: bool = False
    optimize_mu: bool = True
    optimize_sigma: bool = True
    optimize_w: bool = True
    optimize_eta0: bool = True
    ensure_continuum: bool = False  # experimental floor sigma >= intrinsic_scale(mu)


class GMMState(NamedTuple):
    mu: torch.Tensor     # (C, D) centroids
    w: torch.Tensor      # (C,)  component log-scores; pi = softmax(w)
    sigma: torch.Tensor  # ()    isotropic std
    eta0: torch.Tensor   # ()    outlier log-odds-ratio (unused if no outliers)
    vol0: torch.Tensor   # ()    outlier reference volume (0 = not yet set)


def create(mu, sigma=None, use_outliers: bool = False,
           device=None) -> tuple[GMMState, GMMConfig]:
    """GMM state from initial centroids; ``sigma=None`` uses the reference's
    ad hoc initialization, 0.1 x the typical per-centroid radius
    (GMM.py:84-88)."""
    mu = torch.as_tensor(mu, dtype=torch.float32, device=device)
    c, d = mu.shape
    if sigma is None:
        r = float(torch.sqrt(mu.var(0, unbiased=False).sum()))
        sigma = max(0.1 * (r / c ** (1.0 / d)), 1e-6)
    scalar = lambda v: torch.tensor(v, dtype=mu.dtype, device=mu.device)  # noqa: E731
    state = GMMState(mu=mu, w=torch.zeros((c,), dtype=mu.dtype, device=mu.device),
                     sigma=scalar(float(sigma)), eta0=scalar(0.0), vol0=scalar(0.0))
    return state, GMMConfig(use_outliers=use_outliers)


def bbox_volume(x, mask=None):
    """Bounding-box volume of (masked) points, the outlier reference volume
    vol0 (GMM.py:163-171)."""
    if mask is None:
        lo, hi = x.amin(0), x.amax(0)
    else:
        keep = mask[:, None] > 0
        lo = torch.where(keep, x, torch.inf).amin(0)
        hi = torch.where(keep, x, -torch.inf).amax(0)
    return torch.prod(hi - lo)


def set_vol0(state: GMMState, x, mask=None) -> GMMState:
    return state._replace(vol0=bbox_volume(x, mask))


def log_ratio_to_proba(eta):
    """(log p, log q) from a Bernoulli log-odds-ratio eta (GMM.py:205-217)."""
    z = torch.logaddexp(torch.zeros_like(eta), eta)
    return eta - z, -z


def _log_gauss_norm(sigma, d):
    return d * (torch.log(sigma) + 0.5 * math.log(2.0 * math.pi))


def log_responsibilities(state: GMMState, x):
    """lgamma_nc (N, C), without outliers (GMM.py:221-232)."""
    d2 = ((x[:, None, :] - state.mu[None, :, :]) ** 2).sum(-1)
    return torch.log_softmax(state.w[None, :] - d2 / (2.0 * state.sigma**2), 1)


class EMStepOut(NamedTuple):
    state: GMMState
    y: torch.Tensor     # (N, D) quadratic targets
    cfe: torch.Tensor   # ()  free-energy offset
    fe: torch.Tensor    # ()  free energy
    gamt: torch.Tensor  # (N,) inlier responsibility 1 - gamma0 (ones without
    #                     outliers), the weight of each point's quadratic term


class EStepOut(NamedTuple):
    lgam: torch.Tensor   # (N, C) log-responsibilities
    gam: torch.Tensor    # (N, C)
    d2: torch.Tensor     # (N, C) squared distances to centroids
    lgam0: torch.Tensor  # (N,) outlier log-responsibility (zeros if unused)
    lgamt: torch.Tensor  # (N,) log(1 - gamma0)
    gamt: torch.Tensor   # (N,)


class MStats(NamedTuple):
    """Sufficient statistics for the M step (sums over points)."""
    s_gam: torch.Tensor  # (C,)   sum_n m gamma_nc
    s_gx: torch.Tensor   # (C, D) sum_n m gamma_nc x_n
    s_gd2: torch.Tensor  # ()     sum_n m sum_c gamma_nc D2_nc
    s_g0: torch.Tensor   # ()     sum_n m gamma0_n
    s_gt: torch.Tensor   # ()     sum_n m gammaT_n
    n_eff: torch.Tensor  # ()     sum_n m


def _e_step(state: GMMState, x, cfg: GMMConfig) -> EStepOut:
    """E step with old parameters (GMM.py:263-282)."""
    n_pts, d = x.shape
    d2 = ((x[:, None, :] - state.mu[None, :, :]) ** 2).sum(-1)
    log_norm = _log_gauss_norm(state.sigma, d)
    zw = torch.logsumexp(state.w, 0)
    t_nc = state.w[None, :] - zw - d2 / (2.0 * state.sigma**2) - log_norm
    t_n = torch.logsumexp(t_nc, 1)
    lgam = t_nc - t_n[:, None]
    gam = torch.exp(lgam)
    if cfg.use_outliers:
        eta0_n = state.eta0 - torch.log(state.vol0) - t_n
        lgam0, lgamt = log_ratio_to_proba(eta0_n)
        gamt = torch.exp(lgamt)
    else:
        lgam0 = torch.zeros((n_pts,), dtype=x.dtype, device=x.device)
        lgamt = torch.zeros_like(lgam0)
        gamt = torch.ones_like(lgam0)
    return EStepOut(lgam=lgam, gam=gam, d2=d2, lgam0=lgam0, lgamt=lgamt, gamt=gamt)


def _m_stats(e: EStepOut, x, mask) -> MStats:
    gm = e.gam * mask[:, None]
    return MStats(
        s_gam=gm.sum(0),
        s_gx=gm.T @ x,
        s_gd2=(gm * e.d2).sum(),
        s_g0=(mask * torch.exp(e.lgam0)).sum(),
        s_gt=(mask * e.gamt).sum(),
        n_eff=mask.sum(),
    )


def _apply_stats(state: GMMState, stats: MStats, cfg: GMMConfig, d: int) -> GMMState:
    """M step from sufficient statistics (GMM.py:286-299)."""
    new = state
    if cfg.optimize_mu:
        new = new._replace(mu=stats.s_gx / torch.clamp_min(stats.s_gam, 1e-30)[:, None])
    if cfg.use_outliers and cfg.optimize_eta0:
        new = new._replace(eta0=torch.log(torch.clamp_min(stats.s_g0, 1e-30))
                           - torch.log(torch.clamp_min(stats.s_gt, 1e-30)))
    if cfg.optimize_w:
        new = new._replace(w=torch.log(torch.clamp_min(stats.s_gam, 1e-30)))
    if cfg.optimize_sigma:
        sigma = torch.sqrt(stats.s_gd2 / (d * stats.n_eff))
        if cfg.ensure_continuum:
            intr = torch.sqrt(second_min_sqdist(new.mu).mean())
            sigma = torch.maximum(sigma, intr)
        new = new._replace(sigma=sigma)
    return new


def _em_values(new: GMMState, old: GMMState, e: EStepOut, x, mask, cfg: GMMConfig):
    """Quadratic targets Y and local Cfe / quad sums with updated parameters
    (GMM.py:301-323 / 462-496)."""
    d = x.shape[1]
    y = e.gam @ new.mu
    lpi = new.w - torch.logsumexp(new.w, 0)
    log_norm_new = _log_gauss_norm(new.sigma, d)
    mu_sq = (new.mu**2).sum(-1)
    y_sq = (y**2).sum(-1)
    inner = (mu_sq[None, :] - y_sq[:, None]) / (2.0 * new.sigma**2) + e.lgam - lpi[None, :]
    inner = torch.where(e.gam > 0, inner, torch.zeros_like(inner))  # 0 * -inf
    cfe_n = (e.gam * inner).sum(1) + log_norm_new
    if cfg.use_outliers:
        lpi0, lpit = log_ratio_to_proba(new.eta0)
        log_j0 = -torch.log(old.vol0)
        gam0 = torch.exp(e.lgam0)
        cfe_local = (mask * (e.gamt * (cfe_n + e.lgamt - lpit)
                             + gam0 * (-log_j0 + e.lgam0 - lpi0))).sum()
    else:
        cfe_local = (mask * cfe_n).sum()
    quad_local = (mask * e.gamt * ((x - y) ** 2).sum(-1)).sum() / (2.0 * new.sigma**2)
    return y, cfe_local, quad_local


def _group_sum(group, *ts):
    """Each tensor summed over the ranks of ``group`` (None: as it is)."""
    if group is None:
        return ts
    from difficp_torch.parallel.launch import all_reduce

    return tuple(all_reduce(t, group) for t in ts)


def _em_step_dense(state, x, mask, cfg, skip_m, group):
    d = x.shape[1]
    e = _e_step(state, x, cfg)
    new = state if skip_m else _apply_stats(
        state, MStats(*_group_sum(group, *_m_stats(e, x, mask))), cfg, d)
    y, cfe, quad = _em_values(new, state, e, x, mask, cfg)
    cfe, quad = _group_sum(group, cfe, quad)
    return EMStepOut(state=new, y=y, cfe=cfe, fe=cfe + quad, gamt=e.gamt)


def _em_step_tiled(state, x, mask, cfg, skip_m, tile, group):
    """EM step streamed over point tiles: the (N, C) responsibilities are
    only ever held as (tile, C) blocks.  Pass 1 sums the M-step statistics
    with the old parameters; pass 2 recomputes the E step per tile and emits
    targets and energy terms with the updated parameters."""
    n, d = x.shape
    bounds = [(lo, min(lo + tile, n)) for lo in range(0, n, tile)]
    if skip_m:
        new = state
    else:
        stats = None
        for lo, hi in bounds:
            s = _m_stats(_e_step(state, x[lo:hi], cfg), x[lo:hi], mask[lo:hi])
            stats = s if stats is None else MStats(*(a + b for a, b in zip(stats, s)))
        new = _apply_stats(state, MStats(*_group_sum(group, *stats)), cfg, d)
    ys, gamts = [], []
    cfe = quad = torch.zeros((), dtype=x.dtype, device=x.device)
    for lo, hi in bounds:
        e = _e_step(state, x[lo:hi], cfg)
        y, cfe_l, quad_l = _em_values(new, state, e, x[lo:hi], mask[lo:hi], cfg)
        ys.append(y)
        gamts.append(e.gamt)
        cfe = cfe + cfe_l
        quad = quad + quad_l
    cfe, quad = _group_sum(group, cfe, quad)
    return EMStepOut(state=new, y=torch.cat(ys), cfe=cfe, fe=cfe + quad,
                     gamt=torch.cat(gamts))


# points of one E-step tile above the dense pair limit
EM_TILE = 8192


def em_step(state: GMMState, x, mask: Optional[torch.Tensor], cfg: GMMConfig,
            skip_m: bool = False, tile: Optional[int] = None,
            group=None) -> EMStepOut:
    """One (E step, M step) alternation + EM values Y / Cfe / FE (GMM.py:236-325;
    post-M values use the updated parameters, GMM.py:462-496).  ``skip_m``
    computes values only.  Above the dense pair limit (N C entries) the E step
    streams tiles of 8192 points; ``tile`` forces a tile size.  With a
    process ``group``, x and mask are this rank's shard and the M-step
    statistics and the Cfe / quad sums are all-reduced over the group."""
    if mask is None:
        mask = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    if tile is not None:
        return _em_step_tiled(state, x, mask, cfg, skip_m, tile, group)
    if _backend._route("em_step", x.shape[0], state.mu.shape[0]) == "dense":
        return _em_step_dense(state, x, mask, cfg, skip_m, group)
    return _em_step_tiled(state, x, mask, cfg, skip_m, EM_TILE, group)


class EMOptOut(NamedTuple):
    state: GMMState
    y: torch.Tensor
    cfe: torch.Tensor
    fe: torch.Tensor
    n_iters: int
    gamt: torch.Tensor


def em_optimization(state: GMMState, x, mask: Optional[torch.Tensor],
                    cfg: GMMConfig, max_iterations: int = 100,
                    tol: float = 1e-5, group=None) -> EMOptOut:
    """Iterated EM to free-energy tolerance (GMM.py:330-357): at least two
    steps, then stop once |fe - last_fe| < tol |last_fe|.  ``group`` as for
    ``em_step`` (the free energy it stops on is the group's)."""
    if mask is None:
        mask = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
    y = torch.zeros_like(x)
    cfe = torch.zeros((), dtype=x.dtype, device=x.device)
    fe = torch.full((), torch.inf, dtype=x.dtype, device=x.device)
    last_fe = torch.zeros_like(cfe)
    gamt = torch.ones_like(mask)
    i = 0
    while i < max_iterations:
        # a step's span ends at the stop test's read of its free energy
        # (steps 1 to max_iterations - 2 have one), else at its dispatch
        with profiling.span("gmm.em_step", step=i):
            out = em_step(state, x, mask, cfg, group=group)
            state, y, cfe, last_fe, fe, gamt = (out.state, out.y, out.cfe, fe,
                                                out.fe, out.gamt)
            i += 1
            go = i < max_iterations and (
                i < 2 or bool((fe - last_fe).abs() >= tol * last_fe.abs()))
        if not go:
            break
    return EMOptOut(state=state, y=y, cfe=cfe, fe=fe, n_iters=i, gamt=gamt)


def fit(x, c: int, generator: Optional[torch.Generator] = None, mask=None,
        fixed_sigma: Optional[float] = None, optimize_w: bool = False,
        use_outliers: bool = False, max_iterations: int = 100, tol: float = 1e-5,
        idx=None):
    """GMM with C components started at C data points, then EM-optimized
    (reference get_GMM_model, GMM.py:361-383).  The start indices are ``idx``
    when given, else drawn uniformly (or with probabilities proportional to
    ``mask``) from ``generator``, which lies on x's device."""
    if idx is None:
        if mask is None:
            idx = torch.randint(0, x.shape[0], (c,), generator=generator,
                                device=x.device)
        else:
            idx = torch.multinomial(mask / mask.sum(), c, replacement=True,
                                    generator=generator)
    state, cfg = create(x[torch.as_tensor(idx, device=x.device)],
                        use_outliers=use_outliers, device=x.device)
    cfg = cfg._replace(optimize_w=optimize_w)
    if fixed_sigma is not None:
        cfg = cfg._replace(optimize_sigma=False)
        if fixed_sigma > 0:
            state = state._replace(sigma=state.sigma.new_tensor(float(fixed_sigma)))
    if use_outliers:
        state = set_vol0(state, x, mask)
    out = em_optimization(state, x, mask, cfg, max_iterations, tol)
    return out.state, cfg


# ---------------------------------------------------------------------------
# Sampling and likelihoods (GMM.py:543-550, 694-721, 729-735)
# ---------------------------------------------------------------------------

def sample(state: GMMState, generator: Optional[torch.Generator], n: int):
    """N points drawn from the mixture (no outlier term), GMM.py:543-550."""
    mu = state.mu
    comps = torch.multinomial(torch.softmax(state.w, 0), n, replacement=True,
                              generator=generator)
    noise = torch.randn((n, mu.shape[1]), generator=generator, dtype=mu.dtype,
                        device=mu.device)
    return mu[comps] + state.sigma * noise


def log_likelihoods(state: GMMState, x):
    """Per-point log-density under the mixture (GMM.py:714-721), correctly
    normalized: log sum_c pi_c N(mu_c, sigma^2 I)(x), as in the JAX package
    (the reference carries an extra 1/sigma^D factor)."""
    d2 = ((x[:, None, :] - state.mu[None, :, :]) ** 2).sum(-1)
    lpi = torch.log_softmax(state.w, 0)
    return (torch.logsumexp(lpi[None, :] - d2 / (2 * state.sigma**2), 1)
            - _log_gauss_norm(state.sigma, x.shape[1]))


def likelihoods(state: GMMState, x):
    return torch.exp(log_likelihoods(state, x))


def symm_kl_div(state_x: GMMState, state_y: GMMState,
                generator: Optional[torch.Generator] = None, n_sample: int = 1000,
                samples=None):
    """Monte-Carlo symmetric KL divergence between two GMMs (GMM.py:729-735),
    over n_sample points drawn from each, or over ``samples`` = (xs, ys)."""
    if samples is None:
        samples = (sample(state_x, generator, n_sample),
                   sample(state_y, generator, n_sample))
    xs, ys = samples
    kl_xy = (log_likelihoods(state_x, xs) - log_likelihoods(state_y, xs)).mean()
    kl_yx = (log_likelihoods(state_y, ys) - log_likelihoods(state_x, ys)).mean()
    return kl_xy + kl_yx
