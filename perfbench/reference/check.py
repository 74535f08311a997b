"""The comparison that decides ``correct``: what the timed path produced in
one outer iteration of the window, held against the plain reference worked
out again from the inputs.

The reference follows the program step by step from the program's own state
at the start of the sampled iteration (its GMM parameters, warped points and
momenta there), since an L-BFGS in float64 would take other steps than the
program's float32 one.  It checks by themselves the start that this skips:
the support (the data, with dense support; the grid, with grid support)
and, in the first iteration of a registration, the GMM's start from the
inputs.  Dense support shoots the data themselves (``lddmm.py``); grid
support advects the data by the support's field and ends each registration
with a coverage pass (``ext.py``).  Decim support has no reference yet.

Numbers, each held to its limit (``perfbench/checks/<cell>.json``):

- ``em_err``: the GMM after the iteration's EM against float64 EM from the
  same start on the same warped points (centroids over the data's extent,
  sigma relative, mixture weights absolute; the largest);
- ``fe_err``: the free energy after the EM and after the registration
  against the reference's at the program's momenta, over the size of its
  terms (|Cfe| + |trajectory loss| + data loss: the free energy is a small
  difference of large terms);
- ``x1_err``: the warped points after the registration against a float64
  shoot of the program's momenta: each frame's largest distance over the
  data's extent, the worst frame;
- ``grad_err``: the registration's gradient at the momenta it returns
  against float64 autograd through the shoot, per frame, over the larger of
  its reference norm and the size of its terms, which cancel near a
  minimum (the norm of lambda grad H = lambda v(q0) at the momenta; with
  grid support also that of the data loss's gradient); the worst frame;
- ``reg_stall``: whether the registration moved: per frame 1 - P / D, P
  the drop of the reference's objective from the momenta before the
  iteration's Reg_opt calls to those after them, D the drop that one
  float64 steepest-descent step from the momenta before gets (from the
  L-BFGS's first trial, min(1, 1/|g|), by the minima of quadratic fits
  until the drop reaches 1e-4 of its first-order prediction); the worst
  frame.  A registration that returns
  the momenta it was given reads 1; one that gets as far as one gradient
  step reads 0 or less;
- ``q0_diff``: the support against the reference's, exactly;
- ``cover_diff`` (grid support): the coverage pass's counts of uncovered
  points, per frame and Euler state, at the momenta the registration
  returns, against the float64 trajectory's: the points by which a count
  lies outside the range that ``ext.cover_band`` allows, summed.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import ext as rext
from perfbench.reference import gmm as rgmm
from perfbench.reference import lddmm as rlddmm
from perfbench.reference.precision import dtype

# the steepest-descent step of ``reg_stall``: trials at most, and the share
# of the first-order decrease that ends the search
SD_TRIALS = 6
SD_ARMIJO = 1e-4


def support(problem: dict, inputs: dict):
    """(q0, qmask) of the configuration, worked out from the registration's
    inputs: with dense support the data themselves, with grid support the
    grid over all frames' points."""
    scheme = problem["config"]["support"]["scheme"]
    if scheme == "dense":
        return inputs["x0"], inputs["xmask"]
    if scheme == "grid":
        return rext.support(problem["config"], inputs["x0"])
    raise ValueError(f"no reference for support {scheme!r}")


def start_state(problem: dict, inputs: dict, dev, dt) -> rgmm.State:
    """The GMM's start, from the inputs: centroids at the drawn points,
    sigma as the configuration states or by gmm.create's ad hoc rule."""
    mu = torch.as_tensor(inputs["mu0"], device=dev, dtype=dt)
    sig = problem["config"]["gmm"]["sigma"]
    sig = rgmm.start_sigma(mu) if sig is None else float(sig)
    return rgmm.State(mu=mu, w=torch.zeros(mu.shape[0], device=dev, dtype=dt),
                      sigma=torch.tensor(sig, device=dev, dtype=dt))


def outputs(problem: dict, snap: dict, prec: str, device) -> dict:
    """The outputs the reference (``float64``, with the steepest-descent
    step of ``reg_stall``) or the control (``tf32``) gives for the sampled
    iteration, in the shape of the program's."""
    cfg = problem["config"]
    lcfg, loop = cfg["lddmm"], cfg["loop"]
    dt = dtype(prec)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device, dtype=dt)  # noqa: E731
    q0_np, qmask_np = support(problem, snap["inputs"])
    q0, qm = t(q0_np), t(qmask_np)
    xm = t(snap["inputs"]["xmask"])
    # the data: the support itself with dense support, else advected by it
    x0 = q0 if cfg["support"]["scheme"] == "dense" else t(snap["inputs"]["x0"])
    k, n, d = x0.shape

    # the EM stage, from the program's state at the iteration's start, or
    # from the inputs in the first iteration of a registration
    if snap["it"] == 0:
        st0, x1_before = start_state(problem, snap["inputs"], device, dt), x0
    else:
        g = snap["gmm_before"]
        st0 = rgmm.State(mu=t(g["mu"]), w=t(g["w"]), sigma=t(g["sigma"]))
        x1_before = t(snap["x1_before"])
    xf, mf = x1_before.reshape(k * n, d), xm.reshape(k * n)
    if snap["em"]:
        cands = rgmm.em_optimization(st0, xf, mf, cfg["gmm"], loop["em"]["max_iterations"],
                                     loop["em"]["tol"], prec)
    else:
        st, tg = rgmm.em_step(st0, xf, mf, cfg["gmm"], prec, skip_m=True)
        cands = [(0, st, tg)]

    return dict(q0=q0_np, em=cands,
                **_registration(lcfg, q0, qm, x0, xm, snap, cands, prec, t))


def _registration(lcfg, q0, qm, x0, xm, snap, cands, prec, t):
    """Free energies, warped points and gradient at the program's momenta,
    with the targets of the EM candidate nearest the program's GMM; in
    float64 also each frame's objective before and after the Reg_opt calls
    and the drop of one steepest-descent step.  With data apart from the
    support (``x0`` is not ``q0``) also the coverage pass at the momenta
    after: in float64 the range of sound counts, else the counts."""
    k, n, d = x0.shape
    _, st, tg = min(cands, key=lambda c: _em_err(snap["gmm_after"], c[1], snap["extent"]))
    y = tg.y.reshape(k, n, d)
    wts = xm * tg.gamt.reshape(k, n)
    sig2 = st.sigma ** 2
    ext = x0 is not q0

    def loss(a, keep=False):
        if ext:
            return rext.loss(lcfg, q0, a, qm, x0, xm, y, wts, sig2, prec, keep)
        return rlddmm.loss(lcfg, q0, a, qm, y, wts, sig2, prec) + (None,)

    def objective(a):
        trajl, datal, _, _ = loss(a)
        return trajl, datal

    out = {}
    a_b = t(snap["a0_before"])
    if prec == "float64":
        a_b.requires_grad_(True)
        trajl_b, datal_b = objective(a_b)
        f_b = trajl_b + datal_b
        (g_b,) = torch.autograd.grad(f_b.sum(), a_b)
        trajl_b, datal_b, f_b, a_b = trajl_b.detach(), datal_b.detach(), f_b.detach(), a_b.detach()
        out.update(f_before=f_b.cpu().numpy(), sd_drop=_sd_drop(objective, a_b, f_b, g_b))
    else:
        with torch.no_grad():
            trajl_b, datal_b = objective(a_b)
    fe_mid = float(tg.cfe + trajl_b.sum() + datal_b.sum())
    # the free energy is a small difference of large terms: its errors are
    # taken against the size of its terms
    scale_mid = float(tg.cfe.abs() + trajl_b.abs().sum() + datal_b.sum())
    a0 = t(snap["a0_after"]).requires_grad_(True)
    trajl, datal, pts, states = loss(a0, keep=ext)
    if ext:
        (gdata,) = torch.autograd.grad(datal.sum(), a0, retain_graph=True)
    (grad,) = torch.autograd.grad((trajl + datal).sum(), a0)
    if ext:
        with torch.no_grad():
            d2 = rext.min_sqdist(states, qm)
            del states
            band = 0.0
            if prec == "float64":
                f32 = lambda a: a.detach().float()  # noqa: E731
                *_, witness = rext.shoot(lcfg, f32(q0), f32(a0), f32(qm), f32(x0), f32(xm),
                                         "float32", keep=True)
                band = rext.cover_band(lcfg, d2, rext.min_sqdist(witness, f32(qm)))
                del witness
            sure, maybe = rext.cover_counts(lcfg, d2, xm, band)
            del d2
        if prec == "float64":
            out.update(cover=(sure, maybe), cover_band=band)
        else:
            out["uncovered"] = sure
    # the size of the gradient's terms, which cancel near a minimum: that of
    # lambda H, lambda v(q0) at the momenta; with data apart from the support
    # also that of the data loss, which the divergence cost summed over the
    # data, a term as large, balances
    with torch.no_grad():
        v0, _, _ = rlddmm.self_rhs(q0, a0.detach(), qm, float(lcfg["sigma"]), False, prec)
        gscale = float(lcfg["lambd"]) * v0.reshape(k, -1).norm(dim=1)
        if ext:
            gscale = torch.maximum(gscale, gdata.reshape(k, -1).norm(dim=1))
    fe = float(tg.cfe + trajl.detach().sum() + datal.detach().sum())
    scale = float(tg.cfe.abs() + trajl.detach().abs().sum() + datal.detach().sum())
    if prec == "float64":
        out["f_after"] = (trajl + datal).detach().cpu().numpy()
    return dict(out, fe_mid=fe_mid, fe=fe, fe_mid_scale=scale_mid, fe_scale=scale,
                x1=pts.detach().cpu().double().numpy(),
                grad=grad.detach().cpu().double().numpy(),
                grad_scale=gscale.cpu().double().numpy())


def _sd_drop(objective, a, f, g):
    """Per frame, the drop of the objective that one steepest-descent step
    from ``a`` gets: from the L-BFGS's first trial min(1, 1/|g|) along -g,
    each trial that falls short of SD_ARMIJO of its first-order prediction
    is followed by the minimum of the quadratic through (0, f, -|g|^2) and
    it (a thousandth of it where it is not finite), for SD_TRIALS trials at
    most; the largest drop seen (0 where none is positive)."""
    k = a.shape[0]
    gg = (g.reshape(k, -1) ** 2).sum(1)
    step = torch.clamp(1.0 / torch.sqrt(gg).clamp_min(1e-300), max=1.0)
    best = torch.zeros_like(f)
    todo = gg > 0
    with torch.no_grad():
        for _ in range(SD_TRIALS):
            if not bool(todo.any()):
                break
            trial = a - step.reshape((k,) + (1,) * (a.dim() - 1)) * g
            drop = f - sum(objective(trial))
            finite = torch.isfinite(drop)
            best = torch.where(todo & finite, torch.maximum(best, drop), best)
            todo = todo & ~(finite & (drop >= SD_ARMIJO * step * gg))
            quad = gg * step * step / (2.0 * (gg * step - drop))
            nxt = torch.where(finite, torch.clamp(quad, min=step * 1e-6, max=step / 2),
                              step * 1e-3)
            step = torch.where(todo, nxt, step)
    return best.cpu().numpy()


def _em_err(prog_gmm: dict, st: rgmm.State, extent: float) -> float:
    mu_p = np.asarray(prog_gmm["mu"], np.float64)
    mu_r = st.mu.detach().cpu().double().numpy()
    sig_r = float(st.sigma)
    pi = lambda w: np.exp(w - np.logaddexp.reduce(w))  # noqa: E731
    return max(float(np.abs(mu_p - mu_r).max()) / extent,
               abs(float(prog_gmm["sigma"]) - sig_r) / sig_r,
               float(np.abs(pi(np.asarray(prog_gmm["w"], np.float64))
                            - pi(st.w.detach().cpu().double().numpy())).max()))


def program_outputs(snap: dict) -> dict:
    """The program's outputs of the sampled iteration, in the reference's
    shape."""
    out = {"q0": snap["q0"], "gmm_after": snap["gmm_after"], "fe_mid": snap["fe_mid"],
           "fe": snap["fe"], "x1": snap["x1_after"], "grad": snap["grad"]}
    if "uncovered" in snap:
        out["uncovered"] = snap["uncovered"]
    return out


def control_outputs(ctrl: dict) -> dict:
    """The control's outputs (the reference in the lower precision) in the
    program's shape: its GMM is its own EM's."""
    _, st, _ = ctrl["em"][0]
    g = {"mu": st.mu.detach().cpu().double().numpy(),
         "w": st.w.detach().cpu().double().numpy(), "sigma": float(st.sigma)}
    return dict({k: v for k, v in ctrl.items() if k != "em"}, gmm_after=g)


def stall(ref: dict) -> np.ndarray:
    """Per frame 1 - P / D of ``reg_stall`` (0 where the steepest-descent
    step finds no drop: the momenta are stationary)."""
    p = ref["f_before"] - ref["f_after"]
    d = ref["sd_drop"]
    return np.where(d > 0, 1.0 - p / np.where(d > 0, d, 1.0), 0.0)


def frame_errors(got: dict, ref: dict, extent: float) -> dict:
    """Per frame: the warped points' largest distance from the reference's
    over the data's extent (``x1``), and the gradient's distance from the
    reference's over the larger of the reference's norm and the size of its
    terms (``grad``)."""
    d = np.abs(np.asarray(got["x1"], np.float64) - ref["x1"])
    k = d.shape[0]
    g_p = np.asarray(got["grad"], np.float64)
    g_r = ref["grad"]
    den = np.maximum(np.sqrt((g_r.reshape(k, -1) ** 2).sum(1)), ref["grad_scale"])
    return {"x1": d.reshape(k, -1).max(1) / extent,
            "grad": np.sqrt(((g_p - g_r).reshape(k, -1) ** 2).sum(1)) / np.maximum(den, 1e-300)}


def cover_diff(got, ref: dict) -> float:
    """The points by which the program's uncovered counts (frames, nt + 1)
    lie outside the reference's sound range, summed (inf where the shapes
    differ or no count was given)."""
    sure, maybe = ref["cover"]
    if got is None or np.shape(got) != np.shape(sure):
        return float("inf")
    c = np.asarray(got, np.int64)
    return float((np.maximum(sure - c, 0) + np.maximum(c - maybe, 0)).sum())


def numbers(got: dict, ref: dict, extent: float) -> dict:
    """Each compared number of ``got`` (the program's or the control's
    outputs) against the reference's."""
    em = min(_em_err(got["gmm_after"], st, extent) for _, st, _ in ref["em"])
    fe = max(abs(got[k] - ref[k]) / max(ref[f"{k}_scale"], 1e-300) for k in ("fe_mid", "fe"))
    fr = frame_errors(got, ref, extent)
    q0 = float(np.abs(np.asarray(got["q0"], np.float64) - ref["q0"]).max()) \
        if np.shape(got["q0"]) == np.shape(ref["q0"]) else float("inf")
    out = {"em_err": em, "fe_err": fe, "x1_err": float(fr["x1"].max()),
           "grad_err": float(fr["grad"].max()), "reg_stall": float(stall(ref).max()),
           "q0_diff": q0}
    if "cover" in ref:
        out["cover_diff"] = cover_diff(got.get("uncovered"), ref)
    return out
