"""The ``diffpsr`` entry: ``DiffPSR`` (``difficp_torch/models/psr.py``) built
from a configuration as its source builds it, and driven one outer iteration
at a time by the calls of the source's loop body (``GMM_opt``, then the
configuration's ``Reg_opt`` calls), with the source's stop.

Configuration keys read here: ``lddmm`` (sigma, lambd, version, nt,
scheme), ``support`` (scheme: "dense", the data themselves, or "grid" with
its ``rho``, set by ``set_support_scheme`` as ``api/icp_atlas.py`` sets it;
the reference has no decim support), ``gmm`` (init_from
"frame0" or "target", C, sigma or null for gmm.create's rule, the
optimize_* flags, use_outliers) and ``loop`` (max_iterations,
convergence_tolerance or null for none, em_in_first_iteration, em:
max_iterations and tol, reg_calls: the keyword arguments of each Reg_opt
call).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from difficp_torch.models import gmm as gmm_mod
from difficp_torch.models import lddmm as lddmm_mod
from difficp_torch.models.psr import DiffPSR
from difficp_torch.ops import rhs_self
from perfbench.harness import traffic


def problem(config: dict, mix: dict, seed: int) -> dict:
    """The cell's sets, drawn once on the host, and the extent of the data
    the comparisons are scaled by (the same in every order)."""
    if config["support"]["scheme"] not in ("dense", "grid"):
        raise ValueError(f"no reference for support {config['support']['scheme']!r}")
    g = config["gmm"]
    drawn = traffic.draw(mix, g["init_from"], int(g["C"]))
    x0 = np.stack(drawn[0])
    lo, hi = x0.reshape(-1, x0.shape[-1]).min(0), x0.reshape(-1, x0.shape[-1]).max(0)
    # lossgrads: the evaluations that the Reg_opt calls of ``iteration`` made
    # with external points (grid support), where no self-RHS kernel counts them
    return {"config": config, "drawn": drawn, "seed": int(seed),
            "extent": float((hi - lo).max()), "lossgrads": 0}


def inputs(prob: dict, cohort: int) -> dict:
    """The inputs of registration ``cohort`` of the run: the frames in its
    order, their padded array and mask, and the GMM's start points."""
    frames, _, mu0 = traffic.permute(prob["drawn"], prob["seed"], cohort)
    x0 = np.stack(frames)
    return {"cohort": int(cohort), "frames": frames, "x0": x0,
            "xmask": np.ones(x0.shape[:2], np.float32), "mu0": mu0}


class Registration:
    """One registration: a fresh DiffPSR on the inputs of registration
    ``cohort`` and its iteration count, last free energy and whether the
    source's stop has come."""

    def __init__(self, prob: dict, device, cohort: int):
        cfg = prob["config"]
        g, lc = cfg["gmm"], cfg["lddmm"]
        self.inputs = inputs(prob, cohort)
        state, _ = gmm_mod.create(self.inputs["mu0"], sigma=g["sigma"], device=device)
        gcfg = gmm_mod.GMMConfig(use_outliers=g["use_outliers"], optimize_mu=g["optimize_mu"],
                                 optimize_sigma=g["optimize_sigma"],
                                 optimize_w=g["optimize_w"], optimize_eta0=g["optimize_eta0"])
        lcfg = lddmm_mod.make_config(sigma=lc["sigma"], lambd=lc["lambd"],
                                     version=lc["version"], nt=lc["nt"], scheme=lc["scheme"])
        frames = self.inputs["frames"]
        psr = DiffPSR(frames if len(frames) > 1 else frames[0], state, gcfg, lcfg,
                      device=device)
        psr.printstuff = False
        if cfg["support"]["scheme"] == "grid":
            psr.set_support_scheme("grid", rho=float(cfg["support"]["rho"]))
        self.psr, self.cfg, self.it, self.last_fe, self.done = psr, cfg, 0, None, False
        self.prob = prob


def eval_count(prob: dict) -> float:
    """Loss+grad evaluations so far.  Dense support: one self-RHS backward
    launch per Euler step of each.  Grid support: the L-BFGS's own count
    (``DiffPSR.last_reg_evals``), taken after each Reg_opt call in the
    window by ``iteration``."""
    config = prob["config"]
    if config["support"]["scheme"] == "dense":
        return rhs_self.launches["rhs_self_bwd"] / int(config["lddmm"]["nt"])
    return float(prob["lossgrads"])


def shapes(reg: Registration) -> dict:
    """The shapes the RHS run at in this cell, for the rooflines: the self
    RHS on the support, or the RHS with external points."""
    psr = reg.psr
    k, m, d = psr.q0.shape
    if psr.support_scheme is None:
        return {"self": {"frames": k, "points": m, "d": d,
                         "valid": [float(v) for v in psr.qmask.sum(-1).cpu()]}}
    return {"ext": {"frames": k, "support": m, "points": psr.x0.shape[1], "d": d}}


def _host(t):
    return t.detach().cpu().numpy()


def _gmm(psr):
    g = psr.gmm[0]
    return {"mu": _host(g.mu), "w": _host(g.w), "sigma": float(g.sigma)}


def iteration(reg: Registration, spans, snap=None):
    """One outer iteration of the source's loop on ``reg``: GMM_opt (not in a
    registration's first iteration where the source skips it), then each
    Reg_opt call, then the source's stop test.  With ``snap`` (a dict) the
    state and outputs that the check reads are copied into it.  Returns
    whether the free energy rose or turned non-finite."""
    psr, loop = reg.psr, reg.cfg["loop"]
    em = reg.it != 0 or loop["em_in_first_iteration"]
    events = psr.fe_increase_events
    ext = psr.support_scheme is not None
    # the frames' points without the program's padding (dense support: the
    # support's too)
    n = reg.inputs["x0"].shape[1]
    data = lambda t: _host(t)[:, :n]  # noqa: E731
    supp = _host if ext else data
    if snap is not None:
        snap.update(inputs=reg.inputs, it=reg.it, em=em, gmm_before=_gmm(psr),
                    x1_before=data(psr.x1), a0_before=supp(psr.a0))
    if em:
        with spans("GMM_opt"):
            psr.GMM_opt(max_iterations=loop["em"]["max_iterations"], tol=loop["em"]["tol"])
    if snap is not None:
        snap.update(fe_mid=psr.FE, gmm_after=_gmm(psr))
    # the lockstep's evaluations in each call: the entry's, and the most
    # line-search trials a frame made (every trial evaluates all frames)
    evals = []
    with spans("Reg_opt"):
        for call in loop["reg_calls"]:
            entry = not call.get("carry_value") or psr._reg_vg is None
            psr.Reg_opt(**call)
            if ext:
                evals.append(int(entry) + psr.last_reg_evals.max())
    reg.prob["lossgrads"] += int(sum(evals))
    if snap is not None:
        snap.update(fe=psr.FE, x1_after=data(psr.x1), a0_after=supp(psr.a0),
                    grad=supp(psr._reg_vg[0]), q0=supp(psr.q0))
        if ext:
            snap["uncovered"] = _host(psr.last_reg_stats["uncovered"])
    tol = loop["convergence_tolerance"]
    if tol is not None and reg.it > 1 and abs(psr.FE - reg.last_fe) < tol * abs(reg.last_fe):
        reg.done = True
    reg.last_fe = psr.FE
    reg.it += 1
    if reg.it >= loop["max_iterations"]:
        reg.done = True
    return psr.fe_increase_events > events or not math.isfinite(psr.FE)


def warm_up(prob: dict, device):
    """The cell's own shapes once, on a registration that is thrown away: a
    GMM_opt, a Reg_opt of one step (an entry loss+grad and a line search)."""
    reg = Registration(prob, device, 0)
    loop = reg.cfg["loop"]
    reg.psr.GMM_opt(max_iterations=2, tol=loop["em"]["tol"])
    call = dict(loop["reg_calls"][0], nmax=1, inner=1)
    reg.psr.Reg_opt(**call)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
