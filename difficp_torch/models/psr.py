"""Multiple point set registration, the diffICP algorithm proper (counterpart
of ``difficp_tpu/models/psr.py``).

The alternating free-energy minimization of the reference (PSR.py:42-653):

    F = sum_{k,s} quadloss[k,s] + sum_k regloss[k] + sum_s Cfe[s]
    loop:  GMM_opt (EM on each structure's GMM)  ->  Reg_opt (per-frame
    registration), with F monotone non-increasing (PSR.py:114-127, 226-236).

- Ragged frames and structures are padded with masks (``utils/io``).
- Each structure's EM runs on all frames' warped points jointly, flattened.
- ``Reg_opt`` runs all K frames in lockstep: the L-BFGS lanes are the
  leading K axis of one tensor (``utils/lbfgs``).
- State lives in tensors on ``device``; the class is a thin host-side wrapper.

Support is dense (support = all data points).  Grid and decim support, the
fused ``run()`` loop, ``AffinePSR`` and ``Registration()`` come with later
slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from difficp_torch.models import gmm as gmm_mod
from difficp_torch.models import lddmm as lddmm_mod
from difficp_torch.utils.integrators import tree_map
from difficp_torch.utils.io import PaddedFrames, pad_structures
from difficp_torch.utils.lbfgs import zero_memory
from difficp_torch.utils.spec import as_tensor, resolve_device


def _gmm_opt(state, x, mask, cfg, max_iterations, tol, skip_m=False):
    """EM on one structure over all frames' (flattened, masked) points."""
    k, n, d = x.shape
    x_flat = x.reshape(k * n, d)
    m_flat = mask.reshape(k * n)
    if skip_m:
        out = gmm_mod.em_step(state, x_flat, m_flat, cfg, skip_m=True)
        st, y, cfe, n_iters, gamt = out.state, out.y, out.cfe, 0, out.gamt
    else:
        opt = gmm_mod.em_optimization(state, x_flat, m_flat, cfg,
                                      max_iterations=max_iterations, tol=tol)
        st, y, cfe, n_iters, gamt = opt.state, opt.y, opt.cfe, opt.n_iters, opt.gamt
    return st, y.reshape(k, n, d), cfe, n_iters, gamt.reshape(k, n)


def _quadloss(x1, y, w, sig2):
    """quadloss[k] = sum_n w_n (x1 - y)^2 / (2 sig2_n), with w the padding mask
    times the inlier responsibility gammaT (PSR.py:217-222)."""
    return (w[..., None] * (x1 - y) ** 2 / (2.0 * sig2[..., None])).sum((-2, -1))


def _frame_quad_dataloss(y, sig2, xm, w):
    """Per-frame quadratic GMM dataloss sum_n w_n |pts_n - y_n|^2 / 2s^2
    (PSR.py:217-222), for frames on the leading axis."""

    def dataloss(pts):
        return ((xm * w)[..., None] * (pts - y) ** 2
                / (2.0 * sig2[..., None])).sum((-2, -1))

    return dataloss


def _reg_opt_lddmm(lcfg, q0, a0, y, sig2, qmask, xmask, ptw, nmax, tol,
                   inner, ls_steps, alpha0, mem0, vg0, alpha_qn0, stall0):
    """All-frames LDDMM registration step with dense support (lockstep
    L-BFGS over the momenta; PSR.py:521-569).  Returns new a0, warped points,
    per-frame (regloss, datal, nsteps, change), uncovered counts (zeros: the
    coverage check belongs to grid/decim support), alpha, memory, the
    threaded (grad, final, trajl, datal), n_evals, alpha_qn and stall."""
    dataloss = _frame_quad_dataloss(y, sig2, xmask, ptw)
    res = lddmm_mod.optimize(
        lcfg, dataloss, q0, a0, None, qmask, None, nmax=nmax, tol=tol,
        inner=inner, max_linesearch_steps=ls_steps, alpha0=alpha0,
        alpha_qn0=alpha_qn0, memory0=mem0, warm_vg=vg0, stall0=stall0)
    uncovered = torch.zeros((q0.shape[0], lcfg.nt + 1), dtype=torch.int32,
                            device=q0.device)
    return (res.p0, res.final.q, res.trajl, res.datal, res.n_steps, res.change,
            uncovered, res.alpha, res.memory,
            (res.grad, res.final, res.trajl, res.datal), res.n_evals,
            res.alpha_qn, res.stalled)


class MultiPSR:
    """Common machinery of the registration variants (PSR.py:42-345): padded
    point sets, per-structure GMMs, free-energy bookkeeping with the
    monotonicity warning."""

    def __init__(self, x, gmm_states, gmm_cfgs, device=None):
        self.device = resolve_device(device)
        self.printstuff = True

        self.structs: list[PaddedFrames] = pad_structures(x, self.device)
        self.S = len(self.structs)
        self.K = self.structs[0].k
        self.D = self.structs[0].x.shape[2]

        self.slices = []
        off = 0
        for pf in self.structs:
            self.slices.append((off, off + pf.nmax))
            off += pf.nmax
        self.Ntot = off

        # concatenated (K, Ntot, D) views
        self.x0 = torch.cat([pf.x for pf in self.structs], 1)
        self.xmask = torch.cat([pf.mask for pf in self.structs], 1)
        self.x1 = self.x0
        self.y = self.x0

        if isinstance(gmm_states, gmm_mod.GMMState):
            gmm_states = [gmm_states] * self.S
            gmm_cfgs = [gmm_cfgs] * self.S
        if len(gmm_states) != self.S:
            raise ValueError("need one GMM per structure")
        self.gmm = [gmm_mod.GMMState(*(as_tensor(f, self.device) for f in st))
                    for st in gmm_states]
        self.gmm_cfg = list(gmm_cfgs)
        for s in range(self.S):
            if self.gmm_cfg[s].use_outliers and float(self.gmm[s].vol0) == 0.0:
                pf = self.structs[s]
                self.gmm[s] = gmm_mod.set_vol0(
                    self.gmm[s], pf.x.reshape(-1, self.D), pf.mask.reshape(-1))

        self.ptw = torch.ones_like(self.xmask)

        zeros = lambda *shape: torch.zeros(shape, device=self.device)  # noqa: E731
        self.Cfe = [zeros() for _ in range(self.S)]
        self.regloss = zeros(self.K)
        self.quadloss = zeros(self.K, self.S)
        self.FE: Optional[float] = None
        self.last_reg_stats = None
        self.fe_increase_events = 0

    # ----- structure views ------------------------------------------------

    def struct_view(self, arr, s):
        lo, hi = self.slices[s]
        return arr[:, lo:hi]

    def _sig2_vector(self):
        """(K, Ntot) per-point sigma^2 from each structure's GMM."""
        return torch.cat([
            (self.gmm[s].sigma ** 2).expand(self.K, self.structs[s].nmax)
            for s in range(self.S)], 1)

    def get_warped_data_points(self, k=0, s=0):
        lo, hi = self.slices[s]
        return self.x1[k, lo:hi].detach().cpu().numpy()[: int(self.structs[s].n[k])]

    # ----- GMM updates ----------------------------------------------------

    def _apply_gmm_outputs(self, s, state, y_s, cfe, gamt_s):
        self.gmm[s] = state
        lo, hi = self.slices[s]
        self.y = self.y.clone()
        self.y[:, lo:hi] = y_s
        self.ptw = self.ptw.clone()
        self.ptw[:, lo:hi] = gamt_s
        self.Cfe = list(self.Cfe)
        self.Cfe[s] = cfe
        pf = self.structs[s]
        ql = _quadloss(self.struct_view(self.x1, s), y_s, pf.mask * gamt_s,
                       (state.sigma ** 2).expand(self.K, pf.nmax))
        self.quadloss = self.quadloss.clone()
        self.quadloss[:, s] = ql
        # the registration objective changed: a threaded entry (value, grad)
        # and stall flags no longer hold; curvature memory is kept
        self._reg_vg = None
        self._reg_stall = None

    def update_GMM_targets(self):
        """Recompute targets y / Cfe / quadloss without parameter updates
        (PSR.py:197-213)."""
        for s in range(self.S):
            pf = self.structs[s]
            st, y_s, cfe, _, gamt_s = _gmm_opt(
                self.gmm[s], self.struct_view(self.x1, s), pf.mask,
                self.gmm_cfg[s], 1, 0.0, skip_m=True)
            self._apply_gmm_outputs(s, st, y_s, cfe, gamt_s)
        self.update_FE()

    def GMM_opt(self, max_iterations=100, tol=1e-5):
        """Partial optimization, GMM part (PSR.py:242-271)."""
        for s in range(self.S):
            pf = self.structs[s]
            st, y_s, cfe, iters, gamt_s = _gmm_opt(
                self.gmm[s], self.struct_view(self.x1, s), pf.mask,
                self.gmm_cfg[s], max_iterations, tol)
            self._apply_gmm_outputs(s, st, y_s, cfe, gamt_s)
            if self.printstuff:
                msg = f"GMM optim (structure {s}) : {int(iters)} EM steps"
                if self.gmm_cfg[s].use_outliers:
                    p0 = 1.0 / (1.0 + math.exp(-float(self.gmm[s].eta0)))
                    msg += f", p_outlier={p0:.4}"
            else:
                msg = None
            self.update_FE(message=msg)

    # ----- free energy ----------------------------------------------------

    def _update_quadlosses(self):
        cols = []
        for s in range(self.S):
            pf = self.structs[s]
            cols.append(_quadloss(
                self.struct_view(self.x1, s), self.struct_view(self.y, s),
                pf.mask * self.struct_view(self.ptw, s),
                (self.gmm[s].sigma ** 2).expand(self.K, pf.nmax)))
        self.quadloss = torch.stack(cols, 1)

    def update_FE(self, message=None):
        """F bookkeeping with monotonicity check (PSR.py:226-236); the one
        host sync per partial step."""
        fe = float(sum(self.Cfe) + self.regloss.sum() + self.quadloss.sum())
        if self.printstuff and message is not None:
            print(message.ljust(70) + f"Total free energy = {fe:.8}")
        if self.FE is not None and fe > self.FE + 1e-4 * abs(self.FE) + 1e-6:
            self.fe_increase_events += 1
            print("WARNING: measured increase in free energy ! Should not happen.")
        self.FE = fe

    def Reg_opt(self, tol=1e-3, nmax=10):
        raise NotImplementedError


class DiffPSR(MultiPSR):
    """MultiPSR with diffeomorphic (LDDMM) registrations (PSR.py:354-569),
    dense support."""

    def __init__(self, x, gmm_states, gmm_cfgs,
                 lddmm_cfg: lddmm_mod.LDDMMConfig, device=None):
        super().__init__(x, gmm_states, gmm_cfgs, device)
        self.lcfg = lddmm_cfg
        # default support: all data points of each frame (PSR.py:394-397)
        self.support_scheme = None
        self.rho = None
        self.q0 = self.x0
        self.qmask = self.xmask
        self.a0 = torch.zeros_like(self.q0)
        self._reg_alpha = None
        self._reg_alpha_qn = None
        self._reg_memory = None
        self.last_reg_evals = None
        self.initialize_a0()
        self.update_GMM_targets()

    def initialize_a0(self):
        """a0 for zero initial speeds (PSR.py:406-413): exactly zero when
        eta == 0."""
        self._reg_vg = None
        self._reg_stall = None
        if self.lcfg.eta != 0.0:
            raise NotImplementedError(
                "gradcomponent=True needs v2p (models/calibration, "
                "ops/solvers), which comes with the eta != 0 slice")
        self.a0 = torch.zeros_like(self.q0)

    def set_support_scheme(self, scheme="decim", rho=1.0, xticks=None,
                           yticks=None, q0=None):
        """Grid, decim and custom support (PSR.py:430-493)."""
        raise NotImplementedError(
            f"support scheme {scheme!r} is not ported yet: it comes with the "
            "grid-support slice (external-point kernels, kmin2)")

    def Reg_opt(self, tol=1e-3, nmax=10, inner=20, ls_steps=25,
                carry_memory=False, carry_value=False, frame_chunk=None):
        """LDDMM registration optimization (PSR.py:521-569): ``nmax`` outer
        steps of ``inner`` L-BFGS iterations each.

        ``carry_memory``: thread each frame's curvature memory into the next
        call.  ``carry_value``: thread the previous call's (loss, gradient,
        arrival state) at a0, skipping the entry value+grad while the
        objective is unchanged (any EM target update invalidates it).
        ``frame_chunk``: run the K frames in sequential chunks of at most this
        many lanes; all per-frame threaded state is sliced per chunk."""
        sig2 = self._sig2_vector()
        k = self.q0.shape[0]
        alpha0 = self._reg_alpha
        if alpha0 is None:
            alpha0 = torch.zeros((k,), device=self.device)
        mem0 = None
        if carry_memory:
            mem0 = self._reg_memory
            if mem0 is None:
                mem0 = zero_memory(k, self.a0[0].numel(), device=self.device)
        vg0 = self._reg_vg if carry_value else None
        stall0 = self._reg_stall if carry_value else None
        aqn0 = self._reg_alpha_qn

        def _slice(t, sl):
            return tree_map(lambda a: a[sl], t)

        fc = k if frame_chunk is None else max(1, min(frame_chunk, k))
        parts = []
        for lo in range(0, k, fc):
            sl = slice(lo, min(lo + fc, k))
            parts.append(_reg_opt_lddmm(
                self.lcfg, self.q0[sl], self.a0[sl], self.y[sl], sig2[sl],
                self.qmask[sl], self.xmask[sl], self.ptw[sl], nmax, tol, inner,
                ls_steps, alpha0[sl], _slice(mem0, sl), _slice(vg0, sl),
                _slice(aqn0, sl), _slice(stall0, sl)))
        out = parts[0] if len(parts) == 1 else tree_map(
            lambda *xs: torch.cat(xs, 0), *parts)
        (a0, x1, trajl, datal, nsteps, change, uncovered, alpha, mem, vg,
         nevals, alpha_qn, stalled) = out
        self._reg_alpha_qn = alpha_qn
        self._reg_stall = stalled
        self.last_reg_evals = nevals
        self._reg_alpha = alpha
        if carry_memory:
            self._reg_memory = mem
        self.a0 = a0
        # vg holds (grad, final, trajl, datal) at the new a0: valid for the
        # next call until the objective moves (_apply_gmm_outputs nulls it)
        self._reg_vg = vg
        self.x1 = x1
        self.regloss = trajl
        self._update_quadlosses()

        self.last_reg_stats = dict(nsteps=nsteps, change=change, datal=datal,
                                   uncovered=uncovered)
        if self.printstuff:
            total_loss = float(trajl.sum() + datal.sum())
            msg = f"Reg_opt ({self.K} frames in lockstep) : loss={total_loss:.4}"
        else:
            msg = None
        self.update_FE(message=msg)

    def run(self, *args, **kwargs):
        raise NotImplementedError(
            "the fused run() loop is not ported yet: call GMM_opt and Reg_opt")

    def Registration(self, k=0):
        raise NotImplementedError(
            "Registration() needs models/registration.py, which comes with the "
            "grid-support slice")
