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

Support is dense (support = all data points, the default), a greedy
decimation of each frame's points (decim), a grid or custom points; with
decim, grid or custom support the data are advected as external points and
each ``Reg_opt`` ends with a coverage pass over the saved trajectory.
``AffinePSR`` fits each frame's affine map in closed form, all frames in one
batched call.  ``run()`` is the fused loop's semantics as a Python loop.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from difficp_torch.models import affine as affine_mod
from difficp_torch.models import gmm as gmm_mod
from difficp_torch.models import lddmm as lddmm_mod
from difficp_torch.models.registration import AffineRegistration, LDDMMRegistration
from difficp_torch.ops import backend as red
from difficp_torch.utils.integrators import tree_map
from difficp_torch.utils.io import PaddedFrames, pad_frames, pad_structures
from difficp_torch.utils.lbfgs import zero_memory
from difficp_torch.utils.point_sets import decimate_sets, grid_support
from difficp_torch.utils.spec import as_tensor, resolve_device


def _gmm_opt(state, x, mask, cfg, max_iterations, tol, skip_m=False, group=None):
    """EM on one structure over all frames' (flattened, masked) points; with
    a process ``group``, this rank's frames, the sums reduced over it."""
    k, n, d = x.shape
    x_flat = x.reshape(k * n, d)
    m_flat = mask.reshape(k * n)
    if skip_m:
        out = gmm_mod.em_step(state, x_flat, m_flat, cfg, skip_m=True, group=group)
        st, y, cfe, n_iters, gamt = out.state, out.y, out.cfe, 0, out.gamt
    else:
        opt = gmm_mod.em_optimization(state, x_flat, m_flat, cfg,
                                      max_iterations=max_iterations, tol=tol,
                                      group=group)
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


def _reg_opt_lddmm(lcfg, q0, a0, x0, y, sig2, qmask, xmask, ptw, nmax, tol,
                   use_ext, inner, ls_steps, alpha0, mem0, vg0, alpha_qn0, stall0,
                   r_cover_warn=2.0, coverage_check=True):
    """All-frames LDDMM registration step (lockstep L-BFGS over the momenta;
    PSR.py:521-569).  With external points (``use_ext``) and
    ``coverage_check`` one more shoot saves the trajectory, and every data
    point of every frame at every time step is checked for coverage by the
    support in one batched call (PSR.py:556-566); without ``coverage_check``
    the warped points are those of the optimizer's own final shoot and the
    counts are zero.  Returns new a0, warped points, per-frame (regloss,
    datal, nsteps, change), per-frame uncovered counts (K, nt + 1), alpha,
    memory, the threaded (grad, final, trajl, datal), n_evals, alpha_qn and
    stall."""
    dataloss = _frame_quad_dataloss(y, sig2, xmask, ptw)
    res = lddmm_mod.optimize(
        lcfg, dataloss, q0, a0, x0 if use_ext else None, qmask,
        xmask if use_ext else None, nmax=nmax, tol=tol,
        inner=inner, max_linesearch_steps=ls_steps, alpha0=alpha0,
        alpha_qn0=alpha_qn0, memory0=mem0, warm_vg=vg0, stall0=stall0)
    if use_ext and coverage_check:
        with torch.no_grad():
            final, traj = lddmm_mod.shoot(lcfg, q0, res.p0, x0, qmask, xmask,
                                          save_traj=True)
            uncov = red.check_coverage(traj.x, traj.q, lcfg.sigma, r_cover_warn,
                                       mask_x=xmask, mask_y=qmask)
        x1 = final.x
        uncovered = uncov.sum(-1).to(torch.int32).T.contiguous()
    else:
        x1 = res.final.x if use_ext else res.final.q
        uncovered = torch.zeros((q0.shape[0], lcfg.nt + 1), dtype=torch.int32,
                                device=q0.device)
    return (res.p0, x1, res.trajl, res.datal, res.n_steps, res.change,
            uncovered, res.alpha, res.memory,
            (res.grad, res.final, res.trajl, res.datal), res.n_evals,
            res.alpha_qn, res.stalled)


def _v2p_all(lcfg, q0, v_target, qmask, rcond, version="pinv"):
    """``lddmm.v2p`` of every frame at once (frames on the leading axis)."""
    with torch.no_grad():
        return lddmm_mod.v2p(lcfg, q0, v_target, rcond=rcond, version=version, qmask=qmask)


def _v_all(lcfg, x, q, p, qmask):
    """``lddmm.v`` of every frame at once: the field of (q, p) at x."""
    with torch.no_grad():
        return lddmm_mod.v(lcfg, x, q, p, qmask)


def _reg_opt_affine(acfg, x0, y, z, w, xmask):
    """All-frames closed-form affine fits (PSR.py:620-653), one batched call."""
    return affine_mod.optimize(acfg, x0, y, z, w=w, mask=xmask)


class MultiPSR:
    """Common machinery of the registration variants (PSR.py:42-345): padded
    point sets, per-structure GMMs, free-energy bookkeeping with the
    monotonicity warning.

    ``group``: a ``torch.distributed`` process group over which the frames
    are sharded (``parallel.atlas.shard_psr``), None for all frames here.
    With a group, the EM sums and the free energy's per-frame sums are
    reduced over it; the registration of each frame is this rank's alone."""

    def __init__(self, x, gmm_states, gmm_cfgs, device=None):
        self.device = resolve_device(device)
        self.printstuff = True
        self.group = None

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

    def get_data_points(self, k=0, s=0):
        lo, hi = self.slices[s]
        return self.x0[k, lo:hi].detach().cpu().numpy()[: int(self.structs[s].n[k])]

    def get_warped_data_points(self, k=0, s=0):
        lo, hi = self.slices[s]
        return self.x1[k, lo:hi].detach().cpu().numpy()[: int(self.structs[s].n[k])]

    def get_template(self, s=0):
        return self.gmm[s].mu.detach().cpu().numpy()

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
                self.gmm_cfg[s], 1, 0.0, skip_m=True, group=self.group)
            self._apply_gmm_outputs(s, st, y_s, cfe, gamt_s)
        self.update_FE()

    def GMM_opt(self, max_iterations=100, tol=1e-5):
        """Partial optimization, GMM part (PSR.py:242-271)."""
        for s in range(self.S):
            pf = self.structs[s]
            st, y_s, cfe, iters, gamt_s = _gmm_opt(
                self.gmm[s], self.struct_view(self.x1, s), pf.mask,
                self.gmm_cfg[s], max_iterations, tol, group=self.group)
            self._apply_gmm_outputs(s, st, y_s, cfe, gamt_s)
            if self.printstuff:
                msg = f"GMM optim (structure {s}) : {int(iters)} EM steps"
                if self.gmm_cfg[s].use_outliers:
                    p0 = 1.0 / (1.0 + math.exp(-float(self.gmm[s].eta0)))
                    msg += f", p_outlier={p0:.4}"
            else:
                msg = None
            self.update_FE(message=msg)

    def reinitialize_GMM(self, s=None, do_mu=True, do_sigma=True, seed=0):
        """Ad hoc re-initialization adapted to upcoming EM (PSR.py:143-167),
        drawn with numpy from ``seed`` as in the JAX package."""
        rng = np.random.default_rng(seed)
        slist = range(self.S) if s is None else [s]
        changed = False
        for si in slist:
            pf = self.structs[si]
            pts = np.concatenate([pf.unpad(k) for k in range(self.K)], axis=0)
            g = self.gmm[si]
            if do_mu and self.gmm_cfg[si].optimize_mu:
                mu = pts.mean(0) + 0.05 * pts.std() * rng.standard_normal(
                    (g.mu.shape[0], self.D)).astype(np.float32)
                g = g._replace(mu=as_tensor(mu, self.device))
                changed = True
            if do_sigma and self.gmm_cfg[si].optimize_sigma:
                g = g._replace(sigma=as_tensor(np.float32(0.25 * pts.std()), self.device))
                changed = True
            self.gmm[si] = g
        if changed:
            # a re-initialization starts a fresh descent: reset the monotone-FE
            # tracker so the (legitimate) jump is not flagged
            self.FE = None
            self.update_GMM_targets()

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
        host sync per partial step.  With a group the per-frame sums are
        reduced over it, once (the Cfe are already the group's)."""
        fe = float(self._fe_terms(sum(self.Cfe), self.regloss.sum(), self.quadloss.sum()))
        if self.printstuff and message is not None:
            print(message.ljust(70) + f"Total free energy = {fe:.8}")
        if self.FE is not None and fe > self.FE + 1e-4 * abs(self.FE) + 1e-6:
            self.fe_increase_events += 1
            print("WARNING: measured increase in free energy ! Should not happen.")
        self.FE = fe

    def _fe_terms(self, cfe, regl, quad):
        """cfe + regl + quad, the two frame sums (regl, quad) summed over the
        group's ranks, in one reduction, when there is one."""
        if self.group is not None:
            from difficp_torch.parallel.launch import all_reduce

            regl, quad = all_reduce(torch.stack([regl, quad]), self.group)
        return cfe + regl + quad

    def _gmm_pass(self, max_em, em_tol):
        """EM on every structure from the current warped points: new GMM
        states, targets y, weights ptw and the Cfe of each structure."""
        ys, ptws, cfes = [], [], []
        for s in range(self.S):
            xs = self.struct_view(self.x1, s)
            ms = self.structs[s].mask
            opt = gmm_mod.em_optimization(
                self.gmm[s], xs.reshape(-1, self.D), ms.reshape(-1),
                self.gmm_cfg[s], max_iterations=max_em, tol=em_tol, group=self.group)
            self.gmm[s] = opt.state
            ys.append(opt.y.reshape(xs.shape))
            ptws.append(opt.gamt.reshape(ms.shape))
            cfes.append(opt.cfe)
        return torch.cat(ys, 1), torch.cat(ptws, 1), torch.stack(cfes)

    def _close_run(self, fes, n_iters):
        """FE bookkeeping after a fused run of ``n_iters`` alternations whose
        free energies are ``fes`` (tensors): increases are counted over the
        sequence and against the FE before the run (PSR.py:114-127); the
        host bookkeeping is refreshed (``update_GMM_targets``).  Returns the
        sequence as numpy."""
        fes_host = torch.stack(fes).double().cpu().numpy()
        inc = int(np.sum(np.diff(fes_host) > 1e-4 * np.abs(fes_host[:-1]) + 1e-6))
        if self.FE is not None and fes_host[0] > self.FE + 1e-4 * abs(self.FE):
            inc += 1
        if inc and self.printstuff:
            print("WARNING: measured increase in free energy ! Should not happen.")
        self.fe_increase_events += inc
        self.FE = float(fes_host[-1])
        keep, self.printstuff = self.printstuff, False
        self.update_GMM_targets()  # refresh y/ptw/Cfe/quadloss consistently
        self.printstuff = keep
        if self.printstuff:
            print(f"run({n_iters}) : FE {fes_host[0]:.6} -> {self.FE:.6}")
        return fes_host

    def Reg_opt(self, tol=1e-3, nmax=10):
        raise NotImplementedError


class DiffPSR(MultiPSR):
    """MultiPSR with diffeomorphic (LDDMM) registrations (PSR.py:354-569)."""

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
        # start momenta whose free energy is not recorded yet (eta != 0)
        self._start_pending = False
        self.initialize_a0()
        self.update_GMM_targets()

    def initialize_a0(self, rcond=1e-3):
        """a0 for (approximately) zero initial speeds (PSR.py:406-413):
        exactly zero when eta == 0, else the momenta v2p gives for a zero
        field, whose gradcomponent right-hand side is not zero."""
        self._reg_vg = None
        self._reg_stall = None
        if self.lcfg.eta == 0.0:
            self.a0 = torch.zeros_like(self.q0)
            return
        with torch.no_grad():
            self.a0 = lddmm_mod.v2p(self.lcfg, self.q0, torch.zeros_like(self.q0),
                                    rcond=rcond, qmask=self.qmask)
        self._start_pending = True

    def _record_start(self):
        """The free energy of start momenta that are not zero (eta != 0), taken
        before the first optimization step after them: one shoot gives the
        warped points and the trajectory loss of a0, the targets follow, and
        the result is recorded as a new baseline (momenta set anew are a new
        start, not a descent step), so that the monotone-FE check compares the
        first step with a0's own free energy.  Until then x1 and regloss stay
        as they were (x0 and 0 after the set-up), as the JAX package and the
        reference keep them, which omits a0's energy."""
        if not self._start_pending:
            return
        self._start_pending = False
        use_ext = self.support_scheme is not None
        with torch.no_grad():
            final, _ = lddmm_mod.shoot(self.lcfg, self.q0, self.a0,
                                       self.x0 if use_ext else None, self.qmask,
                                       self.xmask if use_ext else None)
            self.regloss = lddmm_mod.trajloss(self.lcfg, self.q0, self.a0, final.cost,
                                              self.qmask)
        self.x1 = final.x if use_ext else final.q
        self.FE = None
        self.update_GMM_targets()

    def GMM_opt(self, max_iterations=100, tol=1e-5):
        """Partial optimization, GMM part (PSR.py:242-271), after recording
        the free energy of new start momenta."""
        self._record_start()
        super().GMM_opt(max_iterations, tol)

    def update_a0(self, q0_prev, qmask_prev, a0_prev=None, rcond=1e-1):
        """Project the previous vector field onto the new support
        (PSR.py:415-425)."""
        if a0_prev is None:
            a0_prev = self.a0
        with torch.no_grad():
            v_new = lddmm_mod.v(self.lcfg, self.q0, q0_prev, a0_prev, qmask_prev)
            self.a0 = lddmm_mod.v2p(self.lcfg, self.q0, v_new, rcond=rcond,
                                    qmask=self.qmask)
        self._reg_vg = None  # new support / momenta: stale entry (value, grad)
        self._reg_stall = None
        self._start_pending = self.lcfg.eta != 0.0

    def set_support_scheme(self, scheme="decim", rho=1.0, xticks=None,
                           yticks=None, q0=None):
        """Choose LDDMM support points (PSR.py:430-493) at the cover radius
        rho * sigma: a greedy decimation of each frame's points, all its
        structures together (decim: a support of each frame's own, padded to
        one width with masks), a rectangular grid covering the data with that
        step, or custom points (the same support for every frame)."""
        r_cover = rho * self.lcfg.sigma
        if scheme == "decim":
            sets = [[self.structs[s].unpad(k) for s in range(self.S)] for k in range(self.K)]
            kept = iter(decimate_sets([xs for frame in sets for xs in frame], r_cover))
            per_frame = []
            for k, frame in enumerate(sets):
                allk = np.concatenate([xs[next(kept)[0]] for xs in frame], axis=0)
                if self.printstuff:
                    ntot = sum(xs.shape[0] for xs in frame)
                    print(f"Decimation, frame {k} : {allk.shape[0]} support points "
                          f"({allk.shape[0] / ntot:.0%} of original sets)")
                per_frame.append(allk)
            padded = pad_frames(per_frame, self.device)
            q0_new, qmask_new = padded.x, padded.mask
        elif scheme in ("grid", "custom"):
            if scheme == "grid":
                ticks = None
                if xticks is not None and yticks is not None:
                    ticks = [np.asarray(xticks), np.asarray(yticks)]
                pts = grid_support(self.x0.detach().cpu().numpy().reshape(-1, self.D),
                                   r_cover, ticks=ticks)
            else:
                if q0 is None:
                    raise ValueError("custom support needs q0")
                pts = np.asarray(q0.detach().cpu() if isinstance(q0, torch.Tensor) else q0,
                                 np.float32)
            q0_new = as_tensor(pts, self.device).expand(self.K, *pts.shape).contiguous()
            qmask_new = torch.ones((self.K, pts.shape[0]), device=self.device)
        else:
            raise ValueError(f"Unknown support scheme: {scheme}")
        self.rho = rho
        self.support_scheme = scheme
        q0_prev, qmask_prev = self.q0, self.qmask
        self.q0, self.qmask = q0_new, qmask_new
        self.update_a0(q0_prev, qmask_prev, rcond=1e-1)
        # the momentum parameter space changed: carried L-BFGS curvature
        # pairs refer to the old support and are meaningless now
        self._reg_memory = None

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
        self._record_start()
        use_ext = self.support_scheme is not None
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
                self.lcfg, self.q0[sl], self.a0[sl], self.x0[sl], self.y[sl],
                sig2[sl], self.qmask[sl], self.xmask[sl], self.ptw[sl], nmax, tol,
                use_ext, inner, ls_steps, alpha0[sl], _slice(mem0, sl),
                _slice(vg0, sl), _slice(aqn0, sl), _slice(stall0, sl)))
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
            unc = uncovered.cpu().numpy()
            if use_ext and unc.sum() > 0:
                print(f"WARNING : uncovered points during shooting "
                      f"(max {unc.max()} at one time step). Choose a smaller rho.")
            total_loss = float(trajl.sum() + datal.sum())
            msg = f"Reg_opt ({self.K} frames in lockstep) : loss={total_loss:.4}"
        else:
            msg = None
        self.update_FE(message=msg)

    def run(self, n_iters: int, max_em: int = 25, em_tol: float = 1e-3,
            reg_nmax: int = 10, reg_tol: float = 1e-3, reg_inner: int = 20,
            reg_ls: int = 25, carry_memory: bool = False):
        """``n_iters`` full alternations (GMM EM + lockstep registration), the
        semantics of the JAX package's fused loop (``_run_loop_lddmm``) as a
        Python loop: no coverage pass, no threaded entry value or stall
        flags; the line-search step, quasi-Newton scale and (with
        ``carry_memory``) curvature memory carry from one iteration to the
        next.  FE = sum Cfe + sum trajl + quad per iteration; host
        bookkeeping is refreshed at the end (``update_GMM_targets``).

        :return: per-iteration free-energy sequence (numpy array).
        """
        if n_iters <= 0:
            return np.zeros((0,), np.float64)
        self._record_start()
        use_ext = self.support_scheme is not None
        k = self.K
        alpha = self._reg_alpha
        if alpha is None:
            alpha = torch.zeros((k,), device=self.device)
        aqn = self._reg_alpha_qn
        mem = self._reg_memory if carry_memory else None
        if carry_memory and mem is None:
            mem = zero_memory(k, self.a0[0].numel(), device=self.device)
        fes = []
        for _ in range(n_iters):
            y, ptw, cfes = self._gmm_pass(max_em, em_tol)
            sig2 = self._sig2_vector()
            res = lddmm_mod.optimize(
                self.lcfg, _frame_quad_dataloss(y, sig2, self.xmask, ptw),
                self.q0, self.a0, self.x0 if use_ext else None, self.qmask,
                self.xmask if use_ext else None, nmax=reg_nmax, tol=reg_tol,
                inner=reg_inner, max_linesearch_steps=reg_ls, alpha0=alpha,
                alpha_qn0=aqn, memory0=mem)
            self.a0 = res.p0
            self.x1 = res.final.x if use_ext else res.final.q
            self.regloss = res.trajl
            alpha, aqn = res.alpha, res.alpha_qn
            if carry_memory:
                mem = res.memory
            quad = ((self.xmask * ptw)[..., None] * (self.x1 - y) ** 2
                    / (2.0 * sig2[..., None])).sum()
            fes.append(self._fe_terms(cfes.sum(), res.trajl.sum(), quad))
        self._reg_alpha = alpha
        self._reg_alpha_qn = aqn
        if carry_memory:
            self._reg_memory = mem
        return self._close_run(fes, n_iters)

    def Registration(self, k=0) -> LDDMMRegistration:
        return LDDMMRegistration(cfg=self.lcfg, q0=self.q0[k], a0=self.a0[k],
                                 qmask=self.qmask[k])

    def trajectories(self, k=0, support=False):
        """Shoot trajectories for frame k (viz; PSR.py:310-345)."""
        use_ext = self.support_scheme is not None
        with torch.no_grad():
            _, traj = lddmm_mod.shoot(
                self.lcfg, self.q0[k], self.a0[k], self.x0[k] if use_ext else None,
                self.qmask[k], self.xmask[k] if use_ext else None, save_traj=True)
        if use_ext and not support:
            return traj.x.cpu().numpy()
        return traj.q.cpu().numpy()


class AffinePSR(MultiPSR):
    """MultiPSR with affine registrations (PSR.py:578-653)."""

    def __init__(self, x, gmm_states, gmm_cfgs, affine_cfg: affine_mod.AffineConfig,
                 device=None):
        super().__init__(x, gmm_states, gmm_cfgs, device)
        self.acfg = affine_cfg
        self.M = torch.eye(self.D, device=self.device).expand(self.K, self.D, self.D)
        self.t = torch.zeros((self.K, self.D), device=self.device)
        self.update_GMM_targets()

    def _fit(self, y, ptw):
        # z_n = gammaT_n / (2 sigma_s^2) (PSR.py:630-633, with the inlier
        # weight of the outlier model); w_n = gammaT_n for the logdet term
        z = ptw / (2.0 * self._sig2_vector())
        fit = _reg_opt_affine(self.acfg, self.x0, y, z, ptw, self.xmask)
        self.M, self.t, self.x1 = fit.m, fit.t, fit.tx
        self.regloss = fit.regl
        return fit

    def Reg_opt(self, tol=1e-3, nmax=1):
        fit = self._fit(self.y, self.ptw)
        self._update_quadlosses()
        if self.printstuff:
            total = float(fit.datal.sum() + fit.regl.sum())
            msg = f"Affine Reg_opt ({self.K} frames) : loss={total:.4}"
        else:
            msg = None
        self.update_FE(message=msg)

    def run(self, n_iters: int, max_em: int = 25, em_tol: float = 1e-3, **_):
        """``n_iters`` alternations of (GMM EM, closed-form affine fits), the
        JAX package's fused loop (``_run_loop_affine``) as a Python loop.
        FE = sum Cfe + sum regl + quad per iteration.

        :return: per-iteration free-energy sequence (numpy array).
        """
        if n_iters <= 0:
            return np.zeros((0,), np.float64)
        fes = []
        for _ in range(n_iters):
            y, ptw, cfes = self._gmm_pass(max_em, em_tol)
            sig2 = self._sig2_vector()
            fit = self._fit(y, ptw)
            quad = ((self.xmask * ptw)[..., None] * (fit.tx - y) ** 2
                    / (2.0 * sig2[..., None])).sum()
            fes.append(self._fe_terms(cfes.sum(), fit.regl.sum(), quad))
        return self._close_run(fes, n_iters)

    def Registration(self, k=0) -> AffineRegistration:
        return AffineRegistration(cfg=self.acfg, m=self.M[k], t=self.t[k])

    def trajectories(self, k=0, **_):
        return np.stack(affine_mod.shoot(self.acfg, self.M[k], self.t[k], self.x0[k]))
