"""'Standard' diffeomorphic point-set registration (Glaunès et al. 2004 /
Deformetrica style): a deformable template warped onto each data set under an
RKHS measure-distance loss (counterpart of
``difficp_tpu/models/psr_standard.py``; reference
diffICP/core/PSR_standard.py:37-686).

- ``data_distance``: the RKHS distance of point clouds seen as (weighted)
  measures (PSR_standard.py:37-58); each inner product is one kernel-sum
  through the backend (``backend.kred_scal``), for all frames at once.
- Energy E = sum_{k,s} dataloss[k,s] / noise_std[s]^2 + sum_k regloss[k],
  monotone under the alternating Reg_opt / Template_opt (PSR_standard.py:
  168-177, 311-316), counted by ``e_increase_events``.
- ``Reg_opt``: the K frames' momenta on the lanes of ``utils/lbfgs`` in
  lockstep (the JAX package vmaps one frame).
- ``Template_opt``: one L-BFGS lane over one structure's template (and its
  weights with ``template_weights``), its gradient through all K frozen
  shoots in one backward: the template is expanded over the frames and
  autograd sums their gradients (PSR_standard.py:226-255).
- When the template moves, a dense support moves with it and the momenta are
  re-projected on the new span (PSR_standard.py:299-309); decim support is
  decimated again.
- ``run``: the JAX package's fused loop (``_run_loop_std``) as a Python loop.

The support ``q0`` (M, D) is shared by the frames, as in the JAX package;
the momenta ``a0`` are (K, M, D).  The template has no padding, so no
support mask is used.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from difficp_torch.models import affine as affine_mod
from difficp_torch.models import lddmm as lddmm_mod
from difficp_torch.models.registration import AffineRegistration, LDDMMRegistration
from difficp_torch.ops import backend as red
from difficp_torch.utils.io import pad_structures
from difficp_torch.utils.lbfgs import lbfgs_optimize, zero_memory
from difficp_torch.utils.point_sets import decimate, grid_support
from difficp_torch.utils.spec import as_tensor, resolve_device

# the energy may rise by this much relative (plus an absolute 1e-6) before it
# counts as an increase (PSR_standard.py:311-316)
_E_RTOL = 1e-4


def data_distance(x, y, sigma, w=None, mask_x=None, mask_y=None, skip_xx=False):
    """RKHS distance between data x (..., Nx, D) and (weighted) template y
    (..., Ny, D), per frame (PSR_standard.py:37-58):

        L = <fx, fx> + <fy, fy> - 2 <fy, fx>,   fx = 1/Nx sum_i K(., x_i),
        fy = 1/Ny sum_j K(., y_j)  (or sum_j w_j K(., y_j) with weights w).

    Differentiable in y and w.  Masked points carry zero weight.
    ``skip_xx=True`` drops <fx, fx>, constant in y and w, so optimizers over
    the template skip the largest (Nx^2-pair) kernel-sum; reported losses
    keep it (the default)."""

    def ones(a):
        return torch.ones(a.shape[:-1], dtype=a.dtype, device=a.device)

    def inner(a, b, wa, wb):
        # <fa, fb> = sum_i wa_i [sum_j K(a_i - b_j) wb_j]
        return (wa * red.kred_scal(a, b, wb, sigma)).sum(-1)

    mx = ones(x) if mask_x is None else mask_x
    wx = (mx / mx.sum(-1, keepdim=True)).expand(x.shape[:-1])
    if w is None:
        my = ones(y) if mask_y is None else mask_y
        wy = my / my.sum(-1, keepdim=True)
    else:
        wy = w if mask_y is None else w * mask_y
    wy = wy.expand(y.shape[:-1])
    out = inner(y, y, wy, wy) - 2.0 * inner(y, x, wy, wx)
    if not skip_xx:
        out = out + inner(x, x, wx, wx)
    return out


def _frame_rkhs_dataloss(x, xmask, w0, noise2, data_sigma, slices):
    """The frames' RKHS dataloss sum_s data_distance(x_s, pts_s) / noise2_s
    with skip_xx, pts (K, Ny_tot, D) -> (K,) (PSR_standard.py:168-177): the
    one builder of the stepwise Reg_opt, the fused run and the affine fits.
    ``w0`` is the concatenated template weights or None."""

    def dataloss(pts):
        loss = 0.0
        for s, (ylo, yhi, xlo, xhi) in enumerate(slices):
            loss = loss + data_distance(
                x[..., xlo:xhi, :], pts[..., ylo:yhi, :], data_sigma,
                w=None if w0 is None else w0[ylo:yhi], mask_x=xmask[..., xlo:xhi],
                skip_xx=True) / noise2[s]
        return loss

    return dataloss


def _flat(ys, ws):
    """One L-BFGS lane (1, n) over a template (and its weights)."""
    parts = [ys.reshape(-1)] + ([] if ws is None else [ws])
    return torch.cat(parts)[None]


def _unflat(p, like_y, use_weights):
    n = like_y.numel()
    ys = p[0, :n].reshape(like_y.shape)
    return ys, (p[0, n:] if use_weights else None)


def _lane_opt(lossfn, y0s, w0s, use_weights, nmax, tol, alpha0, inner=20, ls_steps=25,
              mem0=None, vg0=None, alpha_qn0=None):
    """L-BFGS (one lane) over one structure's template (and weights):
    (ys, ws, loss, n_steps, alpha, memory, (loss, grad), alpha_qn)."""
    res = lbfgs_optimize(
        lambda p: lossfn(*_unflat(p, y0s, use_weights))[None],
        _flat(y0s, w0s if use_weights else None), nmax=nmax, tol=tol, inner=inner,
        max_linesearch_steps=ls_steps, alpha0=alpha0, alpha_qn0=alpha_qn0, memory0=mem0,
        value0=None if vg0 is None else vg0[0], grad0=None if vg0 is None else vg0[1])
    ys, ws = _unflat(res.params, y0s, use_weights)
    return (ys, ws if use_weights else w0s, res.loss, res.n_steps, res.alpha, res.memory,
            (res.loss, res.grad), res.alpha_qn)


def _template_opt_std(lcfg, q0, a0, x_s, xm_s, y0s, w0s, data_sigma, noise2, nmax, tol,
                      use_weights, alpha0, inner=20, ls_steps=25, mem0=None, vg0=None,
                      alpha_qn0=None):
    """L-BFGS over one structure's template (and weights), the gradient through
    all K frozen shoots (q0, a0 (K, M, D)) in one backward
    (PSR_standard.py:226-255).  ``mem0`` / ``vg0``: the curvature memory and
    (loss, grad) of the previous call, valid only while q0, a0, the data and
    the noise are unchanged."""
    k = a0.shape[0]
    order = red.row_order(q0, lcfg.sigma, None, lcfg.eta, x=y0s.expand(k, *y0s.shape))

    def lossfn(ys, ws):
        final, _ = lddmm_mod.shoot(lcfg, q0, a0, ys.expand(k, *ys.shape), order=order)
        return data_distance(x_s, final.x, data_sigma, w=ws, mask_x=xm_s,
                             skip_xx=True).sum() / noise2

    return _lane_opt(lossfn, y0s, w0s, use_weights, nmax, tol, alpha0, inner, ls_steps,
                     mem0, vg0, alpha_qn0)


class MultiPSRStd:
    """Common machinery (reference MultiPSR_std, PSR_standard.py:67-316):
    padded data, the exact-size template of each structure, the (K, S)
    dataloss with its constant <fx, fx> term cached in float64, and the
    energy bookkeeping with the monotonicity warning."""

    def __init__(self, x, y_template, noise_std, data_sigma,
                 template_weights: bool = False, device=None):
        self.device = resolve_device(device)
        self.printstuff = True
        self.data_sigma = float(data_sigma)

        self.structs = pad_structures(x, self.device)
        self.S = len(self.structs)
        self.K = self.structs[0].k
        self.D = self.structs[0].x.shape[2]

        # the template y0[s]: exact sizes, one copy for all frames
        if not isinstance(y_template, (list, tuple)):
            y_template = [y_template] * self.S
        self.y0 = [as_tensor(t, self.device) for t in y_template]
        self.ny = [t.shape[0] for t in self.y0]

        if not isinstance(noise_std, (list, tuple)):
            noise_std = [noise_std] * self.S
        self.noise_std = [float(v) for v in noise_std]

        # the data (K, Ntot_x, D) and the slices (ylo, yhi, xlo, xhi) of each
        # structure along the template's and the data's concatenated axes
        self.x = torch.cat([pf.x for pf in self.structs], 1)
        self.xmask = torch.cat([pf.mask for pf in self.structs], 1)
        self.slices = []
        yo = xo = 0
        for s in range(self.S):
            self.slices.append((yo, yo + self.ny[s], xo, xo + self.structs[s].nmax))
            yo += self.ny[s]
            xo += self.structs[s].nmax
        self.ny_tot = yo

        self.template_weights = template_weights
        if template_weights:
            self.w0 = [torch.ones(n, device=self.device) / n for n in self.ny]
        else:
            self.w0 = [None] * self.S

        # the warped templates (K, Ntot_y, D)
        self.y1 = self.ally0.expand(self.K, self.ny_tot, self.D)

        self.regloss = np.zeros(self.K)
        self.dataloss = np.zeros((self.K, self.S))
        self.E: Optional[float] = None
        self.e_increase_events = 0
        self._xx_cache = None

    @property
    def noise2(self):
        return [v**2 for v in self.noise_std]

    @property
    def ally0(self):
        return torch.cat(self.y0, 0)

    @property
    def w0_cat(self):
        if not self.template_weights:
            return None
        return torch.cat(self.w0, 0)

    def _frames(self, a):
        """A tensor shared by the frames, expanded to (K, ...)."""
        return a.expand(self.K, *a.shape).contiguous()

    def get_template(self, s=0):
        return self.y0[s].detach().cpu().numpy()

    def get_warped_template(self, k=0, s=0):
        ylo, yhi, _, _ = self.slices[s]
        return self.y1[k, ylo:yhi].detach().cpu().numpy()

    def get_data_points(self, k=0, s=0):
        return self.structs[s].unpad(k)

    def _dataloss_ks(self, k, s):
        """One (k, s) entry of the dataloss, <fx, fx> included, on its own."""
        ylo, yhi, xlo, xhi = self.slices[s]
        with torch.no_grad():
            return float(data_distance(
                self.x[k, xlo:xhi], self.y1[k, ylo:yhi], self.data_sigma, w=self.w0[s],
                mask_x=self.xmask[k, xlo:xhi])) / self.noise2[s]

    def _const_xx(self):
        """The (K, S) constant <fx, fx> / noise^2 (the data-only term) in
        float64, one kernel-sum over all frames a structure."""
        cols = []
        with torch.no_grad():
            for s, (_, _, xlo, xhi) in enumerate(self.slices):
                xs, ms = self.x[:, xlo:xhi], self.xmask[:, xlo:xhi]
                wx = ms / ms.sum(-1, keepdim=True)
                v = (wx * red.kred_scal(xs, xs, wx, self.data_sigma)).sum(-1)
                cols.append(v.double().cpu().numpy() / self.noise2[s])
        return np.stack(cols, axis=1)

    def _datalosses_ydep(self, y1, w0cat):
        """The y-dependent part <fy, fy> - 2 <fy, fx> of the (K, S) dataloss,
        a kernel-sum call over all frames for each term and structure."""
        cols = []
        for s, (ylo, yhi, xlo, xhi) in enumerate(self.slices):
            cols.append(data_distance(
                self.x[:, xlo:xhi], y1[:, ylo:yhi], self.data_sigma,
                w=None if w0cat is None else w0cat[ylo:yhi],
                mask_x=self.xmask[:, xlo:xhi], skip_xx=True) / self.noise2[s])
        return torch.stack(cols, 1)

    def update_datalosses(self):
        """Refresh the (K, S) dataloss matrix: the constant <fx, fx> once and
        cached, the y-dependent terms for all frames with one host readback."""
        if self._xx_cache is None:
            self._xx_cache = self._const_xx()
        with torch.no_grad():
            ydep = self._datalosses_ydep(self.y1, self.w0_cat)
        self.dataloss = self._xx_cache + ydep.double().cpu().numpy()

    def _count_increase(self, e):
        if self.E is not None and e > self.E + _E_RTOL * abs(self.E) + 1e-6:
            self.e_increase_events += 1
            print("WARNING: measured increase in optimization energy ! Should not happen.")
        self.E = float(e)

    def update_E(self, message=None):
        e = float(self.regloss.sum()) + float(self.dataloss.sum())
        if self.printstuff and message is not None:
            print(message.ljust(70) + f"Total energy = {e:.8}")
        self._count_increase(e)

    def Reg_opt(self, nmax=10, tol=1e-3):
        raise NotImplementedError

    def Template_opt(self, nmax=10, tol=1e-3):
        raise NotImplementedError


class DiffPSRStd(MultiPSRStd):
    """The standard algorithm with LDDMM registrations (reference DiffPSR_std,
    PSR_standard.py:364-564)."""

    def __init__(self, x, y_template, noise_std, lcfg: lddmm_mod.LDDMMConfig,
                 data_sigma, template_weights: bool = False, device=None):
        super().__init__(x, y_template, noise_std, data_sigma, template_weights, device)
        self.lcfg = lcfg
        self.support_scheme = None
        self.rho = None
        self.q0 = self.ally0
        # the L-BFGS state threaded from one call to the next
        self._reg_alpha = self._reg_alpha_qn = self._reg_memory = self._reg_vg = None
        self._tmpl_alpha = self._tmpl_alpha_qn = self._tmpl_mem = self._tmpl_vg = None
        self.initialize_a0()
        self.update_datalosses()
        self.update_E()

    # ----- momenta (PSR_standard.py:422-440) -----------------------------

    def initialize_a0(self, rcond=1e-3):
        """Zero momenta at eta = 0 (zero speeds), else v2p's for a zero
        field."""
        m = self.q0.shape[0]
        if self.lcfg.eta == 0.0:
            self.a0 = torch.zeros((self.K, m, self.D), device=self.device)
            return
        with torch.no_grad():
            p = lddmm_mod.v2p(self.lcfg, self.q0[None], torch.zeros_like(self.q0)[None],
                              rcond=rcond)
        self.a0 = p.expand(self.K, m, self.D).contiguous()

    def update_a0(self, q0_prev, a0_prev=None, rcond=1e-2):
        """Project each frame's vector field onto the new support."""
        if a0_prev is None:
            a0_prev = self.a0
        q = self._frames(self.q0)
        with torch.no_grad():
            v_new = lddmm_mod.v(self.lcfg, q, self._frames(q0_prev), a0_prev)
            self.a0 = lddmm_mod.v2p(self.lcfg, q, v_new, rcond=rcond)
        # the support moved: carried curvature pairs refer to the old momentum
        # space, and the template objective depends on (q0, a0), both moved
        self._reg_memory = self._reg_vg = None
        self._tmpl_mem = self._tmpl_vg = None

    def set_support_scheme(self, scheme="decim", rho=1.0, xticks=None, yticks=None,
                           q0=None):
        """Support points from the decimated template, a grid or custom
        points, at the cover radius rho * sigma (PSR_standard.py:445-502)."""
        r_cover = rho * self.lcfg.sigma
        if scheme == "decim":
            pts = []
            for s in range(self.S):
                ys = self.get_template(s)
                kept, _ = decimate(ys, r_cover)
                pts.append(ys[kept])
            q0_new = as_tensor(np.concatenate(pts, axis=0), self.device)
            if self.printstuff:
                print(f"Decimation : {q0_new.shape[0]} support points")
        elif scheme == "grid":
            ticks = None
            if xticks is not None and yticks is not None:
                ticks = [np.asarray(xticks), np.asarray(yticks)]
            pts = grid_support(self.ally0.detach().cpu().numpy(), r_cover, ticks=ticks)
            q0_new = as_tensor(pts, self.device)
        elif scheme == "custom":
            if q0 is None:
                raise ValueError("custom support needs q0")
            q0_new = as_tensor(q0, self.device)
        else:
            raise ValueError(f"Unknown support scheme: {scheme}")
        self.rho = rho
        self.support_scheme = scheme
        q0_prev, self.q0 = self.q0, q0_new
        self.update_a0(q0_prev, rcond=1e-2)

    def _x0(self, use_ext):
        return self._frames(self.ally0) if use_ext else None

    # ----- partial optimizations ------------------------------------------

    def Reg_opt(self, nmax=10, tol=1e-3, inner=20, ls_steps=25, carry_memory=False,
                carry_value=False):
        """All frames' LDDMM registration of the template onto their data.
        ``carry_memory``: thread the curvature memory into the next call.
        ``carry_value``: thread the previous call's (loss, gradient, arrival)
        at a0, skipping the entry value+grad; valid until the template,
        support or momenta move (Template_opt and update_a0 drop it)."""
        use_ext = self.support_scheme is not None
        alpha0 = self._reg_alpha
        if alpha0 is None:
            # cold: lbfgs_optimize seeds ~1/||g0|| from its entry evaluation
            alpha0 = torch.zeros((self.K,), device=self.device)
        mem0 = None
        if carry_memory:
            mem0 = self._reg_memory
            if mem0 is None:
                mem0 = zero_memory(self.K, self.a0[0].numel(), device=self.device)
        vg0 = self._reg_vg if carry_value else None
        dataloss = _frame_rkhs_dataloss(self.x, self.xmask, self.w0_cat, self.noise2,
                                        self.data_sigma, self.slices)
        res = lddmm_mod.optimize(
            self.lcfg, dataloss, self._frames(self.q0), self.a0, self._x0(use_ext),
            nmax=nmax, tol=tol, inner=inner, max_linesearch_steps=ls_steps, alpha0=alpha0,
            alpha_qn0=self._reg_alpha_qn, memory0=mem0, warm_vg=vg0)
        self._reg_alpha, self._reg_alpha_qn = res.alpha, res.alpha_qn
        if carry_memory:
            self._reg_memory = res.memory
        self._reg_vg = (res.grad, res.final, res.trajl, res.datal)
        # a0 moved: the template objective's threaded (value, grad) is stale
        # (its curvature memory tolerates the drift)
        self._tmpl_vg = None
        self.a0 = res.p0
        self.y1 = res.final.x if use_ext else res.final.q
        self.regloss = res.trajl.double().cpu().numpy()
        self.update_datalosses()
        self.update_E(message=f"Reg_opt ({self.K} frames in lockstep) : "
                              f"loss={float(res.trajl.sum() + res.datal.sum()):.4}")

    def Template_opt(self, nmax=10, tol=1e-3, inner=20, ls_steps=25, carry_memory=False,
                     carry_value=False):
        """L-BFGS over each structure's template positions (and weights), the
        gradient through all K shoots (PSR_standard.py:226-255).
        ``carry_memory`` / ``carry_value``: thread each structure's curvature
        memory / entry (loss, grad) into the next call, while the template
        objective is unchanged: a Reg_opt drops the value, a dense or decim
        support update both."""
        tmpl_alpha = self._tmpl_alpha or [None] * self.S
        tmpl_aqn = self._tmpl_alpha_qn or [None] * self.S
        tmpl_mem = self._tmpl_mem or [None] * self.S
        tmpl_vg = self._tmpl_vg or [None] * self.S
        for s in range(self.S):
            _, _, xlo, xhi = self.slices[s]
            if tmpl_alpha[s] is None:
                tmpl_alpha[s] = torch.zeros((1,), device=self.device)
            mem0 = None
            if carry_memory:
                mem0 = tmpl_mem[s]
                if mem0 is None:
                    n = self.y0[s].numel() + (self.ny[s] if self.template_weights else 0)
                    mem0 = zero_memory(1, n, device=self.device)
            ys, ws, loss, n_steps, als, mem, vg, aqn = _template_opt_std(
                self.lcfg, self._frames(self.q0), self.a0, self.x[:, xlo:xhi],
                self.xmask[:, xlo:xhi], self.y0[s], self.w0[s], self.data_sigma,
                self.noise2[s], nmax, tol, self.template_weights, tmpl_alpha[s], inner,
                ls_steps, mem0, tmpl_vg[s] if carry_value else None, tmpl_aqn[s])
            tmpl_aqn[s], tmpl_alpha[s] = aqn, als
            self._tmpl_alpha_qn, self._tmpl_alpha = tmpl_aqn, tmpl_alpha
            if carry_memory:
                tmpl_mem[s] = mem
            tmpl_vg[s] = vg
            self._tmpl_mem, self._tmpl_vg = tmpl_mem, tmpl_vg
            self.y0[s] = ys.detach()
            if self.template_weights:
                self.w0[s] = ws.detach()

            self.update_state_after_template(s)
            # a dense or decim support update re-projects the momenta and drops
            # the carried template state: the next structure starts afresh
            if self._tmpl_mem is None:
                tmpl_mem = [None] * self.S
            if self._tmpl_vg is None:
                tmpl_vg = [None] * self.S
            if self.printstuff:
                print(f"Template {s} : {int(n_steps[0])} optim steps, "
                      f"loss={float(loss[0]):.4}".ljust(70)
                      + f"Total energy = {self.E if self.E is not None else 0:.8}")

    def _shoot_frames(self, use_ext):
        """The warped templates and the regloss of the current (q0, a0)."""
        q = self._frames(self.q0)
        final, _ = lddmm_mod.shoot(self.lcfg, q, self.a0, self._x0(use_ext))
        return final, q

    def update_state_after_template(self, s):
        """Dependency refresh when the template (and a dense or decim support)
        moved (PSR_standard.py:269-316)."""
        # the template is the Reg_opt dataloss target: its threaded entry is
        # stale even where the support stays (grid)
        self._reg_vg = None
        q0_prev = self.q0
        if self.support_scheme is None:
            self.q0 = self.ally0
            self.update_a0(q0_prev, rcond=1e-1)
        elif self.support_scheme == "decim":
            self.set_support_scheme("decim", self.rho)
        use_ext = self.support_scheme is not None
        with torch.no_grad():
            final, q = self._shoot_frames(use_ext)
            self.y1 = final.x if use_ext else final.q
            # regloss changes through the re-projection too; the trajectory
            # cost of the support alone
            if use_ext:
                final, _ = lddmm_mod.shoot(self.lcfg, q, self.a0)
            self.regloss = lddmm_mod.trajloss(self.lcfg, q, self.a0,
                                              final.cost).double().cpu().numpy()
        self.update_datalosses()
        self.update_E()

    def Registration(self, k=0) -> LDDMMRegistration:
        return LDDMMRegistration(cfg=self.lcfg, q0=self.q0, a0=self.a0[k])

    # ----- the alternating loop -------------------------------------------

    def run(self, n_iters: int, reg_nmax=10, reg_tol=1e-3, reg_inner=20, reg_ls=25,
            tmpl_nmax=10, tmpl_tol=1e-3):
        """``n_iters`` alternations of Reg_opt + Template_opt (reference outer
        loop PSR_standard.py:507-564), the JAX package's fused loop
        (``_run_loop_std``) as a Python loop: the line-search steps carry from
        one iteration to the next, the quasi-Newton scales and curvature
        memories start afresh each call, the structures' templates move
        together under one (q0, a0), then a dense support follows them.
        Dense, grid and custom support; decim re-decimates on the host after
        each template move, so it takes the stepwise methods.

        :return: the energies (n_iters, 2) [after Reg_opt, after
            Template_opt], the constant <fx, fx> term included (as update_E).
        """
        if n_iters <= 0:
            return np.zeros((0, 2))
        if self.support_scheme == "decim":
            raise ValueError("decim support re-decimates on the host; use "
                             "Reg_opt/Template_opt")
        dense_support = self.support_scheme is None
        use_ext = not dense_support
        const = self._const_xx()
        tmpl_alpha = self._tmpl_alpha
        if tmpl_alpha is None or any(a is None for a in tmpl_alpha):
            tmpl_alpha = [torch.zeros((1,), device=self.device)] * self.S
        reg_alpha = self._reg_alpha
        if reg_alpha is None:
            reg_alpha = torch.zeros((self.K,), device=self.device)
        energies, dmat, regl = [], None, None
        for _ in range(n_iters):
            # Reg_opt: all frames in lockstep
            dataloss = _frame_rkhs_dataloss(self.x, self.xmask, self.w0_cat, self.noise2,
                                            self.data_sigma, self.slices)
            res = lddmm_mod.optimize(
                self.lcfg, dataloss, self._frames(self.q0), self.a0, self._x0(use_ext),
                nmax=reg_nmax, tol=reg_tol, inner=reg_inner, max_linesearch_steps=reg_ls,
                alpha0=reg_alpha)
            self.a0, reg_alpha = res.p0, res.alpha
            e_reg = res.trajl.sum() + res.datal.sum()

            # Template_opt: every structure under the same (q0, a0)
            q = self._frames(self.q0)
            new_y0, new_w0, new_alpha = [], [], []
            for s, (_, _, xlo, xhi) in enumerate(self.slices):
                ys, ws, _, _, als, _, _, _ = _template_opt_std(
                    self.lcfg, q, self.a0, self.x[:, xlo:xhi], self.xmask[:, xlo:xhi],
                    self.y0[s], self.w0[s], self.data_sigma, self.noise2[s], tmpl_nmax,
                    tmpl_tol, self.template_weights, tmpl_alpha[s])
                new_y0.append(ys.detach())
                new_w0.append(None if ws is None else ws.detach())
                new_alpha.append(als)
            self.y0, self.w0, tmpl_alpha = new_y0, new_w0, new_alpha

            with torch.no_grad():
                # the support follows the template (dense support)
                if dense_support:
                    q0_prev, self.q0 = self.q0, self.ally0
                    q = self._frames(self.q0)
                    v_new = lddmm_mod.v(self.lcfg, q, self._frames(q0_prev), self.a0)
                    self.a0 = lddmm_mod.v2p(self.lcfg, q, v_new, rcond=1e-1)
                # the state and the energy after the template move
                final, _ = lddmm_mod.shoot(self.lcfg, q, self.a0, self._x0(use_ext))
                self.y1 = final.x if use_ext else final.q
                regl = lddmm_mod.trajloss(self.lcfg, q, self.a0, final.cost)
                dmat = self._datalosses_ydep(self.y1, self.w0_cat)
            energies.append(torch.stack([e_reg, regl.sum() + dmat.sum()]))
        self._reg_alpha = reg_alpha
        self._tmpl_alpha = tmpl_alpha
        # the objectives moved: threaded entries are stale, and a dense
        # support's curvature pairs refer to another momentum space
        self._reg_vg = self._tmpl_vg = None
        if dense_support:
            self._reg_memory = self._tmpl_mem = None
        self.regloss = regl.double().cpu().numpy()
        self.dataloss = dmat.double().cpu().numpy() + const

        # energy bookkeeping and the monotonicity oracle over every phase
        es = torch.stack(energies).double().cpu().numpy() + const.sum()
        for e in es.reshape(-1):
            self._count_increase(e)
        if self.printstuff:
            print(f"run({n_iters} std iterations)".ljust(70) + f"Total energy = {self.E:.8}")
        return es


class AffinePSRStd(MultiPSRStd):
    """The standard algorithm with affine registrations, fitted iteratively
    (no closed form for the RKHS loss; reference AffinePSR_std,
    PSR_standard.py:573-686): general affine over (M, t), rigid over (A, t)
    with M = exp((A - A^T) / 2), similarity over (A, t, s) with M = s exp(...)
    (``torch.linalg.matrix_exp``), the frames on L-BFGS lanes."""

    def __init__(self, x, y_template, noise_std, acfg: affine_mod.AffineConfig,
                 data_sigma, template_weights: bool = False, device=None):
        super().__init__(x, y_template, noise_std, data_sigma, template_weights, device)
        self.acfg = acfg
        self.M = torch.eye(self.D, device=self.device).expand(self.K, self.D, self.D)
        # start translation: match the centres of mass (PSR_standard.py:623)
        xm = (self.x * self.xmask[..., None]).sum(1) / self.xmask.sum(1)[:, None]
        self.t = xm - self.ally0.mean(0)[None, :]
        self._reg_alpha = self._tmpl_alpha = None
        self._apply_current()
        self.update_datalosses()
        self.update_E()

    def _apply_current(self):
        self.y1 = affine_mod.apply(self.M, self.t, self.ally0)

    def _mat_of(self, p):
        """M of a lane's parameters: the matrix, or the exponential of A's
        skew part (times s)."""
        d = self.D
        a = p[:, :d * d].reshape(-1, d, d)
        if self.acfg.version == "general_affine":
            return a
        r = torch.linalg.matrix_exp((a - a.transpose(-1, -2)) / 2)
        if self.acfg.version == "similarity":
            r = p[:, -1, None, None] * r
        return r

    def Reg_opt(self, nmax=10, tol=1e-5):
        version = self.acfg.version
        if version not in ("general_affine", "rigid", "similarity"):
            raise NotImplementedError(version)
        d, k = self.D, self.K
        if version == "general_affine":
            p0 = torch.cat([self.M.reshape(k, d * d), self.t], 1)
        else:
            # rigid and similarity restart A at 0 (and s at 1) each call
            parts = [torch.zeros((k, d * d), device=self.device), self.t]
            if version == "similarity":
                parts.append(torch.ones((k, 1), device=self.device))
            p0 = torch.cat(parts, 1)
        dataloss = _frame_rkhs_dataloss(self.x, self.xmask, self.w0_cat, self.noise2,
                                        self.data_sigma, self.slices)
        ally0 = self.ally0

        def lossfn(p):
            return dataloss(affine_mod.apply(self._mat_of(p), p[:, d * d:d * d + d], ally0))

        alpha0 = self._reg_alpha
        if alpha0 is None:
            alpha0 = torch.zeros((k,), device=self.device)
        res = lbfgs_optimize(lossfn, p0, nmax=nmax, tol=tol, alpha0=alpha0)
        self._reg_alpha = res.alpha
        with torch.no_grad():
            self.M = self._mat_of(res.params)
        self.t = res.params[:, d * d:d * d + d]
        self._apply_current()
        self.update_datalosses()
        self.update_E(message=f"Affine Reg_opt ({self.K} frames) : "
                              f"loss={float(res.loss.sum()):.4}")

    def Template_opt(self, nmax=10, tol=1e-3):
        """L-BFGS over each structure's template (and weights) under the
        frozen affine maps."""
        tmpl_alpha = self._tmpl_alpha or [None] * self.S
        for s in range(self.S):
            _, _, xlo, xhi = self.slices[s]
            x_s, xm_s, noise2 = self.x[:, xlo:xhi], self.xmask[:, xlo:xhi], self.noise2[s]
            if tmpl_alpha[s] is None:
                tmpl_alpha[s] = torch.zeros((1,), device=self.device)

            def lossfn(ys, ws):
                pts = affine_mod.apply(self.M, self.t, ys)
                return data_distance(x_s, pts, self.data_sigma, w=ws, mask_x=xm_s,
                                     skip_xx=True).sum() / noise2

            ys, ws, _, _, als, _, _, _ = _lane_opt(lossfn, self.y0[s], self.w0[s],
                                                   self.template_weights, nmax, tol,
                                                   tmpl_alpha[s])
            tmpl_alpha[s] = als
            self.y0[s] = ys.detach()
            if self.template_weights:
                self.w0[s] = ws.detach()
        self._tmpl_alpha = tmpl_alpha
        self._apply_current()
        self.update_datalosses()
        self.update_E()

    def Registration(self, k=0) -> AffineRegistration:
        return AffineRegistration(cfg=self.acfg, m=self.M[k], t=self.t[k])
