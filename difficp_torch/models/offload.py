"""Host-offload atlas: frame sets larger than device memory (counterpart of
``difficp_tpu/models/offload.py``).

The reference's compspec / dataspec split (PSR.py:46-63: store on the CPU,
compute on the GPU) at ``MultiPSR`` generality: S structures a frame, each
with its own GMM (PSR.py:104-112), and every support scheme of ``DiffPSR``
(dense, grid, decim, custom; PSR.py:430-493).  The per-frame arrays (x0, x1,
y, the weights, masks, the support q0 and the momenta a0) live in host
memory as CPU tensors, pinned when the device is a CUDA card; every phase
streams chunks of ``chunk_frames`` frames through the device, so the device
holds one chunk whatever the number of frames.  Both phases decompose over
frames:

- **EM** (a structure at a time): the M step is a sum of per-point
  sufficient statistics (``gmm.MStats``), summed chunk by chunk with the
  old parameters and applied once; a second streamed pass emits the targets
  y, the inlier weights gammaT and the energy terms with the new parameters
  (the two-pass discipline of ``gmm._em_step_tiled`` with host memory as
  the outer tier; inside a chunk above the dense pair limit the E steps
  stream point tiles as ``gmm.em_step`` does).
- **Registration**: each chunk runs the lockstep L-BFGS of
  ``psr._reg_opt_lddmm`` (no coverage pass), and only the momenta, the
  warped points and the step sizes come back.

Each chunk goes to the device once a pass; ``bytes_h2d`` / ``bytes_d2h``
count what crosses.  The frame axis is padded to a multiple of the chunk
with copies of frame 0 whose mask is 0.  The free energy follows
``MultiPSR.update_FE``'s bookkeeping, its terms summed as Python floats.
"""

from __future__ import annotations

import numpy as np
import torch

from difficp_torch.models import gmm as gmm_mod
from difficp_torch.models import lddmm as lddmm_mod
from difficp_torch.models.psr import _reg_opt_lddmm, _v2p_all, _v_all
from difficp_torch.ops import backend
from difficp_torch.utils.io import pad_frames, pad_structures
from difficp_torch.utils.point_sets import decimate_sets, grid_support
from difficp_torch.utils.spec import as_tensor, resolve_device

def _point_tiles(n, c):
    """The point ranges of one chunk's E steps: all at once at or under the
    dense pair limit (n c pairs), else tiles of ``gmm.EM_TILE`` points, as
    ``gmm.em_step`` streams them."""
    if backend._route("em_step", n, c) == "dense":
        return [(0, n)]
    tile = gmm_mod.EM_TILE
    return [(lo, min(lo + tile, n)) for lo in range(0, n, tile)]


def _stats_chunk(state, x, mask, cfg):
    """MStats of one flattened chunk (old parameters)."""
    stats = None
    for lo, hi in _point_tiles(x.shape[0], state.mu.shape[0]):
        st = gmm_mod._m_stats(gmm_mod._e_step(state, x[lo:hi], cfg), x[lo:hi], mask[lo:hi])
        stats = st if stats is None else gmm_mod.MStats(*(a + b for a, b in zip(stats, st)))
    return stats


def _values_chunk(new, old, x, mask, cfg):
    """The EM values of one flattened chunk after the M step: targets y,
    local cfe and quad sums, inlier weights gammaT."""
    ys, gamts = [], []
    cfe = quad = 0.0
    for lo, hi in _point_tiles(x.shape[0], old.mu.shape[0]):
        e = gmm_mod._e_step(old, x[lo:hi], cfg)
        y, cfe_l, quad_l = gmm_mod._em_values(new, old, e, x[lo:hi], mask[lo:hi], cfg)
        ys.append(y)
        gamts.append(e.gamt)
        cfe, quad = cfe + cfe_l, quad + quad_l
    return torch.cat(ys), cfe, quad, torch.cat(gamts)


class HostOffloadAtlas:
    """Diffeomorphic atlas over host-resident frames (any number of
    structures, any support scheme): ``DiffPSR``'s alternation when K x N
    exceeds device memory.  ``device`` computes (None: the CUDA card)."""

    def __init__(self, x, gmm_states, gmm_cfgs, lddmm_cfg: lddmm_mod.LDDMMConfig,
                 chunk_frames: int = 8, device=None):
        self.device = resolve_device(device)
        structs = pad_structures(x, "cpu")
        self.S = len(structs)
        k = structs[0].k
        d = structs[0].x.shape[2]
        self.chunk = int(chunk_frames)
        kpad = -(-k // self.chunk) * self.chunk
        self.K, self.Kpad, self.D = k, kpad, d

        # each structure's slice of the concatenated frame view
        self.slices = []
        off = 0
        for pf in structs:
            self.slices.append((off, off + pf.nmax))
            off += pf.nmax
        self.Ntot = off
        self.struct_n = [np.asarray(pf.n) for pf in structs]

        x_cat = torch.cat([pf.x for pf in structs], 1)
        m_cat = torch.cat([pf.mask for pf in structs], 1)
        x0 = torch.empty((kpad, self.Ntot, d))
        x0[:k] = x_cat
        x0[k:] = x_cat[0]  # masked filler frames
        mask = torch.zeros((kpad, self.Ntot))
        mask[:k] = m_cat
        # the host tier
        self.x0 = self._host(x0)
        self.mask = self._host(mask)
        self.x1 = self._host(x0.clone())
        self.y = self._host(x0.clone())
        self.ptw = self._host(torch.ones((kpad, self.Ntot)))
        # support = all data points until set_support_scheme (PSR.py:394-397)
        self.support_scheme = None
        self.q0 = self._host(x0.clone())
        self.qmask = self._host(mask.clone())
        self.a0 = self._host(torch.zeros_like(x0))
        self._alpha = self._host(torch.zeros((kpad,)))  # per-frame warm starts

        # the small state shared by the frames stays on the device
        if isinstance(gmm_states, gmm_mod.GMMState):
            gmm_states = [gmm_states] * self.S
            gmm_cfgs = [gmm_cfgs] * self.S
        if len(gmm_states) != self.S:
            raise ValueError("need one GMM per structure")
        self.gmm = [gmm_mod.GMMState(*(as_tensor(f, self.device) for f in st))
                    for st in gmm_states]
        self.gcfg = list(gmm_cfgs)
        for s, pf in enumerate(structs):
            if self.gcfg[s].use_outliers and float(self.gmm[s].vol0) == 0.0:
                vol0 = gmm_mod.bbox_volume(pf.x.reshape(-1, d), pf.mask.reshape(-1))
                self.gmm[s] = self.gmm[s]._replace(vol0=as_tensor(vol0, self.device))
        self.lcfg = lddmm_cfg
        self.cfe = [0.0] * self.S
        self.quadloss = 0.0
        self.regloss = 0.0
        self.FE = None
        self.fe_increase_events = 0
        self.printstuff = False
        self.bytes_h2d = 0
        self.bytes_d2h = 0
        self._init_a0()

    # ------------------------------------------------------------ transfers

    def _host(self, t):
        t = t.contiguous()
        return t.pin_memory() if self.device.type == "cuda" else t

    def _up(self, t):
        """A host chunk on the device (a copy), counted."""
        t = t.contiguous()
        self.bytes_h2d += t.numel() * t.element_size()
        if self.device.type == "cpu":
            return t.clone()
        return t.to(self.device, non_blocking=True)

    def _down(self, dst, t):
        """A device result into its host slice, counted."""
        self.bytes_d2h += t.numel() * t.element_size()
        dst.copy_(t.detach().reshape(dst.shape))

    def _chunks(self):
        for c0 in range(0, self.Kpad, self.chunk):
            yield slice(c0, c0 + self.chunk)

    # -------------------------------------------------------------- support

    def _init_a0(self, rcond=1e-3):
        """Momenta of zero initial speed (PSR.py:406-413): zero at eta = 0,
        else a chunked v2p of a zero field."""
        if self.lcfg.eta == 0.0:
            self.a0.zero_()
            return
        for sl in self._chunks():
            q0 = self._up(self.q0[sl])
            a0 = _v2p_all(self.lcfg, q0, torch.zeros_like(q0), self._up(self.qmask[sl]), rcond)
            self._down(self.a0[sl], a0)

    def set_support_scheme(self, scheme="grid", rho=1.0, q0=None, rcond=1e-1):
        """Choose the LDDMM support (PSR.py:430-493) with at most one chunk of
        frames on the device: 'grid' (one grid over the bounding box of all
        host frames), 'decim' (each frame's greedy cover, its structures
        together, padded with masks) or 'custom' points; then the previous
        field projected onto the new support, chunk by chunk (PSR.py:415-425;
        zeros for zero momenta at eta = 0)."""
        r_cover = rho * self.lcfg.sigma
        q0_prev, qmask_prev, a0_prev = self.q0, self.qmask, self.a0
        if scheme == "grid":
            pts = grid_support(self.x0[:self.K].reshape(-1, self.D).numpy(), r_cover)
            q0_new = torch.as_tensor(pts).expand(self.Kpad, *pts.shape).contiguous()
            qmask_new = torch.ones((self.Kpad, pts.shape[0]))
        elif scheme == "decim":
            sets = [self.x0[kk, lo:hi][: int(self.struct_n[s][kk])].numpy()
                    for kk in range(self.K) for s, (lo, hi) in enumerate(self.slices)]
            kept = iter(decimate_sets(sets, r_cover))
            per_frame = [np.concatenate([xs[next(kept)[0]] for xs in
                                         sets[kk * self.S:(kk + 1) * self.S]], axis=0)
                         for kk in range(self.K)]
            per_frame += [per_frame[0]] * (self.Kpad - self.K)
            padded = pad_frames(per_frame, "cpu")
            q0_new, qmask_new = padded.x, padded.mask.clone()
            qmask_new[self.K:] = 0.0
        elif scheme == "custom":
            if q0 is None:
                raise ValueError("custom support needs q0")
            pts = as_tensor(q0, "cpu")
            q0_new = pts.expand(self.Kpad, *pts.shape).contiguous()
            qmask_new = torch.ones((self.Kpad, pts.shape[0]))
        else:
            raise ValueError(f"Unknown support scheme: {scheme}")
        self.support_scheme = scheme
        self.q0, self.qmask = self._host(q0_new), self._host(qmask_new)
        self.a0 = self._host(torch.zeros_like(q0_new))
        if float(a0_prev.abs().max()) > 0.0:
            for sl in self._chunks():
                q0c, qmc = self._up(self.q0[sl]), self._up(self.qmask[sl])
                v_new = _v_all(self.lcfg, q0c, self._up(q0_prev[sl]), self._up(a0_prev[sl]),
                               self._up(qmask_prev[sl]))
                self._down(self.a0[sl], _v2p_all(self.lcfg, q0c, v_new, qmc, rcond))
        self._alpha.zero_()  # a new optimization landscape: cold seeds

    # ------------------------------------------------------------------- EM

    def _em_sweep(self, skip_m=False):
        """One streamed EM iteration over all host frames, a structure at a
        time: the statistics with the old parameters, one update, then the
        targets and energy terms with the new ones."""
        d = self.D
        quad = 0.0
        for s, (lo, hi) in enumerate(self.slices):
            old, cfg = self.gmm[s], self.gcfg[s]
            if skip_m:
                new = old
            else:
                stats = None
                for sl in self._chunks():
                    xc = self._up(self.x1[sl, lo:hi].reshape(-1, d))
                    mc = self._up(self.mask[sl, lo:hi].reshape(-1))
                    st = _stats_chunk(old, xc, mc, cfg)
                    stats = st if stats is None else gmm_mod.MStats(
                        *(a + b for a, b in zip(stats, st)))
                new = gmm_mod._apply_stats(old, stats, cfg, d)
            cfe_s = 0.0
            for sl in self._chunks():
                xc = self._up(self.x1[sl, lo:hi].reshape(-1, d))
                mc = self._up(self.mask[sl, lo:hi].reshape(-1))
                y, cfe_l, quad_l, gamt = _values_chunk(new, old, xc, mc, cfg)
                self._down(self.y[sl, lo:hi], y)
                self._down(self.ptw[sl, lo:hi], gamt)
                cfe_s += float(cfe_l)
                quad += float(quad_l)
            self.gmm[s] = new
            self.cfe[s] = cfe_s
        self.quadloss = quad
        return sum(self.cfe) + quad + self.regloss

    def GMM_opt(self, max_iterations: int = 25, tol: float = 1e-3):
        """Streamed EM sweeps until the free energy changes by less than tol
        relative to the sweep before (at most ``max_iterations``)."""
        last = None
        n_done = 0
        for _ in range(max_iterations):
            fe = self._em_sweep()
            n_done += 1
            if last is not None and abs(fe - last) < tol * abs(last):
                break
            last = fe
        self._update_fe(f"GMM offload sweep x{n_done}")

    # ---------------------------------------------------------------- Reg

    def _sig2_chunk(self, nframes):
        return torch.cat([(self.gmm[s].sigma ** 2).expand(nframes, hi - lo)
                          for s, (lo, hi) in enumerate(self.slices)], 1)

    def Reg_opt(self, tol: float = 1e-3, nmax: int = 10, inner: int = 20,
                ls_steps: int = 25):
        """Lockstep L-BFGS registration, a chunk of frames at a time, each
        from its frames' warm-start step sizes (zero = the cold 1/||g0||
        seed) and fresh curvature memory; no coverage pass."""
        use_ext = self.support_scheme is not None
        regl = 0.0
        quad = 0.0
        for sl in self._chunks():
            q0, a0, x0, y = (self._up(t[sl]) for t in (self.q0, self.a0, self.x0, self.y))
            qmk, xmk, w = (self._up(t[sl]) for t in (self.qmask, self.mask, self.ptw))
            al0 = self._up(self._alpha[sl])
            out = _reg_opt_lddmm(self.lcfg, q0, a0, x0, y, self._sig2_chunk(q0.shape[0]), qmk,
                                 xmk, w, nmax, tol, use_ext, inner, ls_steps, al0, None, None,
                                 None, None, coverage_check=False)
            a0n, x1, trajl, datal, alpha = out[0], out[1], out[2], out[3], out[7]
            self._down(self.a0[sl], a0n)
            self._down(self.x1[sl], x1)
            self._down(self._alpha[sl], alpha)
            regl += float(trajl.sum())
            quad += float(datal.sum())
        self.regloss = regl
        self.quadloss = quad
        self._update_fe("Reg offload pass")

    # ----------------------------------------------------------------- run

    def _update_fe(self, message=None):
        fe = sum(self.cfe) + self.quadloss + self.regloss
        if self.FE is not None and fe > self.FE + 1e-4 * abs(self.FE):
            self.fe_increase_events += 1
            if self.printstuff:
                print("WARNING: measured increase in free energy !")
        self.FE = fe
        if self.printstuff and message:
            print(f"{message:<50s} FE = {fe:.2f}")

    def run(self, n_iters: int, max_em: int = 25, em_tol: float = 1e-3,
            reg_nmax: int = 10, reg_tol: float = 1e-3, reg_inner: int = 20,
            reg_ls: int = 25):
        """``n_iters`` alternations of GMM_opt and Reg_opt; the FE after each
        (numpy)."""
        fes = []
        for _ in range(n_iters):
            self.GMM_opt(max_iterations=max_em, tol=em_tol)
            self.Reg_opt(tol=reg_tol, nmax=reg_nmax, inner=reg_inner, ls_steps=reg_ls)
            fes.append(self.FE)
        return np.asarray(fes)
