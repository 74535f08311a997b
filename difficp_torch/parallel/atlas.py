"""Frame-parallel atlas over a process group (counterpart of
``difficp_tpu/parallel/atlas.py``).

The K frames of an atlas are independent registrations tied together only
by the GMM, so they shard over ranks, each rank holding a contiguous block of
K / world frames:

- **the registrations**: each rank runs the lockstep L-BFGS of its own
  frames; no communication;
- **the EM over all frames**: every M-step quantity is a sum over points
  (``gmm.MStats``), so ``gmm.em_step(..., group=group)`` sums the statistics
  and the free-energy terms over the group and every rank applies the same
  update.

``make_mesh`` starts the group (``launch.init_distributed``) and gives the
rank's frame range; ``shard_psr`` keeps a PSR's frames of this rank and sets
its group (``MultiPSR.group``); ``make_atlas_train_step`` is the fused
one-iteration step (EM + one registration pass).  Everything is eager Python
over this rank's frames.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from difficp_torch.models import gmm as gmm_mod
from difficp_torch.models import lddmm as lddmm_mod
from difficp_torch.parallel.launch import all_reduce, init_distributed, rank_of, world
from difficp_torch.utils.integrators import tree_map
from difficp_torch.utils.lbfgs import LBFGSMemory, zero_memory


def frame_range(k: int, group) -> slice:
    """This rank's contiguous block of K frames, as the JAX package's
    ``P("frames")`` cuts them; K must divide by the world size."""
    n = world(group)
    if k % n:
        raise ValueError(f"{k} frames do not divide over {n} ranks")
    blk = k // n
    r = rank_of(group)
    return slice(r * blk, (r + 1) * blk)


def make_mesh(k: int, device=None, init_method=None, world_size=None, rank=None):
    """The process group (``init_distributed``: NCCL on the card, gloo on the
    CPU) and this rank's frame range of K frames: ``(group, frames)``."""
    group, _, _ = init_distributed(device, init_method, world_size, rank)
    return group, frame_range(k, group)


_FRAME_ARRAYS = ("x0", "x1", "y", "xmask", "ptw", "q0", "qmask", "a0", "regloss",
                 "quadloss", "_reg_alpha", "_reg_alpha_qn", "_reg_stall", "M", "t")


def shard_psr(psr, group):
    """Keep this rank's frames of a ``DiffPSR`` / ``AffinePSR`` (its per-frame
    arrays, padded point sets and threaded L-BFGS lanes) and set its
    ``group``: its EM and free energy then reduce over the ranks, each rank
    registering its own frames.  The support is set before sharding (a grid
    spans every frame's bounding box)."""
    frames = frame_range(psr.K, group)
    for name in _FRAME_ARRAYS:
        val = getattr(psr, name, None)
        if isinstance(val, torch.Tensor):
            setattr(psr, name, val[frames].contiguous())
    if getattr(psr, "_reg_memory", None) is not None:
        psr._reg_memory = tree_map(lambda t: t[frames].contiguous(), psr._reg_memory)
    psr._reg_vg = None
    psr.structs = [pf._replace(x=pf.x[frames].contiguous(), mask=pf.mask[frames].contiguous(),
                               n=pf.n[frames]) for pf in psr.structs]
    psr.K = psr.structs[0].k
    psr.group = group
    return psr


def em_step_frames_sharded(state, x, mask, cfg, group, skip_m: bool = False):
    """One EM step on this rank's frames (K_r, N, D): ``gmm.em_step`` on the
    flattened points with the statistics summed over the group.

    :return: (new GMMState, the same on every rank; y (K_r, N, D); Cfe; FE)
    """
    k, n, d = x.shape
    out = gmm_mod.em_step(state, x.reshape(k * n, d), mask.reshape(k * n), cfg,
                          skip_m=skip_m, group=group)
    return out.state, out.y.reshape(k, n, d), out.cfe, out.fe


class AtlasStepOut(NamedTuple):
    gmm: gmm_mod.GMMState
    a0: torch.Tensor        # (K_r, M, D) momenta of this rank's frames
    x1: torch.Tensor        # (K_r, N, D) warped points
    y: torch.Tensor         # (K_r, N, D) EM targets
    cfe: torch.Tensor       # ()  free-energy offset (the group's)
    fe: torch.Tensor        # ()  free energy (the group's)
    regloss: torch.Tensor   # (K_r,) trajectory losses
    quadloss: torch.Tensor  # (K_r,) data losses
    alpha: Optional[torch.Tensor] = None  # (K_r,) accepted steps: the next alpha0
    memory: Optional[LBFGSMemory] = None  # with carry_memory: the next mem0


def make_atlas_train_step(gcfg: gmm_mod.GMMConfig, lcfg: lddmm_mod.LDDMMConfig, group=None,
                          em_iters: int = 5, reg_nmax: int = 1, tol: float = 1e-3,
                          use_ext: bool = True, reg_inner: int = 20, reg_ls: int = 25,
                          carry_memory: bool = False, memory_size: int = 10):
    """The one-iteration atlas step over the group: ``em_iters`` EM steps on
    all frames' warped points and one values-only pass, then one lockstep
    L-BFGS registration pass over this rank's frames (the body of the
    reference's outer loop, ICP_atlas.py:269-298).  fe = Cfe + the quad and
    reg sums, each reduced over the group once.

    Returns ``step(gstate, q0, a0, x0, x1, qmask, xmask, alpha0=None)``, or
    with ``carry_memory`` ``step(gstate, q0, a0, x0, x1, qmask, xmask,
    alpha0, mem0)`` (``zero_atlas_memory`` for step 0; ``memory_size`` is
    its size).  Zero or None step sizes are the cold 1/||g0|| seeds."""

    def _train(gstate, q0, a0, x0, x1, qmask, xmask, alpha0, mem0) -> AtlasStepOut:
        for _ in range(em_iters):
            gstate = em_step_frames_sharded(gstate, x1, xmask, gcfg, group)[0]
        k, n, d = x1.shape
        out = gmm_mod.em_step(gstate, x1.reshape(k * n, d), xmask.reshape(k * n), gcfg,
                              skip_m=True, group=group)
        y, cfe, ptw = out.y.reshape(k, n, d), out.cfe, out.gamt.reshape(k, n)
        sig2 = gstate.sigma ** 2

        def dataloss(pts):
            # gammaT inlier weight, as the single-device quadloss
            return ((xmask * ptw)[..., None] * (pts - y) ** 2 / (2.0 * sig2)).sum((-2, -1))

        res = lddmm_mod.optimize(
            lcfg, dataloss, q0, a0, x0 if use_ext else None, qmask,
            xmask if use_ext else None, nmax=reg_nmax, tol=tol, inner=reg_inner,
            max_linesearch_steps=reg_ls, alpha0=alpha0,
            memory0=mem0 if carry_memory else None)
        x1_new = res.final.x if use_ext else res.final.q
        quad = all_reduce(res.datal.sum(), group)
        regl = all_reduce(res.trajl.sum(), group)
        return AtlasStepOut(
            gmm=gstate, a0=res.p0, x1=x1_new.detach(), y=y, cfe=cfe, fe=cfe + quad + regl,
            regloss=res.trajl.detach(), quadloss=res.datal.detach(), alpha=res.alpha,
            memory=res.memory if carry_memory else None)

    if carry_memory:
        return _train

    def train_step(gstate, q0, a0, x0, x1, qmask, xmask, alpha0=None) -> AtlasStepOut:
        return _train(gstate, q0, a0, x0, x1, qmask, xmask, alpha0, None)

    return train_step


def zero_atlas_memory(a0, memory_size: int = 10) -> LBFGSMemory:
    """Empty curvature memory of each of this rank's frames (the ``mem0`` of
    step 0 with ``carry_memory``)."""
    return zero_memory(a0.shape[0], a0[0].numel(), memory_size, a0.dtype, a0.device)
