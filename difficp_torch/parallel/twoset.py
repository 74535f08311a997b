"""Point-sharded two-set registration over a process group (counterpart of
``difficp_tpu/parallel/twoset.py``).

One point set too large for one card is registered onto a GMM with the full
diffICP alternation, each rank holding a contiguous block of the points:

- **EM**: ``gmm.em_step(..., group=group)`` sums the M-step statistics and
  the free-energy terms over the group, so every rank applies the same
  update;
- **registration**: the loss is the ring-rotated shoot and Hamiltonian of
  ``parallel/ring.py`` plus the gammaT-weighted quadratic dataloss, summed
  over the group; each rank holds its momenta shard, gradients flow back
  through the ring, and ``lbfgs_optimize(..., group=group)`` reduces every
  scalar that steers it over the group.

Everything is eager Python over this rank's shard; dense support (the
support is the points), one frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from difficp_torch.models import gmm as gmm_mod
from difficp_torch.models import lddmm as lddmm_mod
from difficp_torch.parallel import ring
from difficp_torch.parallel.launch import all_reduce, rank_of, world
from difficp_torch.utils.lbfgs import LBFGSMemory, lbfgs_optimize, zero_memory
from difficp_torch.utils.spec import as_tensor, resolve_device


def make_sharded_reg_loss(lcfg: lddmm_mod.LDDMMConfig, group=None, with_aux: bool = False):
    """The sharded registration loss ``loss(a0, q0, y, w, mask, sig2)`` on this
    rank's shards (a0, q0, y (M_r, D); w, mask (M_r,)):

        lambd * H(q0, a0) + divcost + sum_i m_i w_i |q1_i - y_i|^2 / (2 sig2)

    summed over the group: ``lddmm.trajloss`` plus the quadratic dataloss of
    ``models/psr.py``.  ``with_aux``: ``(loss, (q1, trajl, quad))``, the
    arrival shard and the loss terms of this evaluation."""
    local_shoot = ring.make_local_shoot(lcfg.sigma, lcfg.eta, lcfg.withlogdet, lcfg.nt,
                                        group, lcfg.scheme)

    def loss(a0, q0, y, w, mask, sig2):
        q1, _, cost = local_shoot(q0, a0, mask)
        h = ring.ring_hamiltonian(q0, a0, mask, lcfg.sigma, lcfg.eta, group)
        quad = ring.psum(((mask * w)[:, None] * (q1 - y) ** 2).sum(), group) / (2.0 * sig2)
        trajl = lcfg.lambd * h + cost
        if with_aux:
            return trajl + quad, (q1, trajl, quad)
        return trajl + quad

    return loss


class TwosetStepOut(NamedTuple):
    gmm: gmm_mod.GMMState
    a0: torch.Tensor     # (M_r, D) momenta, this rank's shard
    x1: torch.Tensor     # (M_r, D) warped points, this rank's shard
    y: torch.Tensor      # (M_r, D) EM quadratic targets, this rank's shard
    cfe: torch.Tensor    # ()  free-energy offset
    fe: torch.Tensor     # ()  free energy (the monotone oracle quantity)
    trajl: torch.Tensor  # ()  lambd * H + divcost
    quad: torch.Tensor   # ()  weighted quadratic dataloss
    alpha: torch.Tensor  # ()  accepted line-search step: the next alpha0
    memory: Optional[LBFGSMemory] = None  # with carry_memory: the next mem0


def make_twoset_step(gcfg: gmm_mod.GMMConfig, lcfg: lddmm_mod.LDDMMConfig, group=None,
                     em_iters: int = 5, reg_nmax: int = 1, reg_inner: int = 20,
                     reg_ls: int = 25, tol: float = 1e-3, em_tile: Optional[int] = None,
                     carry_memory: bool = False, memory_size: int = 10):
    """One outer iteration over the group: ``em_iters`` EM steps on the warped
    points, then one L-BFGS registration pass on the sharded momenta (the
    reference outer loop, ICP_two_set.py / PSR.py GMM_opt + Reg_opt).

    Returns ``step(gstate, q0, a0, x1, mask, alpha0=0.0[, mem0])``.
    ``alpha0 <= 0`` seeds the first line search with min(1, 1/||g0||) from one
    extra loss+grad; pass ``out.alpha`` back to skip it.  With
    ``carry_memory`` the step takes ``mem0`` (``zero_twoset_memory`` for step
    0) and returns the shard's final curvature memory.  The arrival points
    and loss terms come from the optimizer's best evaluation: no re-shoot."""
    reg_loss = make_sharded_reg_loss(lcfg, group, with_aux=True)

    def step(gstate, q0, a0, x1, mask, alpha0=0.0, mem0=None) -> TwosetStepOut:
        for _ in range(em_iters):
            gstate = gmm_mod.em_step(gstate, x1, mask, gcfg, tile=em_tile, group=group).state
        out = gmm_mod.em_step(gstate, x1, mask, gcfg, skip_m=True, tile=em_tile, group=group)
        y, cfe, ptw = out.y, out.cfe, out.gamt
        sig2 = gstate.sigma ** 2

        def lossfn(p):  # one lane: p (1, M_r, D)
            loss, (q1, trajl, quad) = reg_loss(p[0], q0, y, ptw, mask, sig2)
            return loss[None], (q1[None], trajl[None], quad[None])

        alpha0 = float(alpha0)
        if not alpha0 > 0.0:
            p = a0.detach().clone().requires_grad_(True)
            with torch.enable_grad():
                (g0,) = torch.autograd.grad(reg_loss(p, q0, y, ptw, mask, sig2)[0], p)
            gn = float(torch.sqrt(all_reduce((g0 * g0).sum(), group)))
            alpha0 = min(1.0, 1.0 / max(gn, 1e-12))
        res = lbfgs_optimize(lossfn, a0[None], nmax=reg_nmax, inner=reg_inner, tol=tol,
                             max_linesearch_steps=reg_ls, alpha0=alpha0, has_aux=True,
                             memory0=mem0, memory_size=memory_size, group=group)
        q1, trajl, quad = (t[0] for t in res.aux)
        return TwosetStepOut(gmm=gstate, a0=res.params[0], x1=q1, y=y, cfe=cfe,
                             fe=cfe + trajl + quad, trajl=trajl, quad=quad,
                             alpha=res.alpha[0], memory=res.memory if carry_memory else None)

    return step


def zero_twoset_memory(a0, memory_size: int = 10) -> LBFGSMemory:
    """Empty curvature memory of this rank's momenta shard (the ``mem0`` of
    step 0 with ``carry_memory``)."""
    return zero_memory(1, a0.numel(), memory_size, a0.dtype, a0.device)


def rank_block(a, rank: int, world_size: int):
    """Block ``rank`` of ``world_size`` of a point array along its leading
    axis, as the JAX package's ``P(axis)`` cuts it; the point count must
    divide by the world size."""
    n = a.shape[0]
    if n % world_size:
        raise ValueError(f"{n} points do not divide over {world_size} ranks")
    blk = n // world_size
    return a[rank * blk:(rank + 1) * blk]


def shard_twoset(group, *arrays, device=None):
    """This rank's block of each point array (numpy or tensors), as float32
    tensors on ``device`` (None: the CUDA card)."""
    dev = resolve_device(device)
    return tuple(as_tensor(rank_block(a, rank_of(group), world(group)), dev).contiguous()
                 for a in arrays)
