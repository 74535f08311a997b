"""Ring-rotated pairwise reductions for a point set sharded over processes
(counterpart of ``difficp_tpu/parallel/ring.py``).

Each rank holds a contiguous block of the points.  The column shards rotate
around the ring: at every step a rank folds the shard it holds into its own
rows with the cross ops of ``ops/rhs_cross.py``, then sends that shard to
rank + 1 and receives the one of rank - 1.  After W steps (W ranks) every row
has met every column, with O(M / W) points per rank and only neighbour
traffic.  Every function is differentiable: the rotation ``ring_shift``
transposes to the reverse rotation (as JAX's ppermute does), and ``psum``'s
backward is the identity, so a rank that backpropagates the replicated sum
L = sum_r l_r gets dL/d(its shard).

The functions take this rank's shards and a process ``group``
(``parallel/launch.py``); ``group=None`` is a world of one.  Each rotation is
a Python loop over the world size; its body runs the cross Functions on every
device (the JAX package's ``_use_pallas_ring`` choice of a TPU or a blockwise
body is a TPU artifact), and there is no ``tile`` / ``ring_tile``: those size
JAX's blockwise scans, which the port does not have.

``ring_rhs_self`` / ``ring_rhs_ext`` match ``ops.backend.lddmm_rhs_self`` /
``lddmm_rhs_ext`` for any eta; masks handle padding as everywhere.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from difficp_torch.ops.rhs_cross import hamiltonian_cross, rhs_cross, rhs_xcross
from difficp_torch.ops.rhs_self import row_order
from difficp_torch.parallel.launch import all_reduce, rank_of, world


def _shift(tensors, group, step):
    """Each tensor sent to rank + step and replaced by the one of rank - step,
    all in one batch of point-to-point operations."""
    w, r = world(group), rank_of(group)
    dst = dist.get_global_rank(group, (r + step) % w)
    src = dist.get_global_rank(group, (r - step) % w)
    outs, ops = [], []
    for t in tensors:
        t = t.contiguous()
        out = torch.empty_like(t)
        ops += [dist.P2POp(dist.isend, t, dst, group), dist.P2POp(dist.irecv, out, src, group)]
        outs.append(out)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class RingShift(torch.autograd.Function):
    """One rotation: forward, every tensor to rank + 1; backward, the
    cotangents to rank - 1 (the transpose of the rotation)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        outs = _shift(tensors, group, 1)
        ctx.mark_non_differentiable(*(o for o, n in zip(outs, ctx.needs_input_grad[1:])
                                      if not n))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[1:]
        back = iter(_shift([g for g, n in zip(grads, need) if n], ctx.group, -1))
        return (None, *(next(back) if n else None for n in need))


def ring_shift(tensors, group):
    """The tensors of rank - 1 (each rank's to rank + 1); the identity, with
    no communication, in a world of one."""
    if world(group) == 1:
        return tuple(tensors)
    return RingShift.apply(group, *tensors)


class PSum(torch.autograd.Function):
    """Sum over the group; backward the identity (each rank's loss share is
    its own local term of the replicated sum)."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(t, group):
    return t if group is None else PSum.apply(t, group)


def _rotate(body, carry, rotating, group):
    """Apply ``body(carry, rot)`` to each of the W shards in turn, rotating
    ``rotating`` one step after every application but the last."""
    w = world(group)
    for step in range(w):
        carry = body(carry, rotating)
        if step < w - 1:
            rotating = ring_shift(rotating, group)
    return carry


def ring_rhs_self(q, p, mask, sigma, withlogdet, group=None, eta=0.0, order=None):
    """Fused self RHS over a point-sharded set: q / p / mask are this rank's
    shard, its rows in ``order`` at eta = 0 (``rhs_self.row_order``);
    returns its (vq, -Gq) rows and the global dcost."""
    def body(carry, rot):
        dvq, dmgq, ddc = rhs_cross(q, p, mask, *rot, sigma, withlogdet, eta, order)
        return (dvq, dmgq, ddc) if carry is None else tuple(
            a + b for a, b in zip(carry, (dvq, dmgq, ddc)))

    vq, mgq, dc = _rotate(body, None, (q, p, mask), group)
    return vq, mgq, psum(dc, group)


def ring_rhs_ext(q, p, x, mask_q, mask_x, sigma, withlogdet, group=None, eta=0.0,
                 order=None):
    """Fused self + external RHS with BOTH sets point-sharded: the (q, p)
    support shards rotate; each rank folds them into its q rows (self terms,
    logdet off; in ``order`` at eta = 0) and its x rows (advection and the
    logdet cost).  Returns its (vq, -Gq) rows, the global dcost and its vx
    rows."""
    def body(carry, rot):
        dvq, dmgq, _ = rhs_cross(q, p, mask_q, *rot, sigma, False, eta, order)
        dvx, ddc = rhs_xcross(x, mask_x, *rot, sigma, withlogdet, eta)
        new = (dvq, dmgq, dvx, ddc)
        return new if carry is None else tuple(a + b for a, b in zip(carry, new))

    vq, mgq, vx, dc = _rotate(body, None, (q, p, mask_q), group)
    return vq, mgq, psum(dc, group), vx


def ring_hamiltonian(q, p, mask, sigma, eta, group=None):
    """Global H(q, p) of a point-sharded set, with the gradcomponent terms
    (LDDMM.py:142-159)."""
    def body(h, rot):
        hs = hamiltonian_cross(q, p, mask, *rot, sigma, eta)
        return hs if h is None else h + hs

    return psum(_rotate(body, None, (q, p, mask), group), group)


def make_local_shoot(sigma: float, eta: float, withlogdet: bool, nt: int,
                     group=None, scheme: str = "Euler"):
    """Geodesic shoot on this rank's shards, Euler or Ralston steps whose RHS
    is the ring reduction: ``(q, p, mask[, x, xmask]) -> (q1, p1, cost[,
    x1])``, differentiable through autograd; cost is global.  At eta = 0 the
    rows' order of the shard's q at the start holds for every step."""
    if scheme not in ("Euler", "Ralston"):
        raise ValueError(f"Unknown integration scheme: {scheme}")

    def local_shoot(q, p, mask, x=None, xmask=None):
        dt = 1.0 / nt
        ext = x is not None
        order = row_order(q, mask, sigma) if eta == 0.0 else None

        def rhs(q, p, x):
            if ext:
                return ring_rhs_ext(q, p, x, mask, xmask, sigma, withlogdet, group, eta,
                                    order)
            vq, mgq, dc = ring_rhs_self(q, p, mask, sigma, withlogdet, group, eta, order)
            return vq, mgq, dc, None

        cost = torch.zeros((), dtype=q.dtype, device=q.device)
        for _ in range(nt):
            vq, mgq, dc, vx = rhs(q, p, x)
            if scheme == "Euler":
                x = x + dt * vx if ext else None
                q, p, cost = q + dt * vq, p + dt * mgq, cost + dt * dc
                continue
            qi, pi = q + (2 * dt / 3) * vq, p + (2 * dt / 3) * mgq
            xi = x + (2 * dt / 3) * vx if ext else None
            vqi, mgqi, dci, vxi = rhs(qi, pi, xi)
            x = x + 0.25 * dt * (vx + 3 * vxi) if ext else None
            q = q + 0.25 * dt * (vq + 3 * vqi)
            p = p + 0.25 * dt * (mgq + 3 * mgqi)
            cost = cost + 0.25 * dt * (dc + 3 * dci)
        if ext:
            return q, p, cost, x
        return q, p, cost

    return local_shoot


def make_ring_shoot(sigma: float, lambd: float, withlogdet: bool, nt: int,
                    group=None, scheme: str = "Euler", eta: float = 0.0):
    """Point-sharded geodesic shoot: ``(q0, p0, mask) -> (q1, p1, divcost)``
    on this rank's shards (``lambd`` is unused, as in the JAX package)."""
    return make_local_shoot(sigma, eta, withlogdet, nt, group, scheme)
