"""Route selection for the pair reductions (counterpart of
``difficp_tpu/ops/backend.py``).

Three routes with one contract:

- ``dense``  -- materialize the (M, N) pair matrices (``ops/reductions.py``);
                used at or under ``DENSE_PAIR_LIMIT`` pairs a call: the JAX
                package's pair count of one frame times the call's frames
                (``_pairs``).
- ``kernel`` -- autograd Functions and ops over the hand-written CUDA
                kernels: the fused self RHS and Hamiltonian
                (``ops/rhs_self.py``), the external-point RHS and v_field
                (``ops/rhs_ext.py``), the top-2 minimum (``ops/kmin2.py``),
                the kernel-sums between two sets with their VJPs (kred,
                kred_scal, grad_kred, mdivsum: ``ops/ksum.py``) and, for the
                gradcomponent model (eta != 0), the generated kernel-sums
                (``ops/pair_poly.py``); used above the limit, at any eta.  On a CPU tensor they take the
                kernels' plain PyTorch versions, which stand in for the JAX
                package's ``blockwise`` route in the auto route, which keeps
                the same dispatch on the CPU as on the card.
- ``blockwise`` -- the tiled plain PyTorch functions of ``ops/blockwise.py``,
                O(M + N) memory with checkpointed tile bodies; taken only
                when forced (``set_backend("blockwise")``, the API's
                ``"blockwise"`` / ``"keops"``), at every size, as the JAX
                package takes it when forced.  On that route ``row_order``
                and ``data_order`` are None.

The dense route materializes its pair tensors for every frame (and, in the
coverage pass, every saved state) of a call at once, so the limit counts the
pairs of the whole call: the JAX package counts one frame's, and a call of
40 frames at 2.36M pairs each (the grid atlas at sigma_LDDMM 0.2) would
materialize 94M pairs a tensor there.  A call of one frame routes as the
JAX package routes it.  ``routes[(function, route)]`` counts each
function's calls by route.

``set_backend("kernel")`` forces the kernel route at any size (the API's
``"pallas"`` maps to it).  ``set_bwd_precision("accurate")`` makes the
kernel route's self and ext RHS backward the VJP of the blockwise functions
at the saved inputs (``ops/rhs_self.py``, ``ops/rhs_ext.py``); ``"fast"``,
the default, is the backward kernels.
"""

from __future__ import annotations

import math
import os
from collections import Counter

from difficp_torch.ops import blockwise as _block
from difficp_torch.ops import kmin2 as _kmin2
from difficp_torch.ops import ksum as _ksum
from difficp_torch.ops import reductions as _dense
from difficp_torch.ops import rhs_ext as _ext
from difficp_torch.ops import rhs_self as _kernel

# 4M pairs a call * ~6 (M,N)-temps * 4B ~= 100MB peak; beyond, stream.
DENSE_PAIR_LIMIT = int(os.environ.get("DIFFICP_DENSE_PAIR_LIMIT", 4_000_000))

_FORCE = {"mode": None}  # None = auto; "dense" | "kernel" | "blockwise"

# calls of each function by route since the last reset (reset by clear()):
# (function, "dense" | "kernel" | "blockwise") -> calls
routes = Counter()


def set_backend(mode):
    """Force a route globally (None = size-based auto), the reference's
    set_computversion (kernel.py:91-110)."""
    if mode not in (None, "dense", "kernel", "blockwise"):
        raise ValueError(f"unknown backend {mode!r}")
    _FORCE["mode"] = mode


def set_bwd_precision(mode):
    """The kernel route's RHS backward: "fast" (the backward kernels) or
    "accurate" (the VJP of the blockwise functions at the saved inputs, for
    the self and ext RHS at any eta; their forwards stay the kernels, and
    the eta != 0 self and ext forwards stay off the generated route).  Read
    at each call, as ``set_backend`` is."""
    if mode not in ("fast", "accurate"):
        raise ValueError(f"unknown backward precision {mode!r}")
    _kernel._BWD_PRECISION["mode"] = mode


def _pairs(m, n, *sets):
    """The pairs a call at m x n pairs a frame materializes on the dense
    route: the leading (frame or state) dimensions of the point sets
    ``sets`` times m x n.  The leading dimensions' product is the largest of
    the sets' (they share their leading dimensions, or one of them is a
    single frame that broadcasts); without sets, or with no leading
    dimension, one frame."""
    return max((math.prod(s.shape[:-2]) for s in sets), default=1) * m * n


def _route(function, m, n, *sets):
    """The route of one call of ``function`` at m x n pairs a frame on the
    point sets ``sets``: the forced route, else "dense" at or under
    ``DENSE_PAIR_LIMIT`` pairs of the whole call (``_pairs``) and "kernel"
    above; counted in ``routes``.  The EM's tiling takes "dense" as its
    untiled side (``models/gmm.py``, ``models/offload.py``)."""
    route = _FORCE["mode"]
    if route is None:
        route = "dense" if _pairs(m, n, *sets) <= DENSE_PAIR_LIMIT else "kernel"
    routes[(function, route)] += 1
    return route


def row_order(q, sigma, mask_q=None, eta=0.0, x=None):
    """The rows' order of the eta = 0 self kernels at q (``rhs_self.row_order``)
    for the RHS at q (with external points x when given), or None where that
    RHS takes none: on the dense route, or at eta != 0.  Callers compute it
    once for every RHS, Hamiltonian and kernel-sum at the same q0 and pass it
    on (``order=``)."""
    if eta != 0.0:
        return None
    m = q.shape[-2]
    n = m if x is None else m + x.shape[-2]
    if _route("row_order", m, n, q, q if x is None else x) != "kernel":
        return None
    return _kernel.row_order(q, _kernel._ones_mask(q) if mask_q is None else mask_q,
                             float(sigma))


def data_order(x, q, sigma, mask_x=None, eta=0.0):
    """The data rows' order of the eta = 0 ext backward's dx kernel at x
    (``rhs_ext.data_order``) for the RHS at (q, x), or None where that
    RHS takes none.  Callers compute it once for every RHS at the same x0
    and pass it on (``xorder=``)."""
    if eta != 0.0:
        return None
    m = q.shape[-2]
    if _route("data_order", m, m + x.shape[-2], q, x) != "kernel":
        return None
    return _ext.data_order(x, _kernel._ones_mask(x) if mask_x is None else mask_x,
                           float(sigma))


def lddmm_rhs_self(q, p, sigma, eta, withlogdet, mask_q=None, order=None):
    """(vq, -Gq, dcost) of the self RHS."""
    m = q.shape[-2]
    route = _route("lddmm_rhs_self", m, m, q)
    if route == "dense":
        return _dense.lddmm_rhs_self(q, p, sigma, eta, withlogdet, mask_q)
    if route == "blockwise":
        return _block.lddmm_rhs_self(q, p, sigma, eta, withlogdet, mask_q)
    return _kernel.lddmm_rhs_self(q, p, sigma, withlogdet, mask_q, eta, order)


def lddmm_rhs_ext(q, p, x, sigma, eta, withlogdet, mask_q=None, mask_x=None, order=None,
                  xorder=None):
    """(vq, -Gq, dcost, vx) of the RHS with external points x, on m (m + n_x)
    pairs per frame (JAX backend.py:122-130)."""
    m = q.shape[-2]
    route = _route("lddmm_rhs_ext", m, m + x.shape[-2], q, x)
    if route == "dense":
        return _dense.lddmm_rhs_ext(q, p, x, sigma, eta, withlogdet, mask_q, mask_x)
    if route == "blockwise":
        return _block.lddmm_rhs_ext(q, p, x, sigma, eta, withlogdet, mask_q, mask_x)
    return _ext.lddmm_rhs_ext(q, p, x, sigma, withlogdet, mask_q, mask_x, eta, order,
                              xorder)


def hamiltonian(q, p, sigma, eta, mask_q=None, order=None):
    """H(q, p) (LDDMM.py:142-159)."""
    m = q.shape[-2]
    route = _route("hamiltonian", m, m, q)
    if route == "dense":
        return _dense.hamiltonian(q, p, sigma, eta, mask_q)
    if route == "blockwise":
        return _block.hamiltonian(q, p, sigma, eta, mask_q)
    return _kernel.hamiltonian(q, p, sigma, mask_q, eta, order)


def v_field(x, q, p, sigma, eta, mask_q=None):
    """RKHS vector field at points x; above the limit the ext forward kernel
    with logdet off (the JAX package's make_v_field)."""
    route = _route("v_field", x.shape[-2], q.shape[-2], x, q)
    if route == "dense":
        return _dense.v_field(x, q, p, sigma, eta, mask_q)
    if route == "blockwise":
        return _block.v_field(x, q, p, sigma, eta, mask_q)
    return _ext.v_field(x, q, p, sigma, mask_q, eta)


def grad_kred(x, y, sigma, mask_y=None):
    """sum_j (grad K)(x_i - y_j) m_j (reference kernel.py:142); above the
    limit the generic kernel-sum with its VJP (the JAX package's
    grad_kred_mm)."""
    route = _route("grad_kred", x.shape[-2], y.shape[-2], x, y)
    if route == "dense":
        return _dense.grad_kred(x, y, sigma, mask_y)
    if route == "blockwise":
        return _block.grad_kred(x, y, sigma, mask_y)
    return _ksum.grad_kred(x, y, sigma, mask_y)


def kred(x, y, b, sigma, mask_y=None, order=None):
    """Kernel-sum convolution sum_j K(x_i - y_j) m_j b_j (reference
    kernel.py:138).  Above the limit the self sum kred(q, q, b) is the self
    forward kernel's v output (rows in ``order``, from ``row_order(x, sigma,
    mask_y)``), which also zeroes rows with m_i = 0 (its one caller,
    ``solvers.kridge_solve_cg``, overwrites those rows) and takes no
    gradient; between two sets it is the generic kernel-sum with its VJP (the
    JAX package's kred_mm)."""
    route = _route("kred", x.shape[-2], y.shape[-2], x, y)
    if route == "dense":
        return _dense.kred(x, y, b, sigma, mask_y)
    if route == "blockwise":
        return _block.kred(x, y, b, sigma, mask_y)
    if x is not y:
        return _ksum.kred(x, y, b, sigma, mask_y)
    m = _kernel._ones_mask(x) if mask_y is None else mask_y.contiguous()
    v, _, _ = _kernel.rhs_self_fwd(x.contiguous(), b.contiguous(), m, float(sigma),
                                   False, order=order)
    return v


def kred_scal(x, y, d, sigma, mask_y=None):
    """sum_j K(x_i - y_j) m_j d_j, scalar payload d (reference kernel.py:134);
    above the limit the generic kernel-sum with its VJP, also when x is y (the
    JAX package's kred_scal_mm): the standard algorithm's data_distance."""
    route = _route("kred_scal", x.shape[-2], y.shape[-2], x, y)
    if route == "dense":
        return _dense.kred_scal(x, y, d, sigma, mask_y)
    if route == "blockwise":
        return _block.kred_scal(x, y, d, sigma, mask_y)
    return _ksum.kred_scal(x, y, d, sigma, mask_y)


def mdivsum(x, q, p, sigma, eta, mask_q=None, mask_x=None):
    """sum_i -div(v)(x_i) at data points x, per frame (LDDMM.py:120-138); the
    shoot gets it fused in lddmm_rhs_* instead.  Above the limit the generated
    kernel-sum over the ext logdet density, value and gradients (the JAX
    package's make_mdivsum)."""
    route = _route("mdivsum", q.shape[-2], x.shape[-2], q, x)
    if route == "dense":
        return _dense.mdivsum(x, q, p, sigma, eta, mask_q, mask_x)
    if route == "blockwise":
        return _block.mdivsum(x, q, p, sigma, eta, mask_q, mask_x)
    return _ksum.mdivsum(x, q, p, sigma, eta, mask_q, mask_x)


def min_sqdist(x, y, mask_y=None):
    """min_j |x_i - y_j|^2 (reference kernel.py:324-328); kmin2 above the
    limit."""
    route = _route("min_sqdist", x.shape[-2], y.shape[-2], x, y)
    if route == "dense":
        return _dense.min_sqdist(x, y, mask_y)
    if route == "blockwise":
        return _block.min_sqdist(x, y, mask_y)
    if mask_y is not None:
        mask_y = mask_y.expand(y.shape[:-1]).contiguous()
    m1, _ = _kmin2.kmin2(x.contiguous(), y.contiguous(), mask_y)
    return m1


def second_min_sqdist(x, mask=None):
    """Nearest-neighbour (excluding self) squared distance, Kmin(2); kmin2
    with self-exclusion above the limit (its first minimum)."""
    route = _route("second_min_sqdist", x.shape[-2], x.shape[-2], x)
    if route == "dense":
        return _dense.second_min_sqdist(x, mask)
    if route == "blockwise":
        return _block.second_min_sqdist(x, mask)
    if mask is not None:
        mask = mask.expand(x.shape[:-1]).contiguous()
    m1, _ = _kmin2.kmin2(x.contiguous(), x.contiguous(), mask, exclude_self=True)
    return m1


def check_coverage(x, y, sigma, r_threshold, mask_x=None, mask_y=None):
    """True for x_i farther than r_threshold * sigma from every y_j
    (kernel.py:324-328), via the dispatched min reduction."""
    uncov = min_sqdist(x, y, mask_y) > (r_threshold * sigma) ** 2
    if mask_x is not None:
        uncov = uncov & (mask_x > 0)
    return uncov
