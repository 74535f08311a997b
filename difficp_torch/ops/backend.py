"""Route selection for the pair reductions (counterpart of
``difficp_tpu/ops/backend.py``).

Three routes with one contract:

- ``dense``  -- materialize the (M, N) pair matrices (``ops/reductions.py``);
                used at or under ``DENSE_PAIR_LIMIT`` pairs per frame, with
                the JAX package's pair counts.
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

``set_backend("kernel")`` forces the kernel route at any size (the API's
``"pallas"`` maps to it).  ``set_bwd_precision("accurate")`` makes the
kernel route's self and ext RHS backward the VJP of the blockwise functions
at the saved inputs (``ops/rhs_self.py``, ``ops/rhs_ext.py``); ``"fast"``,
the default, is the backward kernels.
"""

from __future__ import annotations

import os

from difficp_torch.ops import blockwise as _block
from difficp_torch.ops import kmin2 as _kmin2
from difficp_torch.ops import ksum as _ksum
from difficp_torch.ops import reductions as _dense
from difficp_torch.ops import rhs_ext as _ext
from difficp_torch.ops import rhs_self as _kernel

# 4M pairs * ~6 (M,N)-temps * 4B ~= 100MB peak; beyond, stream.
DENSE_PAIR_LIMIT = int(os.environ.get("DIFFICP_DENSE_PAIR_LIMIT", 4_000_000))

_FORCE = {"mode": None}  # None = auto; "dense" | "kernel" | "blockwise"


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


def _use_dense(m, n):
    if _FORCE["mode"] == "dense":
        return True
    if _FORCE["mode"] in ("kernel", "blockwise"):
        return False
    return m * n <= DENSE_PAIR_LIMIT


def _use_block():
    return _FORCE["mode"] == "blockwise"


def row_order(q, sigma, mask_q=None, eta=0.0, x=None):
    """The rows' order of the eta = 0 self kernels at q (``rhs_self.row_order``)
    for the RHS at q (with external points x when given), or None where that
    RHS takes none: on the dense route, or at eta != 0.  Callers compute it
    once for every RHS, Hamiltonian and kernel-sum at the same q0 and pass it
    on (``order=``)."""
    m = q.shape[-2]
    if eta != 0.0 or _use_block() or _use_dense(m, m if x is None else m + x.shape[-2]):
        return None
    return _kernel.row_order(q, _kernel._ones_mask(q) if mask_q is None else mask_q,
                             float(sigma))


def data_order(x, q, sigma, mask_x=None, eta=0.0):
    """The data rows' order of the eta = 0 ext backward's dx kernel at x
    (``rhs_ext.data_order``) for the RHS at (q, x), or None where that
    RHS takes none.  Callers compute it once for every RHS at the same x0
    and pass it on (``xorder=``)."""
    m = q.shape[-2]
    if eta != 0.0 or _use_block() or _use_dense(m, m + x.shape[-2]):
        return None
    return _ext.data_order(x, _kernel._ones_mask(x) if mask_x is None else mask_x,
                           float(sigma))


def lddmm_rhs_self(q, p, sigma, eta, withlogdet, mask_q=None, order=None):
    """(vq, -Gq, dcost) of the self RHS."""
    m = q.shape[-2]
    if _use_dense(m, m):
        return _dense.lddmm_rhs_self(q, p, sigma, eta, withlogdet, mask_q)
    if _use_block():
        return _block.lddmm_rhs_self(q, p, sigma, eta, withlogdet, mask_q)
    return _kernel.lddmm_rhs_self(q, p, sigma, withlogdet, mask_q, eta, order)


def lddmm_rhs_ext(q, p, x, sigma, eta, withlogdet, mask_q=None, mask_x=None, order=None,
                  xorder=None):
    """(vq, -Gq, dcost, vx) of the RHS with external points x, on m (m + n_x)
    pairs per frame (JAX backend.py:122-130)."""
    m = q.shape[-2]
    if _use_dense(m, m + x.shape[-2]):
        return _dense.lddmm_rhs_ext(q, p, x, sigma, eta, withlogdet, mask_q, mask_x)
    if _use_block():
        return _block.lddmm_rhs_ext(q, p, x, sigma, eta, withlogdet, mask_q, mask_x)
    return _ext.lddmm_rhs_ext(q, p, x, sigma, withlogdet, mask_q, mask_x, eta, order,
                              xorder)


def hamiltonian(q, p, sigma, eta, mask_q=None, order=None):
    """H(q, p) (LDDMM.py:142-159)."""
    m = q.shape[-2]
    if _use_dense(m, m):
        return _dense.hamiltonian(q, p, sigma, eta, mask_q)
    if _use_block():
        return _block.hamiltonian(q, p, sigma, eta, mask_q)
    return _kernel.hamiltonian(q, p, sigma, mask_q, eta, order)


def v_field(x, q, p, sigma, eta, mask_q=None):
    """RKHS vector field at points x; above the limit the ext forward kernel
    with logdet off (the JAX package's make_v_field)."""
    if _use_dense(x.shape[-2], q.shape[-2]):
        return _dense.v_field(x, q, p, sigma, eta, mask_q)
    if _use_block():
        return _block.v_field(x, q, p, sigma, eta, mask_q)
    return _ext.v_field(x, q, p, sigma, mask_q, eta)


def grad_kred(x, y, sigma, mask_y=None):
    """sum_j (grad K)(x_i - y_j) m_j (reference kernel.py:142); above the
    limit the generic kernel-sum with its VJP (the JAX package's
    grad_kred_mm)."""
    if _use_dense(x.shape[-2], y.shape[-2]):
        return _dense.grad_kred(x, y, sigma, mask_y)
    if _use_block():
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
    if _use_dense(x.shape[-2], y.shape[-2]):
        return _dense.kred(x, y, b, sigma, mask_y)
    if _use_block():
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
    if _use_dense(x.shape[-2], y.shape[-2]):
        return _dense.kred_scal(x, y, d, sigma, mask_y)
    if _use_block():
        return _block.kred_scal(x, y, d, sigma, mask_y)
    return _ksum.kred_scal(x, y, d, sigma, mask_y)


def mdivsum(x, q, p, sigma, eta, mask_q=None, mask_x=None):
    """sum_i -div(v)(x_i) at data points x, per frame (LDDMM.py:120-138); the
    shoot gets it fused in lddmm_rhs_* instead.  Above the limit the generated
    kernel-sum over the ext logdet density, value and gradients (the JAX
    package's make_mdivsum)."""
    if _use_dense(q.shape[-2], x.shape[-2]):
        return _dense.mdivsum(x, q, p, sigma, eta, mask_q, mask_x)
    if _use_block():
        return _block.mdivsum(x, q, p, sigma, eta, mask_q, mask_x)
    return _ksum.mdivsum(x, q, p, sigma, eta, mask_q, mask_x)


def min_sqdist(x, y, mask_y=None):
    """min_j |x_i - y_j|^2 (reference kernel.py:324-328); kmin2 above the
    limit."""
    if _use_dense(x.shape[-2], y.shape[-2]):
        return _dense.min_sqdist(x, y, mask_y)
    if _use_block():
        return _block.min_sqdist(x, y, mask_y)
    if mask_y is not None:
        mask_y = mask_y.expand(y.shape[:-1]).contiguous()
    m1, _ = _kmin2.kmin2(x.contiguous(), y.contiguous(), mask_y)
    return m1


def second_min_sqdist(x, mask=None):
    """Nearest-neighbour (excluding self) squared distance, Kmin(2); kmin2
    with self-exclusion above the limit (its first minimum)."""
    if _use_dense(x.shape[-2], x.shape[-2]):
        return _dense.second_min_sqdist(x, mask)
    if _use_block():
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
