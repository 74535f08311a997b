"""Route selection for the pair reductions (counterpart of
``difficp_tpu/ops/backend.py``).

Two routes with one contract:

- ``dense``  -- materialize the (M, N) pair matrices (``ops/reductions.py``);
                used at or under ``DENSE_PAIR_LIMIT`` pairs per frame, as in
                the JAX package.
- ``kernel`` -- the fused self-RHS and Hamiltonian as autograd Functions over
                the hand-written CUDA kernels (``ops/rhs_self.py``); used above
                the limit for eta = 0.  On a CPU tensor the Function takes the
                kernel's plain PyTorch version, which stands in for the JAX
                package's ``blockwise`` route until that module is ported.

``set_backend("kernel")`` forces the kernel route at any size (the API's
``"pallas"`` maps to it).  Routes that are not ported yet raise
``NotImplementedError`` and name the slice that brings them.
"""

from __future__ import annotations

import os

from difficp_torch.ops import reductions as _dense
from difficp_torch.ops import rhs_self as _kernel

# 4M pairs * ~6 (M,N)-temps * 4B ~= 100MB peak; beyond, stream.
DENSE_PAIR_LIMIT = int(os.environ.get("DIFFICP_DENSE_PAIR_LIMIT", 4_000_000))

_FORCE = {"mode": None}  # None = auto; "dense" | "kernel"

_NEXT_SLICE = ("not ported yet: it comes with the grid-support slice "
               "(external-point kernels and kmin2)")


def set_backend(mode):
    """Force a route globally (None = size-based auto), the reference's
    set_computversion (kernel.py:91-110)."""
    if mode == "blockwise":
        raise NotImplementedError(
            "the blockwise route is not ported yet; the kernel route's plain "
            "version stands in for it on the CPU")
    if mode not in (None, "dense", "kernel"):
        raise ValueError(f"unknown backend {mode!r}")
    _FORCE["mode"] = mode


def _use_dense(m, n):
    if _FORCE["mode"] == "dense":
        return True
    if _FORCE["mode"] == "kernel":
        return False
    return m * n <= DENSE_PAIR_LIMIT


def lddmm_rhs_self(q, p, sigma, eta, withlogdet, mask_q=None):
    """(vq, -Gq, dcost) of the self RHS, dense or kernel route."""
    m = q.shape[-2]
    if _use_dense(m, m):
        return _dense.lddmm_rhs_self(q, p, sigma, eta, withlogdet, mask_q)
    if eta != 0.0:
        raise NotImplementedError(
            "eta != 0 above the dense pair limit is not ported yet: it comes "
            "with the eta != 0 slice")
    return _kernel.lddmm_rhs_self(q, p, sigma, withlogdet, mask_q)


def hamiltonian(q, p, sigma, eta, mask_q=None):
    """H(q, p) (LDDMM.py:142-159), dense or kernel route."""
    m = q.shape[-2]
    if _use_dense(m, m):
        return _dense.hamiltonian(q, p, sigma, eta, mask_q)
    if eta != 0.0:
        raise NotImplementedError(
            "eta != 0 above the dense pair limit is not ported yet: it comes "
            "with the eta != 0 slice")
    return _kernel.hamiltonian(q, p, sigma, mask_q)


def min_sqdist(x, y, mask_y=None):
    """min_j |x_i - y_j|^2 (reference kernel.py:324-328)."""
    if _use_dense(x.shape[-2], y.shape[-2]):
        return _dense.min_sqdist(x, y, mask_y)
    raise NotImplementedError(f"min_sqdist above the dense pair limit is {_NEXT_SLICE}")


def second_min_sqdist(x, mask=None):
    """Nearest-neighbour (excluding self) squared distance, Kmin(2)."""
    if _use_dense(x.shape[-2], x.shape[-2]):
        return _dense.second_min_sqdist(x, mask)
    raise NotImplementedError(
        f"second_min_sqdist above the dense pair limit is {_NEXT_SLICE}")
