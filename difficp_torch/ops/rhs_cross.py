"""Cross-set fused LDDMM right-hand side: rows against a different column set,
the body of every ring rotation (``parallel/ring.py``; counterpart of the
cross ops of ``difficp_tpu/ops/pallas_reductions.py``).

With u = 1/sigma^2, k_ij = exp(-u |qr_i - qc_j|^2 / 2), d_ij = qr_i - qc_j
and c_ij = pr_i - pc_j, the rows (qr, pr, mr) against the columns (qc, pc, mc)
give the terms of ``csrc/rhs_self.cu``'s header, one output per row: v, w
(the returned -Gq) and per-row dcost partials.  Rows are multiplied by mr;
columns enter through mc inside k.  Summed over a partition of the columns
they give the self RHS.

The forward kernels of ``csrc/rhs_self.cu`` compute it on the card with their
column set apart from their rows (``rhs_cross_fwd``): at eta = 0 the table
kernel on the tensor cores, with the rows in Morton order
(``rhs_self.row_order``) and each block's table centred on its rows, the
columns in their own order; at eta != 0 the direct ETA instance.  They
replace the TPU kernels ``_rhs_self_mm_kernel`` via ``_rhs_cross_fwd_mm``
(eta = 0) and ``_rhs_self_kernel`` via ``_rhs_cross_fwd_stream`` (any eta).
Its plain PyTorch version is ``rhs_cross_fwd_reference``, chunked over rows.
A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or the call raises.  ``launches`` counts kernel launches.

Three autograd Functions carry the ring's rotation bodies, the counterparts of
the custom VJPs ``make_rhs_cross``, ``make_rhs_xcross`` and
``make_hamiltonian_cross``:

- ``RHSCross``: the forward above; the backward is the generated
  ``pair_poly.rhs_cross_bwd_poly`` on both sides, centered by the column
  set's masked centroid;
- ``RHSXCross``: (vx, dcost) of data rows against a support column set, on
  the external-point forward kernel (``rhs_ext.rhs_ext_fwd``, its ETA
  instance at eta != 0); backward, the dx and dq/dp kernels at eta = 0 and
  the generated ``pair_poly.rhs_ext_bwd_poly`` otherwise;
- ``HamiltonianCross``: the cross Hamiltonian share on
  ``pair_poly.hamiltonian_cross_poly``, differentiable on both sides.

Shapes: rows (..., M, D), columns (..., N, D) with D in {2, 3}, masks
(..., M) / (..., N); leading dimensions are frames and agree.
"""

from __future__ import annotations

import ctypes

import torch

from difficp_torch.ops import _build, ksum, pair_poly, rhs_ext
from difficp_torch.ops.rhs_self import (DIRECT_ROWS, _check, _frames, _order_for, _raise_on,
                                        block_rows, direct_plan, fwd_reference)
from difficp_torch.utils import profiling

# kernel launches since the last reset (reset by assigning 0); the any-eta
# instance counts apart
launches = {"rhs_cross_fwd": 0, "rhs_cross_fwd_eta": 0}

_bound = False


def cross_fwd_ops_per_pair(d: int) -> int:
    """The least FP32 work of the cross forward (logdet on) per ordered pair
    (row i, column j), for its bound: rows differ from columns, so no term is
    shared between (i, j) and (j, i).  An FMA counts as two; per-point factors
    (mc_j folded into p~_j = mc_j pc_j, the exponent's scale folded into the
    coordinates, u and mr_i per row) are O(M + N) and not counted.  With
    e_i = sum_j k mc_j d, dcost's row sum is -u mr_i pr_i.e_i:

        d = qr_i - qc_j                             d
        r2 = |d|^2                                  2d - 1
        pp = pr_i.p~_j                              2d - 1
        v_i += k p~_j                               2d
        w_i += (k pp) d                             2d + 1
        km = k mc_j;  e_i += km d                   2d + 1

    and one exponential, on the MUFU.  The eta = 0 kernel's route is that of
    the self forward (``rhs_self.tensor_flops_per_pair``).
    """
    return 11 * d


def cross_fwd_eta_ops_per_pair(d: int, withlogdet: bool) -> int:
    """The least FP32 work of the any-eta cross forward per ordered pair,
    counted as ``cross_fwd_ops_per_pair`` counts it.  The gradcomponent terms
    need, besides e_i (which v's eta term reads with or without logdet),
    s0_i = sum k mc_j (sum_j k~ c = pr_i s0_i - v_i per row), b_i = sum k~
    (d.c) d, f_i = sum k~ r2 d and, for dcost, g_i = sum k~ r2:

        the eta = 0 terms                           11d
        s0_i += km                                  1
        t = km (d.(pr_i - p~_j));  b_i += t d       5d
        h = km r2;  f_i += h d                      2d + 1
        g_i += h                                    1        (logdet only)

    which makes 18d + 3 with logdet and 18d + 2 without.
    """
    return 18 * d + (3 if withlogdet else 2)


def rhs_cross_fwd_reference(qr, pr, mr, qc, pc, mc, sigma, withlogdet, eta=0.0):
    """Plain version of the cross forward kernel: (v, w, per-row dcost
    partials), chunked over rows so memory stays O(chunk N)."""
    return fwd_reference(qr, pr, mr, qc, pc, mc, sigma, withlogdet, eta)


def _lib():
    global _bound
    lib = _build.library()
    if not _bound:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.difficp_rhs_cross_fwd.argtypes = [vp] * 7 + [ci, ci] + [vp] * 5 + [ci] * 5 + [
            cf, ci, cf, ci, vp]
        lib.difficp_rhs_cross_fwd.restype = ci
        _bound = True
    return lib


def rhs_cross_fwd(qr, pr, mr, qc, pc, mc, sigma, withlogdet, eta=0.0, order=None):
    """(v, w, per-row dcost partials) of the rows against the columns, with
    the gradcomponent terms when eta != 0.  CPU tensors take the plain
    version; CUDA tensors launch the eta = 0 table kernel with the rows in
    ``order`` (``rhs_self.row_order`` of the rows, computed when not given),
    or the ETA instance when eta != 0."""
    if qr.device.type == "cpu":
        with profiling.span("ops.rhs_cross_fwd_eta" if eta != 0.0 else "ops.rhs_cross_fwd"):
            return rhs_cross_fwd_reference(qr, pr, mr, qc, pc, mc, sigma, withlogdet, eta)
    return launch_fwd(qr, pr, mr, qc, pc, mc, sigma, withlogdet, eta, eta != 0.0, order)


def launch_fwd(qr, pr, mr, qc, pc, mc, sigma, withlogdet, eta, use_eta, order=None):
    """One launch of a cross forward kernel on CUDA tensors: the ETA
    instance when ``use_eta`` (at any eta, 0 included), else the eta = 0
    table kernel."""
    if qr.device.type != "cuda":
        raise ValueError(f"rhs_cross_fwd: unsupported device {qr.device}")
    kernel = "rhs_cross_fwd_eta" if use_eta else "rhs_cross_fwd"
    call = profiling.span("ops." + kernel)
    nb, m, d = _frames(qr)
    nbc, n, dc_ = _frames(qc)
    if tuple(qr.shape[:-2]) != tuple(qc.shape[:-2]) or d != dc_:
        raise ValueError(f"rhs_cross_fwd: rows {tuple(qr.shape)} and columns "
                         f"{tuple(qc.shape)} differ in frames or dimension")
    for name, t, shape in (("qr", qr, qr.shape), ("pr", pr, qr.shape),
                           ("mr", mr, qr.shape[:-1]), ("qc", qc, qc.shape),
                           ("pc", pc, qc.shape), ("mc", mc, qc.shape[:-1])):
        _check(name, t, shape, qr.device)
    if use_eta:
        order, rows = None, DIRECT_ROWS
        cols, part, ticket = direct_plan(qr, nb, m, n, rows, 2 * d + 1)
    else:
        order, rows = _order_for(qr, mr, order, sigma), block_rows(qr)
        cols, part, ticket = 0, None, None
    v = torch.empty_like(qr)
    w = torch.empty_like(qr)
    dc = torch.empty_like(mr)
    stream = torch.cuda.current_stream(qr.device).cuda_stream
    err = _lib().difficp_rhs_cross_fwd(
        qr.data_ptr(), pr.data_ptr(), mr.data_ptr(), qc.data_ptr(), pc.data_ptr(),
        mc.data_ptr(), None if order is None else order.data_ptr(),
        0 if order is None else order.shape[-1], rows, v.data_ptr(), w.data_ptr(),
        dc.data_ptr(), part, ticket, cols, nb, m, n, d,
        1.0 / (sigma * sigma), int(bool(withlogdet)), float(eta), int(bool(use_eta)),
        stream)
    _raise_on(err, kernel)
    launches[kernel] += 1
    call.end(rows=rows)
    return v, w, dc


def _cotangent(g, like):
    return torch.zeros_like(like) if g is None else g.contiguous()


class RHSCross(torch.autograd.Function):
    """(v, w, dcost per frame) of the rows against the columns (the contract
    of ``make_rhs_cross``): forward, the cross kernel, the rows in ``order``
    at eta = 0; backward, the generated kernel-sums for both sides, on
    coordinates centered by the column set's masked centroid."""

    @staticmethod
    def forward(ctx, qr, pr, mr, qc, pc, mc, sigma, withlogdet, eta=0.0, order=None):
        qr, pr, mr, qc, pc, mc = (t.contiguous() for t in (qr, pr, mr, qc, pc, mc))
        ctx.save_for_backward(qr, pr, mr, qc, pc, mc)
        ctx.sigma, ctx.withlogdet, ctx.eta = sigma, withlogdet, eta
        v, w, dc = rhs_cross_fwd(qr, pr, mr, qc, pc, mc, sigma, withlogdet, eta, order)
        return v, w, dc.sum(-1)

    @staticmethod
    def backward(ctx, gv, gw, gc):
        qr, pr, mr, qc, pc, mc = ctx.saved_tensors
        gv, gw = _cotangent(gv, qr), _cotangent(gw, qr)
        gc = (torch.zeros(qr.shape[:-2], dtype=qr.dtype, device=qr.device)
              if gc is None or not ctx.withlogdet else gc.contiguous())
        c = ksum.mm_center(qc, mc)
        dqr, dpr, dqc, dpc = pair_poly.rhs_cross_bwd_poly(
            qr - c, pr, mr, qc - c, pc, mc, gv, gw, gc, ctx.sigma, ctx.eta)
        return dqr, dpr, None, dqc, dpc, None, None, None, None, None


class RHSXCross(torch.autograd.Function):
    """(vx, dcost per frame) of data rows x against a support column set (the
    contract of ``make_rhs_xcross``): forward, the external-point forward
    kernel (its ETA instance at eta != 0) at every size; backward, the dx and
    dq/dp kernels at eta = 0 and the generated kernel-sums on centered
    coordinates otherwise.  Gradients flow to x and to the columns."""

    @staticmethod
    def forward(ctx, x, mx, qc, pc, mc, sigma, withlogdet, eta=0.0):
        x, mx, qc, pc, mc = (t.contiguous() for t in (x, mx, qc, pc, mc))
        ctx.save_for_backward(x, mx, qc, pc, mc)
        ctx.sigma, ctx.withlogdet, ctx.eta = sigma, withlogdet, eta
        vx, dc = rhs_ext.rhs_ext_fwd(x, mx, qc, pc, mc, sigma, withlogdet, eta)
        return vx, dc.sum(-1)

    @staticmethod
    def backward(ctx, gx, gc):
        x, mx, qc, pc, mc = ctx.saved_tensors
        sigma, wl = ctx.sigma, ctx.withlogdet
        gx = _cotangent(gx, x)
        gc = (torch.zeros(qc.shape[:-2], dtype=qc.dtype, device=qc.device)
              if gc is None or not wl else gc.contiguous())
        if ctx.eta != 0.0:
            c = ksum.mm_center(qc, mc)
            dq, dp, dx = pair_poly.rhs_ext_bwd_poly(qc - c, pc, x - c, mc, mx, gx, gc,
                                                    sigma, ctx.eta)
        else:
            dx = rhs_ext.rhs_ext_bwd_dx(x, mx, gx, qc, pc, mc, gc, sigma, wl)
            dq, dp = rhs_ext.rhs_ext_bwd_dqdp(x, mx, gx, qc, pc, mc, gc, sigma, wl)
        return dx, None, dq, dp, None, None, None, None


class HamiltonianCross(torch.autograd.Function):
    """The cross Hamiltonian share H(rows; columns) per frame, with the
    gradcomponent terms (the contract of ``make_hamiltonian_cross``): the
    value from ``hamiltonian_cross_poly``; the backward evaluates both
    sides' gradients.  Coordinates centered by the column set's masked
    centroid."""

    @staticmethod
    def forward(ctx, qr, pr, mr, qc, pc, mc, sigma, eta=0.0):
        ctx.save_for_backward(qr, pr, mr, qc, pc, mc)
        ctx.sigma, ctx.eta = sigma, eta
        c = ksum.mm_center(qc, mc)
        return pair_poly.hamiltonian_cross_poly(qr - c, pr, mr, qc - c, pc, mc, sigma,
                                                eta)["h"]

    @staticmethod
    def backward(ctx, g):
        qr, pr, mr, qc, pc, mc = ctx.saved_tensors
        c = ksum.mm_center(qc, mc)
        outs = pair_poly.hamiltonian_cross_poly(qr - c, pr, mr, qc - c, pc, mc, ctx.sigma,
                                                ctx.eta, ("row", "col"))
        g = g[..., None, None]
        return (g * outs["dq_row"], g * outs["dp_row"], None,
                g * outs["dq_col"], g * outs["dp_col"], None, None, None)


def rhs_cross(qr, pr, mr, qc, pc, mc, sigma, withlogdet, eta=0.0, order=None):
    """(v, -Gq, dcost) of the rows against the columns, with autograd; at
    eta = 0 the rows in ``order`` (``rhs_self.row_order`` of the rows,
    computed per call when None)."""
    return RHSCross.apply(qr, pr, mr, qc, pc, mc, float(sigma), bool(withlogdet),
                          float(eta), order)


def rhs_xcross(x, mx, qc, pc, mc, sigma, withlogdet, eta=0.0):
    """(vx, dcost) of data rows against support columns, with autograd."""
    return RHSXCross.apply(x, mx, qc, pc, mc, float(sigma), bool(withlogdet), float(eta))


def hamiltonian_cross(qr, pr, mr, qc, pc, mc, sigma, eta=0.0):
    """The cross Hamiltonian share, with autograd."""
    return HamiltonianCross.apply(qr, pr, mr, qc, pc, mc, float(sigma), float(eta))
