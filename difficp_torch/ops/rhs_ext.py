"""External-point LDDMM right-hand side, with hand-written CUDA kernels.

Under grid or custom support the data points x are advected by the flow of
the support (q, p).  With u = 1/sigma^2, k_ij = exp(-u |x_i - q_j|^2 / 2),
delta_ij = x_i - q_j and masks mx, mq, the op returns per frame (the contract
of ``difficp_tpu.ops.reductions.lddmm_rhs_ext`` at eta = 0):

    vq, -Gq  the self RHS of the support (``ops/rhs_self.py``, logdet off)
    vx_i  = mx_i sum_j mq_j k_ij p_j
    dcost = u sum_i mx_i sum_j mq_j k_ij (p_j.delta_ij)   (0 without logdet)

Three kernels in ``csrc/rhs_ext.cu`` compute the cross terms on the card:
``rhs_ext_fwd`` (vx and per-row dcost partials), ``rhs_ext_bwd_dx`` and
``rhs_ext_bwd_dqdp`` (the VJP of (vx, dcost): dx per data point; dq, dp per
support point).  They replace the TPU kernels of
``difficp_tpu/ops/pallas_reductions.py``: ``_vx_mm_kernel`` (via
``_vx_fwd_pallas``) and ``_ext_bwd_dx_mm_kernel`` +
``_ext_bwd_dqdp_mm_kernel`` (via ``_ext_bwd_pallas``).  The forward is a
direct pair sum (``csrc/direct.cuh``), blocks of FWD_ROWS data rows against
the support, the support axis cut into chunks where the rows alone would
leave SMs idle (``rhs_self.direct_chunk_cols``; v_field's 380 rows against
65,536 points); the two VJP kernels are, as those TPU kernels, a table
kernel-sum on the tensor cores (3xTF32 wgmma) and a per-row epilogue, the
tables (``dx_table``, ``dqdp_table``) centred on each block of rows, the
rows taken in a spatial order (``rhs_self.row_order``): the dx kernel the
data rows in ``xorder`` (``data_order``, which ``RHSExt`` receives),
the dq/dp kernel the support's rows in the self kernels' ``order`` and the
data axis in chunks whose partials it sums itself, in a fixed order.
What bounds them and how their design answers it is noted in the source.

The forward kernel takes eta as a template switch: its ETA instance adds the
gradcomponent terms of ``csrc/rhs_ext.cu``'s header (the TPU's any-eta
``_vx_kernel``).  At eta != 0, ``RHSExt`` routes as the JAX package's
``make_rhs_ext``: one centroid shift shared by all its parts, the support's
self terms as ``rhs_self.RHSSelf`` takes them (``rhs_self.eta_forward``), the
cross forward through the any-eta kernel below ``rhs_self._POLY_FWD_MIN_M``
data points a frame and through the generated kernel-sums of
``ops/pair_poly.py`` from there on, and the backward through the generated
kernel-sums.

Beside each kernel is its plain PyTorch version (``*_reference``), chunked
over rows so memory stays O(chunk M).  A tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or the call raises.  ``launches``
counts kernel launches.

Shapes: x (..., N, D), q, p (..., M, D) with D in {2, 3}; mx (..., N), mq
(..., M); the leading dimensions (frames) of x and q agree.
"""

from __future__ import annotations

import ctypes

import torch

from difficp_torch.ops import _build, rhs_self
# _workspace: the scratch dq/dp shares with the direct forwards, named here too
from difficp_torch.ops.rhs_self import (_check, _chunk_rows, _frames, _ones_mask,  # noqa: F401
                                        _raise_on, _scratch, _workspace, direct_plan)

# kernel launches since the last reset (reset by assigning 0)
launches = {"rhs_ext_fwd": 0, "rhs_ext_bwd_dx": 0, "rhs_ext_bwd_dqdp": 0,
            "rhs_ext_fwd_eta": 0}

# blocks a SM the dq/dp kernel's split of the data axis aims at
# (dqdp_chunk_cols): at N = 65,536 and 10 frames of the grid support's ~380
# points (7 row blocks of 64 a frame), 31 chunks of 2,176 columns, 2,170
# blocks for 132 SMs (8 and 32 a SM ran slower on an H100)
DQDP_BLOCKS_PER_SM = 16
# slots of the data order a block of the dx kernel takes at most
# (dx_block_rows; blocks of 256 ran slower on an H100)
DX_MAX_ROWS = 128
# the share of the data rows the data order may add in padding (data_order):
# a sparse cloud at small sigma needs cuts the self kernels' budget
# (rhs_self.ORDER_PAD_BUDGET) refuses, and without them a block of rows
# spans up to 20 sigma (2 frames of 5,003 points at d = 3, sigma = 0.025)
DATA_ORDER_PAD_BUDGET = 1 / 8

# data rows a block of the forward kernel takes (4 a thread: csrc/rhs_ext.cu
# ExtFwd)
FWD_ROWS = 128

_bound = False


def fwd_ops_per_pair(d: int) -> int:
    """The least FP32 work of the forward (logdet on) per (x_i, q_j) pair,
    for its bound: an FMA counts as two; per-point factors (mq_j folded into
    p_j, the exponent's scale folded into the coordinates, u m_x per row) are
    O(N + M) and not counted.  The divergence cost goes through the identity
    p_j.delta_ij = x_i.p_j - q_j.p_j, so per pair it needs one sum of
    k_ij (q_j.p_j), and x_i.(sum_j k_ij p_j) per row:

        delta = x_i - q_j                           d
        r2 = |delta|^2                              2d - 1
        vx_i += k p_j                               2d
        A_i += k (q_j.p_j)                          2

    and one exponential, on the MUFU.  The kernel forms p_j.delta_ij per
    pair instead, which needs no per-row epilogue.

    r2 is counted in the difference form in all three counts.  The expanded
    form |x_i|^2 + |q_j|^2 - 2 x_i.q_j (norms per point) costs 2d + 1, the
    same 5 at d = 2, where the bounds are taken, and loses the exponent to
    cancellation at |x|/sigma ~ 20 (u |x|^2 / 2 ~ 200 against float32's
    6e-8 relative rounding).
    """
    return 5 * d + 1


def fwd_eta_ops_per_pair(d: int, withlogdet: bool) -> int:
    """The least FP32 work of the any-eta forward per pair, counted as
    ``fwd_ops_per_pair`` counts it, with sum_j k delta_ij = x_i sum_j k -
    sum_j k q_j per row:

        the eta = 0 terms                           5d + 1  (5d - 1 without
                                                    the dcost line)
        s0_i += k                                   1
        B_i += k q_j                                2d
        dcost: C_i += k r2                          2       (logdet only)

    which makes 7d + 4 with logdet and 7d without.
    """
    return 7 * d + (4 if withlogdet else 0)


def dx_ops_per_pair(d: int) -> int:
    """The least FP32 work of dx per pair, counted as ``fwd_ops_per_pair``
    counts it.  With Gx_l = mx_l gx_l, c_l = gc u mx_l and
    g'_l = Gx_l + c_l x_l per data row and q_j.p_j per support point,
    (Gx_l + c_l delta).p_j = g'_l.p_j - c_l (q_j.p_j):

        delta = x_l - q_j                           d
        r2                                          2d - 1
        s = k (g'_l.p_j - c_l (q_j.p_j))            2d + 2
        e_l += s delta                              2d
        a_l += k p_j                                2d

    with dx_l = -u e_l + c_l a_l per row.  The kernel takes the table route
    instead (``dx_table``, ``tensor_flops_per_pair``).
    """
    return 9 * d + 1


def dqdp_ops_per_pair(d: int) -> int:
    """The least FP32 work of (dq, dp) per pair (support row l, data row i),
    counted as ``fwd_ops_per_pair`` counts it.  With e = q_l - x_i,
    h_i = Gx_i + gc u mx_i x_i (per data point) and c_l = gc u (p_l.q_l)
    (per support row), p_l.e = p_l.q_l - p_l.x_i turns the dq coefficient
    -u k (Gx_i.p_l) + gc u^2 k mx_i (p_l.e) into -u s, and
    sum_i k Gx_i - gc u sum_i km e = sum_i k h_i - gc u n_l q_l turns dp into
    one sum:

        e = q_l - x_i                               d
        r2                                          2d - 1
        km = k mx_i                                 1
        s = k (h_i.p_l) - c_l km                    2d + 2
        a_l += s e                                  2d
        g_l += k h_i                                2d
        n_l += km                                   1

    with dq_l = mq_l (-u a_l - gc u n_l p_l), dp_l = mq_l (g_l - gc u n_l q_l)
    per row.  The kernel takes the table route instead (``dqdp_table``,
    ``tensor_flops_per_pair``).
    """
    return 9 * d + 3


def dx_table(d: int) -> list:
    """The dx kernel's payload columns over the support (q centred on the
    block of data rows, p), in the order of the JAX package's
    ``_ext_bwd_dx_mm_kernel``: p_e | q_a p_e | q.p | q_a (q.p), 9 columns at
    d = 2 and 16 at d = 3."""
    names = [("p", e) for e in range(d)]
    names += [("qp", a, e) for a in range(d) for e in range(d)]
    names += [("qdp",)]
    names += [("qqdp", a) for a in range(d)]
    return names


def dqdp_table(d: int) -> list:
    """The dq/dp kernel's payload columns over the data (x centred on the
    block of support rows, Gx = mx gx, the mask m = mx), in the order of
    ``_ext_bwd_dqdp_mm_kernel``: Gx_f | x_a Gx_f | m | m x_f | m x_a x_b
    (a <= b), 12 columns at d = 2 and 22 at d = 3."""
    names = [("G", f) for f in range(d)]
    names += [("xG", a, f) for a in range(d) for f in range(d)]
    names += [("m",)]
    names += [("mx", f) for f in range(d)]
    names += [("mxx", a, b) for a in range(d) for b in range(a, d)]
    return names


def tensor_flops_per_pair(d: int, which: str) -> int:
    """Tensor-core work per (data, support) pair of the table route of dx
    (``which`` "dx") or dq/dp ("dqdp"): the table padded to n-tiles of 8
    columns (16 at d = 2 and 3 for dx; 16 and 24 for dq/dp), three TF32
    products of two FLOP each, as ``rhs_self.tensor_flops_per_pair``."""
    ncols = len(dx_table(d) if which == "dx" else dqdp_table(d))
    return 3 * 2 * 8 * -(-ncols // 8)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _gauss(d, u):
    return torch.exp(-0.5 * u * (d * d).sum(-1))


def rhs_ext_fwd_reference(x, mx, q, p, mq, sigma, withlogdet, eta=0.0):
    """Plain version of the forward kernel: (vx, per-row dcost partials), with
    the gradcomponent terms when eta != 0."""
    u = 1.0 / (sigma * sigma)
    n, dim = x.shape[-2], x.shape[-1]
    chunk = _chunk_rows(q.shape[-2], q.shape[-1])
    vxs, dcs = [], []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        d = x[..., lo:hi, None, :] - q[..., None, :, :]
        k = _gauss(d, u) * mq[..., None, :]
        mi = mx[..., lo:hi]
        vx = k @ p
        if eta != 0.0:
            vx = vx + eta * u * (k[..., None] * d).sum(-2)
        vxs.append(mi[..., None] * vx)
        if withlogdet:
            pd = (d * p[..., None, :, :]).sum(-1)
            if eta != 0.0:
                pd = pd + eta * (u * (d * d).sum(-1) - dim)
            dcs.append(u * mi * (k * pd).sum(-1))
        else:
            dcs.append(torch.zeros_like(mi))
    return torch.cat(vxs, -2), torch.cat(dcs, -1)


def rhs_ext_bwd_dx_reference(x, mx, gx, q, p, mq, gc, sigma, withlogdet):
    """Plain version of the dx kernel, for cotangents gx (of vx) and gc (of
    each frame's dcost, shape q.shape[:-2])."""
    u = 1.0 / (sigma * sigma)
    n = x.shape[-2]
    chunk = _chunk_rows(q.shape[-2], 2 * q.shape[-1])
    gc = gc if withlogdet else torch.zeros_like(gc)
    big_g = mx[..., None] * gx
    dxs = []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        d = x[..., lo:hi, None, :] - q[..., None, :, :]
        k = _gauss(d, u) * mq[..., None, :]
        cl = (gc[..., None] * u * mx[..., lo:hi])[..., None]  # (..., c, 1)
        w = big_g[..., lo:hi, None, :] + cl[..., None] * d
        wp = (w * p[..., None, :, :]).sum(-1)
        dxs.append(-u * ((k * wp)[..., None] * d).sum(-2) + cl * (k @ p))
    return torch.cat(dxs, -2)


def rhs_ext_bwd_dqdp_reference(x, mx, gx, q, p, mq, gc, sigma, withlogdet):
    """Plain version of the dq/dp kernel (its chunk partials summed)."""
    u = 1.0 / (sigma * sigma)
    n = x.shape[-2]
    chunk = _chunk_rows(q.shape[-2], 2 * q.shape[-1])
    cg = (gc if withlogdet else torch.zeros_like(gc))[..., None, None] * u
    big_g = mx[..., None] * gx
    pj = p[..., None, :, :]
    ae = ag = ame = torch.zeros_like(q)
    akm = torch.zeros_like(mq)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        e = q[..., None, :, :] - x[..., lo:hi, None, :]  # (..., c, M, D)
        k = _gauss(e, u)
        km = k * mx[..., lo:hi, None]
        gi = big_g[..., lo:hi, None, :]
        gp = (gi * pj).sum(-1)
        pe = (pj * e).sum(-1)
        coef = -u * k * gp + cg * u * km * pe
        ae = ae + (coef[..., None] * e).sum(-3)
        ag = ag + (k[..., None] * gi).sum(-3)
        ame = ame + (km[..., None] * e).sum(-3)
        akm = akm + km.sum(-2)
    ml = mq[..., None]
    dq = ml * (ae - cg * akm[..., None] * p)
    dp = ml * (ag - cg * ame)
    return dq, dp


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    global _bound
    lib = _build.library()
    if not _bound:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.difficp_rhs_ext_fwd_eta.argtypes = [vp] * 9 + [ci] * 6 + [cf, ci, cf, ci, vp]
        lib.difficp_rhs_ext_fwd_eta.restype = ci
        lib.difficp_rhs_ext_bwd_dx.argtypes = [vp] * 8 + [ci, ci, vp] + [ci] * 4 + [
            cf, ci, vp]
        lib.difficp_rhs_ext_bwd_dx.restype = ci
        lib.difficp_rhs_ext_bwd_dqdp.argtypes = [vp] * 8 + [ci, ci] + [vp] * 4 + [
            ci] * 5 + [cf, ci, vp]
        lib.difficp_rhs_ext_bwd_dqdp.restype = ci
        _bound = True
    return lib


def dx_block_rows(x) -> int:
    """Slots of the data order a block of the dx kernel takes: 128 where
    those blocks cover every SM of x's card once, else 64
    (``rhs_self.block_rows`` up to DX_MAX_ROWS); it divides the runs of
    ``rhs_self.row_order(x, ...)``, so no block straddles two."""
    return rhs_self.block_rows(x, DX_MAX_ROWS)


def data_order(x, mx, sigma):
    """The dx kernel's data-row order: ``rhs_self.row_order`` of (x, mx)
    with DATA_ORDER_PAD_BUDGET."""
    return rhs_self.row_order(x, mx, sigma, DATA_ORDER_PAD_BUDGET)


def dqdp_chunk_cols(n: int, row_blocks: int, sms: int) -> int:
    """Columns a chunk of the dq/dp kernel's data axis takes, a multiple of
    64: the n data columns of a frame cut into about DQDP_BLOCKS_PER_SM x
    sms / row_blocks chunks (row_blocks over all frames), none shorter than
    1,024 columns."""
    chunks = max(1, min(-(-DQDP_BLOCKS_PER_SM * sms // max(1, row_blocks)), -(-n // 1024)))
    per_chunk = -(-n // chunks)
    return -(-per_chunk // 64) * 64


def _check_pair(name, x, q):
    """(frames, N, M, D) of a cross op; x and q must agree in frames and D."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    nb, n, d = _frames(x)
    nbq, m, dq = _frames(q)
    if tuple(x.shape[:-2]) != tuple(q.shape[:-2]) or d != dq:
        raise ValueError(f"{name}: x {tuple(x.shape)} and q {tuple(q.shape)} "
                         "differ in frames or dimension")
    return nb, n, m, d


def rhs_ext_fwd(x, mx, q, p, mq, sigma, withlogdet, eta=0.0):
    """(vx, per-row dcost partials), with the gradcomponent terms when eta !=
    0.  CPU tensors take the plain version; CUDA tensors launch the forward
    kernel (its ETA instance when eta != 0)."""
    if x.device.type == "cpu":
        return rhs_ext_fwd_reference(x, mx, q, p, mq, sigma, withlogdet, eta)
    return launch_fwd(x, mx, q, p, mq, sigma, withlogdet, eta, eta != 0.0)


def launch_fwd(x, mx, q, p, mq, sigma, withlogdet, eta, use_eta):
    """One launch of the forward kernel on CUDA tensors: the ETA instance
    when ``use_eta`` (at any eta, 0 included), else the eta = 0 instance."""
    nb, n, m, d = _check_pair("rhs_ext_fwd", x, q)
    _check("x", x, x.shape, x.device)
    _check("mx", mx, x.shape[:-1], x.device)
    for name, t in (("q", q), ("p", p)):
        _check(name, t, q.shape, x.device)
    _check("mq", mq, q.shape[:-1], x.device)
    cols, part, ticket = direct_plan(x, nb, n, m, FWD_ROWS, d + 1)
    vx = torch.empty_like(x)
    dc = torch.empty_like(mx)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().difficp_rhs_ext_fwd_eta(
        x.data_ptr(), mx.data_ptr(), q.data_ptr(), p.data_ptr(), mq.data_ptr(),
        vx.data_ptr(), dc.data_ptr(), part, ticket, FWD_ROWS, cols, nb, n, m, d,
        1.0 / (sigma * sigma), int(bool(withlogdet)), float(eta), int(bool(use_eta)), stream)
    name = "rhs_ext_fwd_eta" if use_eta else "rhs_ext_fwd"
    _raise_on(err, name)
    launches[name] += 1
    return vx, dc


def _check_bwd(name, x, mx, gx, q, p, mq, gc):
    nb, n, m, d = _check_pair(name, x, q)
    for tn, t in (("x", x), ("gx", gx)):
        _check(tn, t, x.shape, x.device)
    _check("mx", mx, x.shape[:-1], x.device)
    for tn, t in (("q", q), ("p", p)):
        _check(tn, t, q.shape, x.device)
    _check("mq", mq, q.shape[:-1], x.device)
    _check("gc", gc, q.shape[:-2], x.device)
    return nb, n, m, d


def rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc, sigma, withlogdet, xorder=None):
    """dx of (vx, dcost) for cotangents gx and gc (one per frame).  CPU
    tensors take the plain version; CUDA tensors launch the dx table kernel
    once, the data rows in ``xorder`` (``data_order``, computed when not
    given) in blocks of ``dx_block_rows``."""
    if x.device.type == "cpu":
        return rhs_ext_bwd_dx_reference(x, mx, gx, q, p, mq, gc, sigma, withlogdet)
    nb, n, m, d = _check_bwd("rhs_ext_bwd_dx", x, mx, gx, q, p, mq, gc)
    xorder = data_order(x, mx, sigma) if xorder is None else rhs_self._order_for(
        x, mx, xorder, sigma)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().difficp_rhs_ext_bwd_dx(
        x.data_ptr(), mx.data_ptr(), gx.data_ptr(), q.data_ptr(), p.data_ptr(),
        mq.data_ptr(), gc.data_ptr(), xorder.data_ptr(), xorder.shape[-1],
        dx_block_rows(x), dx.data_ptr(), nb, n, m, d, 1.0 / (sigma * sigma),
        int(bool(withlogdet)), stream)
    _raise_on(err, "rhs_ext_bwd_dx")
    launches["rhs_ext_bwd_dx"] += 1
    return dx


def rhs_ext_bwd_dqdp(x, mx, gx, q, p, mq, gc, sigma, withlogdet, order=None):
    """(dq, dp) of (vx, dcost) for cotangents gx and gc.  CPU tensors take
    the plain version; CUDA tensors launch the dq/dp table kernel once, the
    support's rows in ``order`` (``rhs_self.row_order``, computed when not
    given), the data axis in chunks (``dqdp_chunk_cols``) whose partials the
    kernel sums in a fixed order."""
    if x.device.type == "cpu":
        return rhs_ext_bwd_dqdp_reference(x, mx, gx, q, p, mq, gc, sigma, withlogdet)
    nb, n, m, d = _check_bwd("rhs_ext_bwd_dqdp", x, mx, gx, q, p, mq, gc)
    order = rhs_self._order_for(q, mq, order, sigma)
    rows = rhs_self.block_rows(q)
    row_blocks = -(-order.shape[-1] // rows)
    cols = dqdp_chunk_cols(n, nb * row_blocks, rhs_self._sms(q))
    chunks = -(-n // cols)
    part, ticket = _scratch(x.device, nb * row_blocks * chunks * rows * 2 * d,
                            nb * row_blocks)
    dq = torch.empty_like(q)
    dp = torch.empty_like(q)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().difficp_rhs_ext_bwd_dqdp(
        x.data_ptr(), mx.data_ptr(), gx.data_ptr(), q.data_ptr(), p.data_ptr(),
        mq.data_ptr(), gc.data_ptr(), order.data_ptr(), order.shape[-1], rows,
        dq.data_ptr(), dp.data_ptr(), part.data_ptr(), ticket.data_ptr(), nb, n, m, d,
        cols, 1.0 / (sigma * sigma), int(bool(withlogdet)), stream)
    _raise_on(err, "rhs_ext_bwd_dqdp")
    launches["rhs_ext_bwd_dqdp"] += 1
    return dq, dp


# ---------------------------------------------------------------------------
# autograd Function
# ---------------------------------------------------------------------------

class RHSExt(torch.autograd.Function):
    """(vq, -Gq, dcost, vx) = fused ext RHS (the contract of the JAX package's
    ``make_rhs_ext``).  At eta = 0, forward: the self kernel on the support
    with logdet off, and the ext forward kernel; backward: the self backward
    kernel with a zero dcost cotangent for the support-support terms, and the
    dx and dq/dp kernels for the cross terms, summed (dx alone where
    neither q nor p takes a gradient); the self kernels and
    the dq/dp kernel with the support's rows in ``order``, the dx kernel with
    the data rows in ``xorder`` (``rhs_self.row_order`` of (q, mq) and
    ``data_order`` of (x, mx), each computed per call when None).  At eta != 0 the routes of
    the module docstring, on coordinates shifted by one centroid."""

    @staticmethod
    def forward(ctx, q, p, x, mq, mx, sigma, withlogdet, eta=0.0, order=None, xorder=None):
        q, p, x, mq, mx = (t.contiguous() for t in (q, p, x, mq, mx))
        ctx.save_for_backward(q, p, x, mq, mx)
        ctx.sigma, ctx.withlogdet, ctx.eta = sigma, withlogdet, eta
        ctx.order, ctx.xorder = order, xorder
        if eta != 0.0:
            return _eta_forward(q, p, x, mq, mx, sigma, withlogdet, eta)
        v, w, _ = rhs_self.rhs_self_fwd(q, p, mq, sigma, False, order=order)
        vx, dc = rhs_ext_fwd(x, mx, q, p, mq, sigma, withlogdet)
        return v, w, dc.sum(-1), vx

    @staticmethod
    def backward(ctx, gv, gw, gc, gx):
        q, p, x, mq, mx = ctx.saved_tensors
        sigma, wl = ctx.sigma, ctx.withlogdet
        gv = torch.zeros_like(q) if gv is None else gv.contiguous()
        gw = torch.zeros_like(q) if gw is None else gw.contiguous()
        gx = torch.zeros_like(x) if gx is None else gx.contiguous()
        zero_c = torch.zeros(q.shape[:-2], dtype=q.dtype, device=q.device)
        gc = zero_c if gc is None else gc.contiguous()
        if ctx.eta != 0.0:
            from difficp_torch.ops import ksum, pair_poly

            c = ksum.mm_center(q, mq)
            qc, xc = q - c, x - c
            # the self terms carry no logdet cost here (dc lives at x): gc = 0
            dq1, dp1 = pair_poly.rhs_self_bwd_poly(qc, p, mq, gv, gw, zero_c, sigma,
                                                   ctx.eta)
            dq2, dp2, dx = pair_poly.rhs_ext_bwd_poly(
                qc, p, xc, mq, mx, gx, gc if wl else zero_c, sigma, ctx.eta)
            return dq1 + dq2, dp1 + dp2, dx, None, None, None, None, None, None, None
        dx = rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc, sigma, wl, ctx.xorder)
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            # a frozen support (the standard algorithm's Template_opt): only
            # the data points take a gradient
            return None, None, dx, None, None, None, None, None, None, None
        dq1, dp1 = rhs_self.rhs_self_bwd(q, p, mq, gv, gw, zero_c, sigma, False, ctx.order)
        dq2, dp2 = rhs_ext_bwd_dqdp(x, mx, gx, q, p, mq, gc, sigma, wl, ctx.order)
        return dq1 + dq2, dp1 + dp2, dx, None, None, None, None, None, None, None


def _eta_forward(q, p, x, mq, mx, sigma, withlogdet, eta):
    """The forward of ``RHSExt`` at eta != 0 (``make_rhs_ext``'s routes)."""
    from difficp_torch.ops import ksum, pair_poly

    c = ksum.mm_center(q, mq)
    qc = q - c
    v, w, _ = rhs_self.eta_forward(q, p, mq, sigma, False, eta)
    if x.shape[-2] >= rhs_self._POLY_FWD_MIN_M:
        vx, dc = pair_poly.rhs_ext_fwd_poly(qc, p, x - c, mq, mx, sigma, eta,
                                            withlogdet)
    else:
        vx, dcr = rhs_ext_fwd((x - c).contiguous(), mx, qc.contiguous(), p, mq,
                              sigma, withlogdet, eta)
        dc = dcr.sum(-1)
    return v, w, dc, vx


def lddmm_rhs_ext(q, p, x, sigma, withlogdet, mask_q=None, mask_x=None, eta=0.0,
                  order=None, xorder=None):
    """Kernel-route fused ext RHS: (vq, -Gq, dcost, vx) with autograd; at eta
    = 0 the support's rows in ``order`` for the self and dq/dp kernels, the
    data rows in ``xorder`` for the dx kernel."""
    mq = _ones_mask(q) if mask_q is None else mask_q
    mx = _ones_mask(x) if mask_x is None else mask_x
    return RHSExt.apply(q, p, x, mq, mx, float(sigma), bool(withlogdet), float(eta), order,
                        xorder)


class VField(torch.autograd.Function):
    """v(x_i) = sum_j mq_j [k(x_i - q_j) p_j + eta u k (x_i - q_j)] at eta !=
    0, the JAX package's ``make_v_field``: forward, the ETA instance of the
    forward kernel on centered coordinates with logdet off and an all-ones
    data mask; backward, the generated ext backward with a zero dcost
    cotangent (where the JAX package takes a blockwise VJP)."""

    @staticmethod
    def forward(ctx, x, q, p, mq, sigma, eta):
        from difficp_torch.ops import ksum

        x, q, p, mq = (t.contiguous() for t in (x, q, p, mq))
        ctx.save_for_backward(x, q, p, mq)
        ctx.sigma, ctx.eta = sigma, eta
        c = ksum.mm_center(q, mq)
        vx, _ = rhs_ext_fwd((x - c).contiguous(), _ones_mask(x), (q - c).contiguous(),
                            p, mq, sigma, False, eta)
        return vx

    @staticmethod
    def backward(ctx, g):
        from difficp_torch.ops import ksum, pair_poly

        x, q, p, mq = ctx.saved_tensors
        c = ksum.mm_center(q, mq)
        zero_c = torch.zeros(q.shape[:-2], dtype=q.dtype, device=q.device)
        dq, dp, dx = pair_poly.rhs_ext_bwd_poly(q - c, p, x - c, mq, _ones_mask(x),
                                                g.contiguous(), zero_c, ctx.sigma, ctx.eta)
        return dx, dq, dp, None, None, None


def v_field(x, q, p, sigma, mask_q=None, eta=0.0):
    """v(x_i) = sum_j mq_j k(x_i - q_j) p_j (+ the gradcomponent term at eta
    != 0).  At eta = 0 the forward kernel with logdet off and an all-ones
    data mask (the function of the JAX package's
    ``pallas_ksum.make_v_field``), not differentiated: its callers (momentum
    projection, ``lddmm.v``) need values only.  At eta != 0 ``VField``, with
    its VJP."""
    mq = _ones_mask(q) if mask_q is None else mask_q.contiguous()
    if eta != 0.0:
        return VField.apply(x, q, p, mq, float(sigma), float(eta))
    x = x.contiguous()
    vx, _ = rhs_ext_fwd(x, _ones_mask(x), q.contiguous(), p.contiguous(), mq,
                        float(sigma), False)
    return vx
