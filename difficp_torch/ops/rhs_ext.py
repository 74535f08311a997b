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
support point, as partial sums over chunks of the data axis).  They replace
the TPU kernels of ``difficp_tpu/ops/pallas_reductions.py``: ``_vx_mm_kernel``
(via ``_vx_fwd_pallas``) and ``_ext_bwd_dx_mm_kernel`` +
``_ext_bwd_dqdp_mm_kernel`` (via ``_ext_bwd_pallas``).  What bounds them and
how their design answers it is noted in the source.

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
from difficp_torch.ops.rhs_self import _check, _chunk_rows, _frames, _ones_mask, _raise_on

# kernel launches since the last reset (reset by assigning 0)
launches = {"rhs_ext_fwd": 0, "rhs_ext_bwd_dx": 0, "rhs_ext_bwd_dqdp": 0,
            "rhs_ext_fwd_eta": 0}

# data rows per chunk of the dq/dp kernel's split of the data axis: at
# N = 65,536 and 10 frames of M ~ 342 support points, 32 chunks x 3 row
# blocks x 10 frames = 960 blocks for 132 SMs
DQDP_CHUNK = 2048

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

    with dx_l = -u e_l + c_l a_l per row.  The kernel forms
    w = Gx_l + c_l delta per pair instead.
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
    per row.  The kernel forms p_l.e per pair and sums k Gx_i and km e
    apart instead.
    """
    return 9 * d + 3


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
        lib.difficp_rhs_ext_fwd_eta.argtypes = [vp] * 7 + [ci] * 4 + [cf, ci, cf, ci, vp]
        lib.difficp_rhs_ext_fwd_eta.restype = ci
        lib.difficp_rhs_ext_bwd_dx.argtypes = [vp] * 8 + [ci] * 4 + [cf, ci, vp]
        lib.difficp_rhs_ext_bwd_dx.restype = ci
        lib.difficp_rhs_ext_bwd_dqdp.argtypes = [vp] * 9 + [ci] * 5 + [cf, ci, vp]
        lib.difficp_rhs_ext_bwd_dqdp.restype = ci
        _bound = True
    return lib


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
    vx = torch.empty_like(x)
    dc = torch.empty_like(mx)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().difficp_rhs_ext_fwd_eta(
        x.data_ptr(), mx.data_ptr(), q.data_ptr(), p.data_ptr(), mq.data_ptr(),
        vx.data_ptr(), dc.data_ptr(), nb, n, m, d, 1.0 / (sigma * sigma),
        int(bool(withlogdet)), float(eta), int(bool(use_eta)), stream)
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


def rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc, sigma, withlogdet):
    """dx of (vx, dcost) for cotangents gx and gc (one per frame).  CPU
    tensors take the plain version; CUDA tensors launch the dx kernel."""
    if x.device.type == "cpu":
        return rhs_ext_bwd_dx_reference(x, mx, gx, q, p, mq, gc, sigma, withlogdet)
    nb, n, m, d = _check_bwd("rhs_ext_bwd_dx", x, mx, gx, q, p, mq, gc)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().difficp_rhs_ext_bwd_dx(
        x.data_ptr(), mx.data_ptr(), gx.data_ptr(), q.data_ptr(), p.data_ptr(),
        mq.data_ptr(), gc.data_ptr(), dx.data_ptr(), nb, n, m, d,
        1.0 / (sigma * sigma), int(bool(withlogdet)), stream)
    _raise_on(err, "rhs_ext_bwd_dx")
    launches["rhs_ext_bwd_dx"] += 1
    return dx


def rhs_ext_bwd_dqdp(x, mx, gx, q, p, mq, gc, sigma, withlogdet):
    """(dq, dp) of (vx, dcost) for cotangents gx and gc.  CPU tensors take
    the plain version; CUDA tensors launch the dq/dp kernel, whose per-chunk
    partials are summed here in a fixed order."""
    if x.device.type == "cpu":
        return rhs_ext_bwd_dqdp_reference(x, mx, gx, q, p, mq, gc, sigma, withlogdet)
    nb, n, m, d = _check_bwd("rhs_ext_bwd_dqdp", x, mx, gx, q, p, mq, gc)
    n_chunks = -(-n // DQDP_CHUNK)
    dq_part = torch.empty((nb, n_chunks, m, d), dtype=q.dtype, device=q.device)
    dp_part = torch.empty_like(dq_part)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().difficp_rhs_ext_bwd_dqdp(
        x.data_ptr(), mx.data_ptr(), gx.data_ptr(), q.data_ptr(), p.data_ptr(),
        mq.data_ptr(), gc.data_ptr(), dq_part.data_ptr(), dp_part.data_ptr(),
        nb, n, m, d, DQDP_CHUNK, 1.0 / (sigma * sigma), int(bool(withlogdet)),
        stream)
    _raise_on(err, "rhs_ext_bwd_dqdp")
    launches["rhs_ext_bwd_dqdp"] += 1
    return dq_part.sum(1).reshape(q.shape), dp_part.sum(1).reshape(q.shape)


# ---------------------------------------------------------------------------
# autograd Function
# ---------------------------------------------------------------------------

class RHSExt(torch.autograd.Function):
    """(vq, -Gq, dcost, vx) = fused ext RHS (the contract of the JAX package's
    ``make_rhs_ext``).  At eta = 0, forward: the self kernel on the support
    with logdet off, and the ext forward kernel; backward: the self backward
    kernel with a zero dcost cotangent for the support-support terms, and the
    dx and dq/dp kernels for the cross terms, summed; the self kernels with
    the support's rows in ``order`` (``rhs_self.row_order``, computed per
    call when None).  At eta != 0 the routes of the module docstring, on
    coordinates shifted by one centroid."""

    @staticmethod
    def forward(ctx, q, p, x, mq, mx, sigma, withlogdet, eta=0.0, order=None):
        q, p, x, mq, mx = (t.contiguous() for t in (q, p, x, mq, mx))
        ctx.save_for_backward(q, p, x, mq, mx)
        ctx.sigma, ctx.withlogdet, ctx.eta, ctx.order = sigma, withlogdet, eta, order
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
            return dq1 + dq2, dp1 + dp2, dx, None, None, None, None, None, None
        dq1, dp1 = rhs_self.rhs_self_bwd(q, p, mq, gv, gw, zero_c, sigma, False, ctx.order)
        dx = rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc, sigma, wl)
        dq2, dp2 = rhs_ext_bwd_dqdp(x, mx, gx, q, p, mq, gc, sigma, wl)
        return dq1 + dq2, dp1 + dp2, dx, None, None, None, None, None, None


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
                  order=None):
    """Kernel-route fused ext RHS: (vq, -Gq, dcost, vx) with autograd; at eta
    = 0 the support's rows in ``order`` for the self kernels."""
    mq = _ones_mask(q) if mask_q is None else mask_q
    mx = _ones_mask(x) if mask_x is None else mask_x
    return RHSExt.apply(q, p, x, mq, mx, float(sigma), bool(withlogdet), float(eta), order)


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
