"""Fused LDDMM self right-hand side, with hand-written CUDA kernels.

With u = 1/sigma^2, k_ij = exp(-u |q_i - q_j|^2 / 2), d_ij = q_i - q_j and the
mask m, the op returns per frame (the contract of
``difficp_tpu.ops.reductions.lddmm_rhs_self`` at eta = 0):

    v_i   = m_i sum_j m_j k_ij p_j
    w_i   = u m_i sum_j m_j k_ij (p_i.p_j) d_ij          (the returned -Gq)
    dcost = -u sum_i m_i sum_j m_j k_ij (p_i.d_ij)       (0 without logdet)

and with the gradcomponent field (eta != 0) the terms of ``csrc/rhs_self.cu``'s
header besides.  Two kernels in ``csrc/rhs_self.cu`` compute it on the card:
``rhs_self_fwd`` (v, w and per-row dcost partials; any eta, eta a template
switch) and ``rhs_self_bwd`` (the VJP at eta = 0, dq and dp).  They replace
the TPU kernels of ``difficp_tpu/ops/pallas_reductions.py`` (forward:
``_rhs_self_sym_mm_kernel``, ``_rhs_self_sym_pair_kernel`` mode="fwd",
``_rhs_self_mm_kernel``, and at any eta ``_rhs_self_kernel``; backward:
``_rhs_self_bwd_mm_kernel``, ``_rhs_self_sym_pair_kernel`` mode="bwd").  What
bounds them and how their design answers it is noted in the source.

At eta != 0 ``RHSSelf`` routes as the JAX package's ``make_rhs_self``: the
forward is the any-eta kernel below ``_POLY_FWD_MIN_M`` points a frame and the
generated forward of ``ops/pair_poly.py`` (generic kernel-sums on centered
coordinates) from there on; the backward is always the generated one.

Beside each kernel is its plain PyTorch version (``rhs_self_fwd_reference``,
``rhs_self_bwd_reference``), chunked over rows so memory stays O(chunk M).  A
tensor on the CPU takes the plain version; a CUDA tensor launches the kernel or
the call raises.  ``launches`` counts kernel launches.

Shapes: q, p (..., M, D) with D in {2, 3}; m (..., M).  Leading dimensions are
frames, one grid row of blocks each.
"""

from __future__ import annotations

import ctypes

import torch

from difficp_torch.ops import _build

# kernel launches since the last reset (reset by assigning 0); the any-eta
# instance of the forward kernel counts apart
launches = {"rhs_self_fwd": 0, "rhs_self_bwd": 0, "rhs_self_fwd_eta": 0}

# eta != 0 forwards switch from the any-eta kernels to the generated
# kernel-sum forwards (pair_poly) at this many points a frame: support points
# for the self terms, data points for the ext cross terms (the JAX package's
# pallas_reductions._POLY_FWD_MIN_M)
_POLY_FWD_MIN_M = 32768

_bound = False


def fwd_ops_per_unordered_pair(d: int) -> int:
    """The least FP32 work of the forward function per unordered pair {i, j},
    for its bound: an FMA counts as two, a term shared by (i, j) and (j, i) is
    counted once, and constant factors (u, the exponent's scale) are applied
    per row.  The exponential is not counted here: it issues on the MUFU, one
    per unordered pair.  With k~ = m_i m_j k:

        d = q_i - q_j                               d
        r2 = |d|^2                                  2d - 1
        k~                                          2
        pp = p_i.p_j                                2d - 1
        v_i += k~ p_j,  v_j += k~ p_i               4d
        t = (k~ pp) d;  w_i += t,  w_j -= t         3d + 1
        dcost += k~ (p_i - p_j).d                   3d + 1

    The kernel itself takes each ordered pair apart: 11 d + 5 operations and
    one exponential per ordered pair.
    """
    return 15 * d + 2


def bwd_ops_per_unordered_pair(d: int) -> int:
    """The least FP32 work of the VJP per unordered pair {l, j}, counted as
    ``fwd_ops_per_unordered_pair`` counts it (c the cotangent of dcost; u
    factored out of dq's sum, u and u c out of dp's last two sums):

        d, r2, k~                                   3d + 1
        db = b_l - b_j,  dpv = p_l - p_j            2d
        pp, db.d, dpv.d                             6d - 3
        ap = a_l.p_j + a_j.p_l                      4d - 1
        S = ap + u pp (db.d) - u c (dpv.d)          5
        X = -S d + pp db - c dpv                    5d
        dq_l += k~ X,  dq_j -= k~ X                 3d
        dp_l += k~ a_j,  dp_j += k~ a_l             4d
        g = k~ (db.d);  dp_l += g p_j,  dp_j += g p_l    4d + 1
        h = k~ d;  dp_l -= h,  dp_j += h (times c)  3d

    The kernel takes each ordered pair apart: 29 d + 7 operations and one
    exponential per ordered pair.
    """
    return 34 * d + 3


def fwd_eta_ops_per_unordered_pair(d: int, withlogdet: bool) -> int:
    """The least FP32 work of the any-eta forward per unordered pair, counted
    as ``fwd_ops_per_unordered_pair`` counts it, with k~ = m_i m_j k, c = p_i
    - p_j, the sums s0 = sum k~ and the eta factors applied per row
    (sum_j k~ c = p_i s0 - v_i):

        the eta = 0 terms                           15d + 2  (12d + 1 without
                                                    the dcost line)
        without logdet: c, c.d, t = k~ (c.d)        3d
        g = k~ d;  a_i += g,  a_j -= g              3d
        s0_i += k~,  s0_j += k~                     2
        t d;  b_i += t d,  b_j -= t d               3d
        h = (k~ r2) d;  e_i += h,  e_j -= h         3d + 1
        dcost: sum k~ r2, sum k~                    2        (logdet only)

    which makes 24d + 7 with logdet and 24d + 4 without.
    """
    return 24 * d + (7 if withlogdet else 4)


def _ones_mask(q):
    return torch.ones(q.shape[:-1], dtype=q.dtype, device=q.device)


def _chunk_rows(m_cols: int, d: int, budget: int = 1 << 24) -> int:
    return max(1, budget // max(1, m_cols * (d + 1)))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _pair_block(q, m, lo, hi, u, qc=None):
    """d (..., c, N, D) and k (..., c, N) with m_j folded in, rows lo:hi of q
    against the columns qc (q itself by default) with their mask m."""
    d = q[..., lo:hi, None, :] - (q if qc is None else qc)[..., None, :, :]
    k = torch.exp(-0.5 * u * (d * d).sum(-1)) * m[..., None, :]
    return d, k


def fwd_reference(q, p, m, qc, pc, mc, sigma, withlogdet, eta=0.0):
    """Plain version of the forward kernel between the rows (q, p, m) and the
    columns (qc, pc, mc): (v, w, per-row dcost partials), with the
    gradcomponent terms when eta != 0.  Chunked over rows."""
    u = 1.0 / (sigma * sigma)
    mm, dim = q.shape[-2], q.shape[-1]
    chunk = _chunk_rows(qc.shape[-2], 2 * dim)
    vs, ws, dcs = [], [], []
    for lo in range(0, mm, chunk):
        hi = min(lo + chunk, mm)
        d, k = _pair_block(q, mc, lo, hi, u, qc)
        pi = p[..., lo:hi, :]
        mi = m[..., lo:hi, None]
        v = k @ pc
        kpp = k * (pi @ pc.transpose(-1, -2))
        w = u * (kpp[..., None] * d).sum(-2)
        pd = (pi[..., None, :] * d).sum(-1)
        dc = -u * (k * pd).sum(-1)
        if eta != 0.0:
            r2 = (d * d).sum(-1)
            c = pi[..., None, :] - pc[..., None, :, :]
            kdc = k * (d * c).sum(-1)
            lap = k * (u * r2 - (dim + 2))
            v = v + eta * u * (k[..., None] * d).sum(-2)
            w = w + eta * (u * u * (kdc[..., None] * d).sum(-2)
                           - u * (k[..., None] * c).sum(-2)
                           - eta * u * u * (lap[..., None] * d).sum(-2))
            dc = dc + eta * u * (k * (u * r2 - dim)).sum(-1)
        vs.append(mi * v)
        ws.append(mi * w)
        dcs.append(m[..., lo:hi] * dc if withlogdet else torch.zeros_like(m[..., lo:hi]))
    return torch.cat(vs, -2), torch.cat(ws, -2), torch.cat(dcs, -1)


def rhs_self_fwd_reference(q, p, m, sigma, withlogdet, eta=0.0):
    """Plain version of the forward kernel: (v, w, per-row dcost partials),
    with the gradcomponent terms when eta != 0."""
    return fwd_reference(q, p, m, q, p, m, sigma, withlogdet, eta)


def rhs_self_bwd_reference(q, p, m, a, b, c, sigma, withlogdet):
    """Plain version of the backward kernel: (dq, dp) for cotangents a of v,
    b of w and c (one per frame) of dcost."""
    u = 1.0 / (sigma * sigma)
    mm = q.shape[-2]
    chunk = _chunk_rows(mm, 3 * q.shape[-1])
    c = c if withlogdet else torch.zeros_like(c)
    cc = c[..., None, None]
    dqs, dps = [], []
    for lo in range(0, mm, chunk):
        hi = min(lo + chunk, mm)
        d, k = _pair_block(q, m, lo, hi, u)
        pl, al, bl = (t[..., lo:hi, None, :] for t in (p, a, b))
        pj, aj, bj = (t[..., None, :, :] for t in (p, a, b))
        db = bl - bj
        dpl = pl - pj
        pp = (pl * pj).sum(-1)
        dbd = (db * d).sum(-1)
        dpd = (dpl * d).sum(-1)
        s = ((al * pj).sum(-1) + (aj * pl).sum(-1) + u * pp * dbd
             - u * cc * dpd)
        ml = m[..., lo:hi, None]
        kk = k[..., None]
        dps.append(ml * (kk * (aj + u * dbd[..., None] * pj
                               - u * cc[..., None] * d)).sum(-2))
        dqs.append(ml * (kk * (-u * s[..., None] * d + u * pp[..., None] * db
                               - u * cc[..., None] * dpl)).sum(-2))
    return torch.cat(dqs, -2), torch.cat(dps, -2)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _lib():
    global _bound
    lib = _build.library()
    if not _bound:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.difficp_rhs_self_fwd_eta.argtypes = [vp] * 6 + [ci, ci, ci, cf, ci, cf, ci, vp]
        lib.difficp_rhs_self_fwd_eta.restype = ci
        lib.difficp_rhs_self_bwd.argtypes = [vp] * 8 + [ci, ci, ci, cf, ci, vp]
        lib.difficp_rhs_self_bwd.restype = ci
        _bound = True
    return lib


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _frames(q):
    if q.dim() < 2 or q.shape[-1] not in (2, 3):
        raise ValueError(f"q must be (..., M, 2|3), got {tuple(q.shape)}")
    b = 1
    for s in q.shape[:-2]:
        b *= s
    return b, q.shape[-2], q.shape[-1]


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def rhs_self_fwd(q, p, m, sigma, withlogdet, eta=0.0):
    """(v, w, per-row dcost partials), with the gradcomponent terms when eta
    != 0.  CPU tensors take the plain version; CUDA tensors launch the
    forward kernel (its ETA instance when eta != 0)."""
    if q.device.type == "cpu":
        return rhs_self_fwd_reference(q, p, m, sigma, withlogdet, eta)
    return launch_fwd(q, p, m, sigma, withlogdet, eta, eta != 0.0)


def launch_fwd(q, p, m, sigma, withlogdet, eta, use_eta):
    """One launch of the forward kernel on CUDA tensors: the ETA instance
    when ``use_eta`` (at any eta, 0 included), else the eta = 0 instance."""
    if q.device.type != "cuda":
        raise ValueError(f"rhs_self_fwd: unsupported device {q.device}")
    nb, mm, d = _frames(q)
    _check("q", q, q.shape, q.device)
    _check("p", p, q.shape, q.device)
    _check("m", m, q.shape[:-1], q.device)
    v = torch.empty_like(q)
    w = torch.empty_like(q)
    dc = torch.empty_like(m)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().difficp_rhs_self_fwd_eta(
        q.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(), w.data_ptr(),
        dc.data_ptr(), nb, mm, d, 1.0 / (sigma * sigma), int(bool(withlogdet)),
        float(eta), int(bool(use_eta)), stream)
    name = "rhs_self_fwd_eta" if use_eta else "rhs_self_fwd"
    _raise_on(err, name)
    launches[name] += 1
    return v, w, dc


def rhs_self_bwd(q, p, m, a, b, c, sigma, withlogdet):
    """(dq, dp) of the self RHS for cotangents a (of v), b (of w) and c (of
    each frame's dcost, shape q.shape[:-2]).  CPU tensors take the plain
    version; CUDA tensors launch the backward kernel."""
    if q.device.type == "cpu":
        return rhs_self_bwd_reference(q, p, m, a, b, c, sigma, withlogdet)
    if q.device.type != "cuda":
        raise ValueError(f"rhs_self_bwd: unsupported device {q.device}")
    nb, mm, d = _frames(q)
    for name, t in (("q", q), ("p", p), ("a", a), ("b", b)):
        _check(name, t, q.shape, q.device)
    _check("m", m, q.shape[:-1], q.device)
    _check("c", c, q.shape[:-2], q.device)
    dq = torch.empty_like(q)
    dp = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().difficp_rhs_self_bwd(
        q.data_ptr(), p.data_ptr(), m.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), dq.data_ptr(), dp.data_ptr(), nb, mm, d,
        1.0 / (sigma * sigma), int(bool(withlogdet)), stream)
    _raise_on(err, "rhs_self_bwd")
    launches["rhs_self_bwd"] += 1
    return dq, dp


# ---------------------------------------------------------------------------
# autograd Functions
# ---------------------------------------------------------------------------

def eta_forward(q, p, m, sigma, withlogdet, eta):
    """(v, w, dcost per frame) at eta != 0, routed as ``make_rhs_self``: the
    any-eta kernel below ``_POLY_FWD_MIN_M`` points, else the generated
    forward on centered coordinates."""
    if q.shape[-2] < _POLY_FWD_MIN_M:
        v, w, dc = rhs_self_fwd(q, p, m, sigma, withlogdet, eta)
        return v, w, dc.sum(-1)
    from difficp_torch.ops import ksum, pair_poly

    v, gq, dc = pair_poly.rhs_self_fwd_poly(q - ksum.mm_center(q, m), p, m, sigma, eta,
                                            withlogdet)
    return v, -gq, dc


class RHSSelf(torch.autograd.Function):
    """(v, w, dcost) = fused self RHS.  At eta = 0 the backward recomputes k
    in the backward kernel from the saved q, p and m.  At eta != 0 the
    forward is ``eta_forward`` and the backward the generated kernel-sums on
    centered coordinates."""

    @staticmethod
    def forward(ctx, q, p, m, sigma, withlogdet, eta=0.0):
        q, p, m = q.contiguous(), p.contiguous(), m.contiguous()
        ctx.save_for_backward(q, p, m)
        ctx.sigma, ctx.withlogdet, ctx.eta = sigma, withlogdet, eta
        if eta != 0.0:
            return eta_forward(q, p, m, sigma, withlogdet, eta)
        v, w, dc = rhs_self_fwd(q, p, m, sigma, withlogdet)
        return v, w, dc.sum(-1)

    @staticmethod
    def backward(ctx, gv, gw, gc):
        q, p, m = ctx.saved_tensors
        gv = torch.zeros_like(q) if gv is None else gv.contiguous()
        gw = torch.zeros_like(q) if gw is None else gw.contiguous()
        gc = (torch.zeros(q.shape[:-2], dtype=q.dtype, device=q.device)
              if gc is None or not ctx.withlogdet else gc.contiguous())
        if ctx.eta != 0.0:
            from difficp_torch.ops import ksum, pair_poly

            qc = q - ksum.mm_center(q, m)
            dq, dp = pair_poly.rhs_self_bwd_poly(qc, p, m, gv, gw, gc, ctx.sigma,
                                                 ctx.eta)
        else:
            dq, dp = rhs_self_bwd(q, p, m, gv, gw, gc, ctx.sigma, ctx.withlogdet)
        return dq, dp, None, None, None, None


class Hamiltonian(torch.autograd.Function):
    """H = 1/2 sum_ij m_i m_j k_ij p_i.p_j at eta = 0, per frame, from one
    forward-kernel call: H = 1/2 sum_i p_i.v_i.  The gradient is an epilogue
    on the saved outputs: dH/dq = -w, dH/dp = v (the JAX package's
    ``pallas_ksum.make_hamiltonian``)."""

    @staticmethod
    def forward(ctx, q, p, m, sigma):
        q, p, m = q.contiguous(), p.contiguous(), m.contiguous()
        v, w, _ = rhs_self_fwd(q, p, m, sigma, False)
        ctx.save_for_backward(v, w)
        return 0.5 * (p * v).sum((-2, -1))

    @staticmethod
    def backward(ctx, g):
        v, w = ctx.saved_tensors
        g = g[..., None, None]
        return -g * w, g * v, None, None


class HamiltonianEta(torch.autograd.Function):
    """H(q, p) with the gradcomponent terms (reference LDDMM.py:142-159), per
    frame, as the JAX package's ``make_hamiltonian`` at eta != 0: the value
    is one generic kernel-sum over the columns [1 | qc | p | |qc|^2]
    (centered coordinates); the gradient is (Gq, v(q)) = (-w, v) from one
    launch of the any-eta forward kernel."""

    @staticmethod
    def forward(ctx, q, p, m, sigma, eta):
        from difficp_torch.ops import ksum

        q, p, m = q.contiguous(), p.contiguous(), m.contiguous()
        ctx.save_for_backward(q, p, m)
        ctx.sigma, ctx.eta = sigma, eta
        d = q.shape[-1]
        u = 1.0 / (sigma * sigma)
        qc = q - ksum.mm_center(q, m)
        q2 = (qc * qc).sum(-1, keepdim=True)
        cols = torch.cat([torch.ones_like(q2), qc, p, q2], -1)
        a = ksum.pairwise_ksum(qc, qc, cols, sigma, m)
        a1, aq, ap, aqq = a[..., 0], a[..., 1:1 + d], a[..., 1 + d:1 + 2 * d], a[..., 1 + 2 * d]
        h = 0.5 * (p * ap).sum(-1)
        h = h + eta * u * ((p * qc).sum(-1) * a1 - (p * aq).sum(-1))
        lap = u * (q2[..., 0] * a1 - 2.0 * (qc * aq).sum(-1) + aqq) - d * a1
        h = h - 0.5 * eta * eta * u * lap
        return (m * h).sum(-1)

    @staticmethod
    def backward(ctx, g):
        q, p, m = ctx.saved_tensors
        v, w, _ = rhs_self_fwd(q, p, m, ctx.sigma, False, ctx.eta)
        g = g[..., None, None]
        return -g * w, g * v, None, None, None


def lddmm_rhs_self(q, p, sigma, withlogdet, mask_q=None, eta=0.0):
    """Kernel-route fused RHS: (vq, -Gq, dcost) with autograd."""
    m = _ones_mask(q) if mask_q is None else mask_q
    return RHSSelf.apply(q, p, m, float(sigma), bool(withlogdet), float(eta))


def hamiltonian(q, p, sigma, mask_q=None, eta=0.0):
    """Kernel-route Hamiltonian, with autograd."""
    m = _ones_mask(q) if mask_q is None else mask_q
    if eta != 0.0:
        return HamiltonianEta.apply(q, p, m, float(sigma), float(eta))
    return Hamiltonian.apply(q, p, m, float(sigma))
