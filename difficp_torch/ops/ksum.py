"""Generic Gaussian kernel-sums over a table of payload columns, with a
hand-written CUDA kernel (counterpart of ``difficp_tpu/ops/pallas_ksum.py``).

One function carries every standalone pairwise reduction of the gradcomponent
(eta != 0) model and its generated VJPs (``ops/pair_poly.py``):

    A[..., i, c] = sum_j exp(-|x_i - y_j|^2 / 2 sigma^2) m_j T[..., j, c]

- ``pairwise_ksum`` -- the function itself (the JAX ``pairwise_ksum`` and its
  y-resident blocked variant ``_pairwise_ksum_blocked``), with leading frame
  axes and a per-frame or shared y;
- ``pairwise_ksum_sym`` -- the self case x = y with the table built from
  variable rows outside the kernel (the JAX ``pairwise_ksum_sym``); here the
  same kernel over ordered pairs;
- ``mm_center`` -- the masked centroid that the payload tables are built
  around (``pallas_reductions._mm_center``);
- ``grad_kred`` -- sum_j (grad K)(x_i - y_j) m_j with its VJP (the JAX
  ``grad_kred_mm``);
- ``kred`` / ``kred_scal`` -- sum_j K(x_i - y_j) m_j b_j between two point
  sets, vector or scalar payload, with its VJP (the JAX ``kred_mm`` /
  ``kred_scal_mm``): the standard algorithm's ``data_distance``;
- ``mdivsum`` -- sum_i -div(v)(x_i) at data points with its VJP, on the
  generated pair polynomials (the JAX ``make_mdivsum``).

The CUDA kernel is ``csrc/ksum.cu`` (the exponential tile contracted with the
table on the tensor cores, wgmma in 3xTF32); its plain PyTorch version
(``ksum_reference``) is chunked over rows so memory stays O(chunk Ny).  A
tensor on the CPU takes the plain version; a CUDA tensor launches the kernel
or the call raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from difficp_torch.ops import _build
from difficp_torch.ops.rhs_self import _check, _chunk_rows, _frames, _raise_on

# kernel launches since the last reset (reset by assigning 0)
launches = {"ksum": 0}

# payload columns a chunk holds at most (16 n-tiles of the 8-column mma);
# wider tables are cut into chunks over a grid axis
MAX_CHUNK_COLS = 128
# columns of y a staged tile holds (csrc/ksum.cu kTileJ): the y axis is
# padded to it and cut into splits of a multiple of it
TILE_COLS = 64
# a launch with fewer than TARGET_BLOCKS / 2 blocks splits the y axis too,
# into splits of at least MIN_SPLIT_COLS columns, aiming at TARGET_BLOCKS
# blocks (4 waves of an H100's 132 SMs: the kernel runs one block an SM)
TARGET_BLOCKS = 528
MIN_SPLIT_COLS = 1024

_bound = False


def ops_per_pair(d: int, ncols: int) -> int:
    """The least FP32 work of the function per (x_i, y_j) pair when every
    multiply-add runs on the FP32 pipe, for the FP32 bound (``bound_fp32``):
    an FMA counts as two; the mask and the exponent's scale are per-point
    factors (folded into the table and the coordinates), O(N) and not counted:

        delta = x_i - y_j                           d
        r2 = |delta|^2                              2d - 1
        A[i, c] += k T[j, c]                        2 ncols

    and one exponential, on the MUFU.  In the self case each unordered pair
    shares delta, r2 and the exponential between its two rows.
    """
    return 3 * d - 1 + 2 * ncols


def tensor_flops_per_pair(ncols: int) -> int:
    """Tensor-core work per pair of the kernel's route: A[i, c] += k T[j, c]
    as three TF32 products (k_lo T_hi, k_hi T_lo, k_hi T_hi), two FLOP each,
    which float32 accuracy takes."""
    return 3 * 2 * ncols


def fp32_ops_per_pair(d: int) -> int:
    """FP32-pipe work per pair beside the tensor-core products:

        delta = x_i - y_j                           d
        r2 = |delta|^2                              2d - 1
        exponent's scale  -u r2 / 2                 1
        k_hi = rna(k)                               1
        k_lo = k - k_hi                             1

    and one exponential, on the MUFU.  The table's split is O(C Ny), once a
    call, and not counted.
    """
    return 3 * d - 1 + 1 + 1 + 1


def chunking(ncols: int) -> tuple[int, int]:
    """(columns per chunk, chunks) of a table of ncols columns: the fewest
    chunks of at most MAX_CHUNK_COLS columns, each a multiple of 8 (the step
    of the wgmma's N), so that each pair takes ceil(ncols / 128)
    exponentials."""
    n = -(-ncols // MAX_CHUNK_COLS)
    per = -(-ncols // n)
    return 8 * -(-per // 8), n


def block_rows(ncols: int) -> int:
    """Rows a block covers: 4 warpgroups of 64 rows for chunks of up to 64
    columns, 2 above, where the accumulators take twice the registers
    (csrc/ksum.cu Shape)."""
    return 256 if chunking(ncols)[0] <= 64 else 128


def splitting(frames: int, nx: int, ny: int, ncols: int) -> int:
    """Columns per split of the y axis, a multiple of TILE_COLS (ny rounded up
    to it when the axis is not split)."""
    _, n_chunks = chunking(ncols)
    blocks = frames * -(-nx // block_rows(ncols)) * n_chunks
    s = 1
    if 2 * blocks < TARGET_BLOCKS:
        s = max(1, min(-(-TARGET_BLOCKS // blocks), ny // MIN_SPLIT_COLS))
    cols = -(-ny // s)
    step = 128 if s > 1 else TILE_COLS
    return step * -(-cols // step)


@contextlib.contextmanager
def full_fp32_matmul():
    """Float32 products in full float32 on the card: TF32 off for the block,
    whatever the caller set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# plain version and kernel wrapper
# ---------------------------------------------------------------------------

def ksum_reference(x, y, table, my, sigma):
    """Plain version of the kernel: A (..., C, Nx) for x (..., Nx, D), y
    (..., Ny, D) or (Ny, D), table (..., C, Ny) or (C, Ny), my like y without
    D, or None."""
    u = 1.0 / (sigma * sigma)
    nx = x.shape[-2]
    chunk = _chunk_rows(y.shape[-2], x.shape[-1])
    outs = []
    with full_fp32_matmul():
        for lo in range(0, nx, chunk):
            hi = min(lo + chunk, nx)
            d = x[..., lo:hi, None, :] - y[..., None, :, :]
            k = torch.exp(-0.5 * u * (d * d).sum(-1))
            if my is not None:
                k = k * my[..., None, :]
            outs.append(table @ k.transpose(-1, -2))
    return torch.cat(outs, -1)


def _lib():
    global _bound
    lib = _build.library()
    if not _bound:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.difficp_ksum.argtypes = [vp] * 7 + [ci] * 8 + [cf, vp]
        lib.difficp_ksum.restype = ci
        _bound = True
    return lib


def ksum(x, y, table, my, sigma):
    """A (..., C, Nx) = sum_j K(x_i - y_j) m_j table[..., :, j].  y, table
    and my carry the frames of x, or none (shared by every frame); my may be
    None (all ones).  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if x.device.type == "cpu":
        return ksum_reference(x, y, table, my, sigma)
    if x.device.type != "cuda":
        raise ValueError(f"ksum: unsupported device {x.device}")
    nb, nx, d = _frames(x)
    lead = tuple(x.shape[:-2])
    shared = y.dim() == 2 and x.dim() > 2
    ylead = () if shared else lead
    ny, ncols = y.shape[-2], table.shape[-2]
    _check("x", x, x.shape, x.device)
    _check("y", y, (*ylead, ny, d), x.device)
    _check("table", table, (*ylead, ncols, ny), x.device)
    if my is not None:
        _check("my", my, (*ylead, ny), x.device)
    cw, n_chunks = chunking(ncols)
    cols = splitting(nb, nx, ny, ncols)
    n_splits = -(-ny // cols)
    nyp = TILE_COLS * -(-ny // TILE_COLS)
    fy = 1 if shared else nb
    # scratch in one allocation: the y records (fy, nyp) float4, then the
    # split table in the wgmma B layout, (fy, n_chunks, nyp / 8) k-steps of
    # 4 cw 16-byte words
    rec_words = fy * nyp * 4
    scratch = torch.empty(rec_words + fy * n_chunks * (nyp // 8) * cw * 16,
                          dtype=torch.int32, device=x.device)
    out = torch.empty((nb, n_splits, ncols, nx), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().difficp_ksum(
        x.data_ptr(), y.data_ptr(), None if my is None else my.data_ptr(),
        table.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + 4 * rec_words,
        out.data_ptr(), nb, nx, ny, d, ncols, cw // 8, cols, int(shared),
        1.0 / (sigma * sigma), stream)
    _raise_on(err, "ksum")
    launches["ksum"] += 1
    out = out[:, 0] if n_splits == 1 else out.sum(1)
    return out.reshape(*lead, ncols, nx)


def pairwise_ksum(x, y, payloads, sigma, mask_y=None):
    """A[..., i, c] = sum_j K(x_i - y_j) m_j payloads[..., j, c] -> (..., Nx,
    C), the JAX ``pairwise_ksum``.  Not differentiable on its own: the ops
    that use it carry their own VJPs."""
    table = payloads.transpose(-1, -2).contiguous()
    my = None if mask_y is None else mask_y.contiguous()
    return ksum(x.contiguous(), y.contiguous(), table, my, float(sigma)).transpose(-1, -2)


class Monomials:
    """Products of variable rows for a fixed list of monomials (sorted tuples
    of row indices), built one degree at a time: each product is its prefix's
    product times one more variable, the chain of the JAX package's prefix
    cache, in a few tensor operations a degree."""

    def __init__(self, monos):
        monos = [tuple(mn) for mn in monos]
        prefixes = {mn[:k] for mn in monos for k in range(1, len(mn) + 1)}
        pos = {(): 0}
        self.levels = []
        for length in range(1, max((len(mn) for mn in monos), default=0) + 1):
            level = sorted(t for t in prefixes if len(t) == length)
            start = len(pos)
            prev_start = start - len([t for t in pos if len(t) == length - 1])
            self.levels.append((
                torch.tensor([pos[t[:-1]] - prev_start for t in level]),
                torch.tensor([t[-1] for t in level])))
            for i, t in enumerate(level):
                pos[t] = start + i
        self.take = torch.tensor([pos[mn] for mn in monos])
        self._on = {}

    def _indices(self, device):
        if device not in self._on:
            self._on[device] = ([(a.to(device), b.to(device)) for a, b in self.levels],
                                self.take.to(device))
        return self._on[device]

    def __call__(self, root, rows):
        """(..., n_monos, N) products, each starting from root (..., N), over
        rows (..., n_vars, N)."""
        levels, take = self._indices(root.device)
        cur = root.unsqueeze(-2)
        parts = [cur]
        for parent, var in levels:
            cur = cur.index_select(-2, parent) * rows.index_select(-2, var)
            parts.append(cur)
        return torch.cat(parts, -2).index_select(-2, take)


_SYM_PLANS = {}


def pairwise_ksum_sym(var_rows, d, mask_row, monos, sigma):
    """Generic self kernel-sum A[..., i, c] = sum_j K(x_i - x_j) m_j
    prod(var_rows[r][..., j] for r in monos[c]) -> (..., M, len(monos)), the
    JAX ``pairwise_ksum_sym``: rows 0..d-1 of ``var_rows`` are the point
    coordinates, ``mask_row`` indexes the binary 0/1 mask, which multiplies
    every payload column once (m^k == m).  The table is built here, outside
    the kernel; the kernel runs the self case over ordered pairs."""
    monos = tuple(tuple(mn) for mn in monos)
    if monos not in _SYM_PLANS:
        _SYM_PLANS[monos] = Monomials(monos)
    rows = torch.stack(var_rows, -2)
    table = _SYM_PLANS[monos](var_rows[mask_row], rows)
    coords = torch.stack(var_rows[:d], -1)
    return ksum(coords, coords, table.contiguous(), None, float(sigma)).transpose(-1, -2)


def mm_center(q, mask):
    """Masked centroid (..., 1, D) of each frame, the shift the payload
    tables are built around (the JAX ``pallas_reductions._mm_center``): the
    outputs depend on positions only through differences, so the shift is
    exact and keeps the monomials extent-sized.  Not differentiated."""
    with torch.no_grad():
        w = mask.sum(-1).clamp_min(1.0)
        return ((q * mask[..., None]).sum(-2) / w[..., None]).unsqueeze(-2)


# ---------------------------------------------------------------------------
# GradKRed (reference kernel.py:142) with the hand-derived VJP
# ---------------------------------------------------------------------------

def _sym_pairs(d):
    return [(a, b) for a in range(d) for b in range(a, d)]


def _dot(a, b):
    return (a * b).sum(-1)


class GradKRed(torch.autograd.Function):
    """sum_j (grad K)(x_i - y_j) m_j = -u sum_j K m_j (x_i - y_j) -> (..., Nx,
    D), the JAX ``grad_kred_mm``: forward columns [1 | yc]; the VJP expands
    (g.delta) delta into monomials of degree <= 2 on each side, one
    kernel-sum per direction."""

    @staticmethod
    def forward(ctx, x, y, my, sigma):
        c = mm_center(y, my)
        xc, yc = x - c, y - c
        u = 1.0 / (sigma * sigma)
        cols = torch.cat([torch.ones_like(yc[..., :1]), yc], -1)
        a = pairwise_ksum(xc, yc, cols, sigma, my)
        ctx.save_for_backward(x, y, my)
        ctx.sigma = sigma
        return -u * (xc * a[..., :1] - a[..., 1:])

    @staticmethod
    def backward(ctx, g):
        x, y, my = ctx.saved_tensors
        sigma = ctx.sigma
        d = y.shape[-1]
        c = mm_center(y, my)
        xc, yc = x - c, y - c
        u = 1.0 / (sigma * sigma)
        sym = _sym_pairs(d)
        # dx_i = -u g_i A[1] + u^2 sum_e g_e <(xc_e - y_e)(xc_dd - y_dd)>_K
        cols2 = torch.cat([torch.ones_like(yc[..., :1]), yc]
                          + [yc[..., a:a + 1] * yc[..., b:b + 1] for a, b in sym], -1)
        a2 = pairwise_ksum(xc, yc, cols2, sigma, my)
        a_one = a2[..., 0]
        a_y = a2[..., 1:1 + d]

        def a_yy(a, b):
            return a2[..., 1 + d + sym.index((min(a, b), max(a, b)))]

        ge = _dot(g, xc)
        gay = _dot(g, a_y)
        dx = torch.stack([
            -u * g[..., e] * a_one
            + u * u * (xc[..., e] * ge * a_one - xc[..., e] * gay - ge * a_y[..., e]
                       + sum(g[..., f] * a_yy(e, f) for f in range(d)))
            for e in range(d)], -1)
        # dy_j = m_j [u A'[g] - u^2 (A'[s x] - yc A'[s] - sum_e yc_e A'[x g_e]
        #                              + yc sum_e yc_e A'[g_e])],  s = g.xc
        cols3 = torch.cat([g, ge[..., None], ge[..., None] * xc]
                          + [xc[..., a:a + 1] * g for a in range(d)], -1)
        a3 = pairwise_ksum(yc, xc, cols3, sigma, None)
        a3_g = a3[..., :d]
        a3_s = a3[..., d]
        ycg = _dot(yc, a3_g)
        dy = torch.stack([
            my * (u * a3_g[..., e] - u * u * (
                a3[..., d + 1 + e] - yc[..., e] * a3_s
                - sum(yc[..., f] * a3[..., 2 * d + 1 + e * d + f] for f in range(d))
                + yc[..., e] * ycg))
            for e in range(d)], -1)
        return dx, dy, None, None


def grad_kred(x, y, sigma, mask_y=None):
    """Kernel-route sum_j (grad K)(x_i - y_j) m_j, with autograd."""
    my = torch.ones(y.shape[:-1], dtype=y.dtype, device=y.device) if mask_y is None else mask_y
    return GradKRed.apply(x, y, my, float(sigma))


# ---------------------------------------------------------------------------
# KRed / KRedScal (reference kernel.py:134-138) with the hand-derived VJP
# ---------------------------------------------------------------------------

class KRed(torch.autograd.Function):
    """sum_j K(x_i - y_j) m_j b_j -> (..., Nx, B), vector payload b (..., Ny,
    B), the JAX ``kred_mm``.  With delta = x_i - y_j, u = 1/sigma^2 and the
    cotangent g:

        db_j = m_j sum_i K g_i                      (reverse kernel-sum)
        dx_i = -u sum_j K m_j (g_i . b_j) delta     (forward, cols b, yc b)
        dy_j = +u m_j sum_i K (g_i . b_j) delta     (reverse, cols g, xc g)

    one ``ksum`` forward, and a ``ksum`` a direction backward, each only
    where a gradient it gives is asked for; both sides are centred by the
    masked centroid of y.  ``x`` and ``y`` may be one tensor (the self
    term <fy, fy>): autograd then adds dx and dy.  my may be None."""

    @staticmethod
    def forward(ctx, x, y, b, my, sigma):
        c = mm_center(y, _ones_mask(y) if my is None else my)
        out = pairwise_ksum(x - c, y - c, b, sigma, my)
        ctx.save_for_backward(x, y, b, my)
        ctx.sigma = sigma
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, b, my = ctx.saved_tensors
        sigma = ctx.sigma
        need_x, need_y, need_b = ctx.needs_input_grad[:3]
        d, nb = y.shape[-1], b.shape[-1]
        c = mm_center(y, _ones_mask(y) if my is None else my)
        xc, yc = x - c, y - c
        u = 1.0 / (sigma * sigma)
        dx = dy = db = None
        if need_x:
            # forward-direction table [b | yc_e b]
            cols = torch.cat([b] + [yc[..., e:e + 1] * b for e in range(d)], -1)
            a2 = pairwise_ksum(xc, yc, cols, sigma, my)
            gb = _dot(g, a2[..., :nb])
            dx = torch.stack([
                -u * (xc[..., e] * gb - _dot(g, a2[..., nb * (1 + e):nb * (2 + e)]))
                for e in range(d)], -1)
        if need_y or need_b:
            # reverse-direction table [g | xc_e g]
            cols = torch.cat([g] + [xc[..., e:e + 1] * g for e in range(d)], -1)
            a3 = pairwise_ksum(yc, xc, cols, sigma, None)
            m = torch.ones_like(yc[..., 0]) if my is None else my
            if need_b:
                db = a3[..., :nb] * m[..., None]
            if need_y:
                bg = _dot(b, a3[..., :nb])
                dy = torch.stack([
                    u * m * (_dot(b, a3[..., nb * (1 + e):nb * (2 + e)]) - yc[..., e] * bg)
                    for e in range(d)], -1)
        return dx, dy, db, None, None


def _ones_mask(y):
    return torch.ones(y.shape[:-1], dtype=y.dtype, device=y.device)


def kred(x, y, b, sigma, mask_y=None):
    """Kernel-route sum_j K(x_i - y_j) m_j b_j between two point sets (or one
    set twice), with autograd in x, y and b."""
    return KRed.apply(x, y, b, mask_y, float(sigma))


def kred_scal(x, y, d, sigma, mask_y=None):
    """Kernel-route sum_j K(x_i - y_j) m_j d_j, scalar payload d (..., Ny),
    the JAX ``kred_scal_mm``: ``kred`` over one column."""
    return KRed.apply(x, y, d[..., None], mask_y, float(sigma))[..., 0]


# ---------------------------------------------------------------------------
# mdivsum (reference LDDMM.py:120-138) on the generated pair polynomials
# ---------------------------------------------------------------------------

class MDivSum(torch.autograd.Function):
    """sum over the data points x of -div(v)(x_i), per frame:

        sum_ij k(x_i - q_j) m_i m_j [u p_j.(x_i - q_j) + eta u (u d2 - d)]

    the JAX ``make_mdivsum``.  Forward: one kernel-sum over the x-side logdet
    density ``dcx`` of the ext cross terms (``pair_poly.eval_polys``).
    Backward: the generated ext backward (``pair_poly.rhs_ext_bwd_poly``)
    with the vx cotangent 0 and the scalar cotangent as gc.  Both sides are
    centred by the masked centroid of q."""

    @staticmethod
    def forward(ctx, x, q, p, mask_q, mask_x, sigma, eta):
        from difficp_torch.ops import pair_poly as pp

        c = mm_center(q, mask_q)
        xc, qc = x - c, q - c
        polys = {"dcx": pp._ext_fwd_polys(x.shape[-1], sigma, eta, True)["dcx"]}
        xvals = pp._coords({"m": mask_x}, xc)
        qvals = pp._coords({"m": mask_q}, qc, p)
        out = pp.eval_polys(polys, xc, qc, xvals, qvals, sigma)["dcx"].sum(-1)
        ctx.save_for_backward(x, q, p, mask_q, mask_x)
        ctx.sigma, ctx.eta = sigma, eta
        return out

    @staticmethod
    def backward(ctx, ghat):
        from difficp_torch.ops import pair_poly as pp

        x, q, p, mask_q, mask_x = ctx.saved_tensors
        c = mm_center(q, mask_q)
        dq, dp, dx = pp.rhs_ext_bwd_poly(q - c, p, x - c, mask_q, mask_x,
                                         torch.zeros_like(x), ghat, ctx.sigma, ctx.eta)
        return dx, dq, dp, None, None, None, None


def mdivsum(x, q, p, sigma, eta, mask_q=None, mask_x=None):
    """Kernel-route sum_i -div(v)(x_i) per frame, with autograd in x, q, p."""
    mq = _ones_mask(q) if mask_q is None else mask_q
    mx = _ones_mask(x) if mask_x is None else mask_x
    return MDivSum.apply(x, q, p, mq, mx, float(sigma), float(eta))
