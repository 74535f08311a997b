"""Fused LDDMM self right-hand side, with hand-written CUDA kernels.

With u = 1/sigma^2, k_ij = exp(-u |q_i - q_j|^2 / 2), d_ij = q_i - q_j and the
mask m, the op returns per frame (the contract of
``difficp_tpu.ops.reductions.lddmm_rhs_self`` at eta = 0):

    v_i   = m_i sum_j m_j k_ij p_j
    w_i   = u m_i sum_j m_j k_ij (p_i.p_j) d_ij          (the returned -Gq)
    dcost = -u sum_i m_i sum_j m_j k_ij (p_i.d_ij)       (0 without logdet)

and with the gradcomponent field (eta != 0) the terms of ``csrc/rhs_self.cu``'s
header besides.  Kernels in ``csrc/rhs_self.cu`` compute it on the card: at
eta = 0 ``rhs_self_fwd`` (v, w and per-row dcost partials) and
``rhs_self_bwd`` (the VJP, dq and dp), each a table kernel-sum on the tensor
cores (3xTF32 wgmma) and a per-row epilogue; at eta != 0 the any-eta
forward, a direct pair sum (``csrc/direct.cuh``: blocks of DIRECT_ROWS rows,
the column axis cut into chunks where the rows alone would leave SMs idle,
``direct_chunk_cols``, the chunks' partials summed in the launch in chunk
order).  They replace the TPU kernels of
``difficp_tpu/ops/pallas_reductions.py`` (forward: ``_rhs_self_sym_mm_kernel``,
``_rhs_self_sym_pair_kernel`` mode="fwd", ``_rhs_self_mm_kernel``, and at any
eta ``_rhs_self_kernel``; backward: ``_rhs_self_bwd_mm_kernel``,
``_rhs_self_sym_pair_kernel`` mode="bwd", ``_rhs_self_bwd_kernel``).  What
bounds them and how their design answers it is noted in the source.

The tables are the JAX package's (``fwd_table``, ``bwd_table``: monomials of
the columns' coordinates and payloads), and their recombination cancels terms
of up to degree 3 in the coordinates: the error grows with (R / sigma)^2 for a
block of rows of radius R.  So, as the JAX wrappers do, the eta = 0 kernels
take the rows in Morton order (``morton_codes``, the port's copy of
``_morton_order``'s codes) and centre each block's table on its rows' masked
centroid; ``row_order`` also cuts the Z-curve where it jumps between distant
parts of the cloud and pads the cuts with empty slots, so that no block
straddles two (an int32 index per frame, -1 in padding slots; its blocks of
``block_rows`` slots).  The order is computed at most once per
loss+grad: ``lddmm`` takes it from q0 once per shoot or optimisation (q0 is
fixed over one), the conjugate-gradient solve once per solve; a wrapper given
none computes its own.  ``orders`` counts the orders computed.

At eta != 0 ``RHSSelf`` routes as the JAX package's ``make_rhs_self``: the
forward is the any-eta kernel below ``_POLY_FWD_MIN_M`` points a frame and the
generated forward of ``ops/pair_poly.py`` (generic kernel-sums on centered
coordinates) from there on; the backward is always the generated one.

Beside each kernel is its plain PyTorch version (``rhs_self_fwd_reference``,
``rhs_self_bwd_reference``, direct pair sums), chunked over rows so memory
stays O(chunk M); it needs no order.  A tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or the call raises.  ``launches``
counts kernel launches.

Shapes: q, p (..., M, D) with D in {2, 3}; m (..., M).  Leading dimensions are
frames, one grid row of blocks each.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from difficp_torch.ops import _build
from difficp_torch.utils import profiling

# kernel launches since the last reset (reset by assigning 0); the any-eta
# instance of the forward kernel counts apart
launches = {"rhs_self_fwd": 0, "rhs_self_bwd": 0, "rhs_self_fwd_eta": 0}
# row orders computed (row_order), reset likewise
orders = {"row_order": 0}
# bits a coordinate of the Morton code takes (the JAX _morton_order's default)
MORTON_BITS = 10
# the row order may add at most this share of the rows in padding (row_order)
ORDER_PAD_BUDGET = 1 / 16
# SMs of the card the blocks are sized for where the tensor is not on one
# (an H100 SXM)
_DEFAULT_SMS = 132

# eta != 0 forwards switch from the any-eta kernels to the generated
# kernel-sum forwards (pair_poly) at this many points a frame: support points
# for the self terms, data points for the ext cross terms (the JAX package's
# pallas_reductions._POLY_FWD_MIN_M)
_POLY_FWD_MIN_M = 32768

# the RHS backward of RHSSelf and rhs_ext.RHSExt (backend.set_bwd_precision):
# "fast", the backward kernels, or "accurate", the VJP of the blockwise
# functions (ops/blockwise.py) at the saved inputs; under "accurate" the eta
# != 0 forwards also stay off the generated route (the JAX package's
# pallas_reductions._BWD_PRECISION)
_BWD_PRECISION = {"mode": "fast"}


def accurate_bwd() -> bool:
    return _BWD_PRECISION["mode"] == "accurate"


# the any-eta forward (csrc/direct.cuh): warps a block (kDirectWarps), rows a
# block of it (2 a thread: SelfEta), and the blocks an SM holds at least
# (kDirectMinBlocks), one wave of which the split of the column axis fills
# (direct_chunk_cols)
DIRECT_WARPS = 4
DIRECT_ROWS = 64
DIRECT_BLOCKS_PER_SM = 4

_bound = False
# the scratch of the kernels that cut their column axis into chunks (the
# direct forwards here, in rhs_cross.py and rhs_ext.py, and rhs_ext.py's
# dq/dp) per device: the chunk partials and the row blocks' tickets (int32,
# zero, and left zero by every launch), grown as needed; launches on one
# stream at a time share it
_workspace = {}


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

    The kernel takes each ordered pair apart, on the tensor cores
    (``tensor_flops_per_pair``).
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

    The kernel takes each ordered pair apart, on the tensor cores.
    """
    return 34 * d + 3


def fwd_table(d: int) -> list:
    """The eta = 0 forward's payload columns, in the kernel's order, named as
    the JAX package's ``_fwd_col_table``: 1, q_e, p_f, q_e p_f (q the
    coordinates centred on the row block), 1 + 2d + d^2 columns."""
    names = [("one",)]
    names += [("q", e) for e in range(d)]
    names += [("p", f) for f in range(d)]
    names += [("qp", e, f) for e in range(d) for f in range(d)]
    return names


def bwd_table(d: int) -> list:
    """The backward's payload columns, named as ``_bwd_col_table`` (G the
    cotangent of v, H that of w): 45 columns at d = 2, 104 at d = 3."""
    names = fwd_table(d)
    names += [("G", f) for f in range(d)]
    names += [("qG", e, f) for e in range(d) for f in range(d)]
    names += [("Hp", e, f) for e in range(d) for f in range(d)]
    names += [("Hqp", f) for f in range(d)]
    names += [("qHp", a, e, f) for a in range(d) for e in range(d) for f in range(d)]
    names += [("qHqp", a, f) for a in range(d) for f in range(d)]
    names += [("qqp", a, b, f) for a in range(d) for b in range(a, d) for f in range(d)]
    names += [("qq", a, b) for a in range(d) for b in range(a, d)]
    names += [("pq",)]
    names += [("qpq", a) for a in range(d)]
    return names


def tensor_flops_per_pair(d: int, backward: bool) -> int:
    """Tensor-core work per ordered pair of the eta = 0 kernels' route: the
    table padded to n-tiles of 8 columns (16 forward at d = 2 and 3; 48 and
    104 backward), three TF32 products of two FLOP each (k_lo T_hi, k_hi
    T_lo, k_hi T_hi).  Beside them the route takes ksum's FP32-pipe work per
    pair (``ksum.fp32_ops_per_pair``: the distance, the exponent's scale and
    the split of k) and one exponential; the table's build (C entries per
    column and row block) and the epilogue (per row) are not counted."""
    ncols = len(bwd_table(d) if backward else fwd_table(d))
    return 3 * 2 * 8 * -(-ncols // 8)


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
# the rows' spatial order
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _spread(d: int, device: str) -> torch.Tensor:
    """spread[v]: the MORTON_BITS bits of v moved to bits 0, d, 2d, ..."""
    v = np.arange(1 << MORTON_BITS)
    out = np.zeros_like(v)
    for b in range(MORTON_BITS):
        out |= ((v >> b) & 1) << (b * d)
    return torch.as_tensor(out, device=device)


def morton_codes(q, m):
    """The Morton (Z-curve) code of each point, per frame: each masked-in
    coordinate quantized to MORTON_BITS bits inside the frame's masked
    bounding box, the bits interleaved; masked points get 2^(bits d), past
    every other code.  The codes of the JAX package's
    ``pallas_reductions._morton_order`` (the same float32 operations), per
    frame of q (..., M, D)."""
    d = q.shape[-1]
    top = 2.0 ** MORTON_BITS - 1.0
    on = m[..., None] > 0
    lo = torch.where(on, q, torch.inf).amin(-2, keepdim=True)
    hi = torch.where(on, q, -torch.inf).amax(-2, keepdim=True)
    scale = top / (hi - lo).clamp_min(1e-30)
    qq = ((q - lo) * scale).clamp(0.0, top).to(torch.int64)
    spread = _spread(d, str(q.device))
    code = spread[qq[..., 0]]
    for e in range(1, d):
        code = code | (spread[qq[..., e]] << e)
    return torch.where(m > 0, code, 1 << (MORTON_BITS * d))


@functools.lru_cache(maxsize=None)
def _device_sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _sms(q):
    return _device_sms(q.device) if q.device.type == "cuda" else _DEFAULT_SMS


def direct_chunk_cols(n: int, row_blocks: int, sms: int) -> int:
    """Columns a chunk of a direct forward kernel's column axis takes
    (csrc/direct.cuh), a multiple of the 32-column tile: the n columns of a
    frame cut into the most chunks whose blocks (row_blocks over all frames
    each) still run in one wave of DIRECT_BLOCKS_PER_SM blocks an SM, each
    chunk at least DIRECT_WARPS tiles (one a warp).  A second, part-filled
    wave would double the launch's time for a fraction more blocks.  Where
    the row blocks fill a wave already, one chunk: the split adds no
    block."""
    tiles = -(-n // 32)
    chunks = max(1, min(DIRECT_BLOCKS_PER_SM * sms // max(1, row_blocks),
                        tiles // DIRECT_WARPS))
    return -(-tiles // chunks) * 32


def _scratch(device, n_part, n_ticket):
    """The chunked kernels' scratch on ``device``: at least n_part floats of
    partials and n_ticket zero tickets."""
    part, ticket = _workspace.get(device, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if ticket is None or ticket.numel() < n_ticket:
        ticket = torch.zeros(n_ticket, dtype=torch.int32, device=device)
    _workspace[device] = (part, ticket)
    return part, ticket


def direct_plan(t, frames, m, n, rows, n_out):
    """(L, part, ticket) of one launch of a direct forward kernel on t's
    device over ``frames`` frames of m rows against n columns, ``rows`` rows
    a block and ``n_out`` outputs a row: the columns a chunk
    (direct_chunk_cols) and, with more than one chunk, the data pointers of
    the scratch (else None)."""
    row_blocks = frames * -(-m // rows)
    cols = direct_chunk_cols(n, row_blocks, _sms(t))
    chunks = -(-n // cols)
    if chunks == 1:
        return cols, None, None
    part, ticket = _scratch(t.device, row_blocks * chunks * rows * n_out, row_blocks)
    return cols, part.data_ptr(), ticket.data_ptr()


def block_rows(q, max_rows=256):
    """Slots of the rows' order a block of the eta = 0 kernels takes: 64 G
    for the most consumer warpgroups G (4, or max_rows / 64) whose blocks
    still cover every SM of q's card once, else 64 (short frames keep the
    SMs busy).  max_rows is 128 for the backward at d = 3, whose accumulators
    take twice the registers."""
    mm = q.shape[-2]
    frames = q.numel() // max(1, mm * q.shape[-1])
    sms = _sms(q)
    for rows in (256, 128):
        if rows <= max_rows and frames * -(-mm // rows) >= sms:
            return rows
    return 64


def row_order(q, m, sigma, pad_budget=ORDER_PAD_BUDGET):
    """The eta = 0 kernels' row order, per frame: the rows sorted by Morton
    code (stable, so ties keep their index order, as jnp.argsort), then cut
    into runs wherever two consecutive (unmasked) points lie farther apart
    than tau, each run padded with empty slots (-1) to a multiple of the
    kernels' block (block_rows).  A Z-curve jumps between distant parts of a
    thin cloud, and a block of rows that straddles a jump has a centroid far
    from its rows, which the table's recombination amplifies as (R /
    sigma)^2; cut there, every block lies in one run.  tau is the smallest of
    sigma (1, 2, 4, 8) whose padding stays within pad_budget of the
    rows and adds no wave of blocks on the card, else no cut.  int32 (...,
    Mo), Mo >= M the longest frame's slots."""
    orders["row_order"] += 1
    mm, d = q.shape[-2], q.shape[-1]
    run = block_rows(q)
    qf, mf = q.reshape(-1, mm, d), m.reshape(-1, mm)
    # slots a frame may take: the budget, and the blocks of the waves the
    # unpadded rows fill already
    sms, nb = _sms(q), qf.shape[0]
    waves = -(-nb * -(-mm // run) // sms)
    cap = min(mm * (1 + pad_budget), waves * sms // nb * run)
    idx = torch.argsort(morton_codes(qf, mf), dim=-1, stable=True)
    qs = torch.gather(qf, 1, idx[..., None].expand(-1, -1, d))
    # masked points sort last: they open no run
    gap = (qs[:, 1:] - qs[:, :-1]).norm(dim=-1) * (torch.gather(mf, 1, idx[:, 1:]) > 0)
    pos = torch.arange(mm, device=q.device).expand_as(idx)
    slot = pos
    for tau in (sigma, 2 * sigma, 4 * sigma, 8 * sigma):
        cut = torch.nn.functional.pad(gap > tau, (1, 0))  # row i opens a run
        start = torch.where(cut, pos, 0).cummax(1).values  # its run's first row
        last = torch.nn.functional.pad(cut[:, 1:], (0, 1))  # row i closes a run
        pad = torch.where(last, (start - pos - 1) % run, 0)
        before = torch.nn.functional.pad(pad.cumsum(1), (1, 0))  # padding before row i's run
        cand = pos + torch.gather(before, 1, start)
        if int(cand[:, -1].max()) + 1 <= cap:
            slot = cand
            break
    out = torch.full((qf.shape[0], int(slot[:, -1].max()) + 1), -1, dtype=torch.int32,
                     device=q.device)
    out.scatter_(1, slot, idx.to(torch.int32))
    return out.reshape(*q.shape[:-2], out.shape[-1])

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
        lib.difficp_rhs_self_fwd_eta.argtypes = [vp] * 4 + [ci, ci] + [vp] * 5 + [
            ci, ci, ci, ci, cf, ci, cf, ci, vp]
        lib.difficp_rhs_self_fwd_eta.restype = ci
        lib.difficp_rhs_self_bwd.argtypes = [vp] * 7 + [ci, ci] + [vp] * 2 + [
            ci, ci, ci, cf, ci, vp]
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


class KernelLaunchError(RuntimeError):
    """A kernel of this package returned a CUDA error at its launch."""


# the errors that mean the card or a kernel failed, not the numbers: callers
# that skip a failed computation (the "auto" calibration's frame pairs) let
# these through
DEVICE_FAULTS = (KernelLaunchError, torch.cuda.OutOfMemoryError,
                 *((torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ()))


def _raise_on(err, name):
    if err != 0:
        raise KernelLaunchError(f"{name} kernel launch failed: CUDA error {err}")


def _order_for(q, m, order, sigma):
    """The rows' order for a launch: ``order`` checked, or computed."""
    if order is None:
        return row_order(q, m, sigma)
    if order.device != q.device or order.dtype != torch.int32:
        raise ValueError(f"order must be int32 on {q.device}, got {order.dtype} on "
                         f"{order.device}")
    if (tuple(order.shape[:-1]) != tuple(q.shape[:-2]) or order.shape[-1] < q.shape[-2]
            or not order.is_contiguous()):
        raise ValueError(f"order has shape {tuple(order.shape)}, expected "
                         f"{tuple(q.shape[:-2])} + (at least {q.shape[-2]},) (contiguous)")
    return order


def rhs_self_fwd(q, p, m, sigma, withlogdet, eta=0.0, order=None):
    """(v, w, per-row dcost partials), with the gradcomponent terms when eta
    != 0.  CPU tensors take the plain version; CUDA tensors launch the
    eta = 0 table kernel, with the rows in ``order`` (``row_order``, computed
    when not given), or the ETA instance when eta != 0."""
    if q.device.type == "cpu":
        with profiling.span("ops.rhs_self_fwd_eta" if eta != 0.0 else "ops.rhs_self_fwd"):
            return rhs_self_fwd_reference(q, p, m, sigma, withlogdet, eta)
    return launch_fwd(q, p, m, sigma, withlogdet, eta, eta != 0.0, order)


def launch_fwd(q, p, m, sigma, withlogdet, eta, use_eta, order=None):
    """One launch of a forward kernel on CUDA tensors: the ETA instance when
    ``use_eta`` (at any eta, 0 included), else the eta = 0 table kernel."""
    if q.device.type != "cuda":
        raise ValueError(f"rhs_self_fwd: unsupported device {q.device}")
    kernel = "rhs_self_fwd_eta" if use_eta else "rhs_self_fwd"
    call = profiling.span("ops." + kernel)
    nb, mm, d = _frames(q)
    _check("q", q, q.shape, q.device)
    _check("p", p, q.shape, q.device)
    _check("m", m, q.shape[:-1], q.device)
    if use_eta:
        order, rows = None, DIRECT_ROWS
        cols, part, ticket = direct_plan(q, nb, mm, mm, rows, 2 * d + 1)
    else:
        order, rows = _order_for(q, m, order, sigma), block_rows(q)
        cols, part, ticket = 0, None, None
    v = torch.empty_like(q)
    w = torch.empty_like(q)
    dc = torch.empty_like(m)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().difficp_rhs_self_fwd_eta(
        q.data_ptr(), p.data_ptr(), m.data_ptr(), None if order is None else order.data_ptr(),
        0 if order is None else order.shape[-1], rows, v.data_ptr(), w.data_ptr(),
        dc.data_ptr(), part, ticket, cols, nb, mm, d, 1.0 / (sigma * sigma),
        int(bool(withlogdet)), float(eta), int(bool(use_eta)), stream)
    _raise_on(err, kernel)
    launches[kernel] += 1
    call.end(rows=rows)
    return v, w, dc


def rhs_self_bwd(q, p, m, a, b, c, sigma, withlogdet, order=None):
    """(dq, dp) of the self RHS for cotangents a (of v), b (of w) and c (of
    each frame's dcost, shape q.shape[:-2]).  CPU tensors take the plain
    version; CUDA tensors launch the backward table kernel, with the rows in
    ``order`` (computed when not given)."""
    if q.device.type == "cpu":
        with profiling.span("ops.rhs_self_bwd"):
            return rhs_self_bwd_reference(q, p, m, a, b, c, sigma, withlogdet)
    if q.device.type != "cuda":
        raise ValueError(f"rhs_self_bwd: unsupported device {q.device}")
    call = profiling.span("ops.rhs_self_bwd")
    nb, mm, d = _frames(q)
    for name, t in (("q", q), ("p", p), ("a", a), ("b", b)):
        _check(name, t, q.shape, q.device)
    _check("m", m, q.shape[:-1], q.device)
    _check("c", c, q.shape[:-2], q.device)
    order = _order_for(q, m, order, sigma)
    rows = block_rows(q, 128 if d == 3 else 256)
    dq = torch.empty_like(q)
    dp = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().difficp_rhs_self_bwd(
        q.data_ptr(), p.data_ptr(), m.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), order.data_ptr(), order.shape[-1], rows,
        dq.data_ptr(), dp.data_ptr(), nb, mm, d,
        1.0 / (sigma * sigma), int(bool(withlogdet)), stream)
    _raise_on(err, "rhs_self_bwd")
    launches["rhs_self_bwd"] += 1
    call.end(rows=rows)
    return dq, dp


# ---------------------------------------------------------------------------
# autograd Functions
# ---------------------------------------------------------------------------

def eta_forward(q, p, m, sigma, withlogdet, eta):
    """(v, w, dcost per frame) at eta != 0, routed as ``make_rhs_self``: the
    any-eta kernel below ``_POLY_FWD_MIN_M`` points or under the "accurate"
    backward, else the generated forward on centered coordinates."""
    if q.shape[-2] < _POLY_FWD_MIN_M or accurate_bwd():
        v, w, dc = rhs_self_fwd(q, p, m, sigma, withlogdet, eta)
        return v, w, dc.sum(-1)
    from difficp_torch.ops import ksum, pair_poly

    v, gq, dc = pair_poly.rhs_self_fwd_poly(q - ksum.mm_center(q, m), p, m, sigma, eta,
                                            withlogdet)
    return v, -gq, dc


class RHSSelf(torch.autograd.Function):
    """(v, w, dcost) = fused self RHS.  At eta = 0 the backward recomputes k
    in the backward kernel from the saved q, p and m, both kernels with the
    rows in ``order`` (``row_order``; computed by each kernel wrapper when
    None).  At eta != 0 the forward is ``eta_forward`` and the backward the
    generated kernel-sums on centered coordinates.  Under the "accurate"
    backward (``_BWD_PRECISION``) the backward is the VJP of
    ``blockwise.lddmm_rhs_self`` at any eta."""

    @staticmethod
    def forward(ctx, q, p, m, sigma, withlogdet, eta=0.0, order=None):
        q, p, m = q.contiguous(), p.contiguous(), m.contiguous()
        ctx.save_for_backward(q, p, m)
        ctx.sigma, ctx.withlogdet, ctx.eta, ctx.order = sigma, withlogdet, eta, order
        if eta != 0.0:
            return eta_forward(q, p, m, sigma, withlogdet, eta)
        v, w, dc = rhs_self_fwd(q, p, m, sigma, withlogdet, order=order)
        return v, w, dc.sum(-1)

    @staticmethod
    def backward(ctx, gv, gw, gc):
        q, p, m = ctx.saved_tensors
        gv = torch.zeros_like(q) if gv is None else gv.contiguous()
        gw = torch.zeros_like(q) if gw is None else gw.contiguous()
        gc = (torch.zeros(q.shape[:-2], dtype=q.dtype, device=q.device)
              if gc is None or not ctx.withlogdet else gc.contiguous())
        if accurate_bwd():
            from difficp_torch.ops import blockwise

            def fn(q_, p_):
                return blockwise.lddmm_rhs_self(q_, p_, ctx.sigma, ctx.eta, ctx.withlogdet, m)

            dq, dp = blockwise.vjp(fn, (q, p), (gv, gw, gc), ctx.needs_input_grad[:2])
        elif ctx.eta != 0.0:
            from difficp_torch.ops import ksum, pair_poly

            qc = q - ksum.mm_center(q, m)
            dq, dp = pair_poly.rhs_self_bwd_poly(qc, p, m, gv, gw, gc, ctx.sigma,
                                                 ctx.eta)
        else:
            dq, dp = rhs_self_bwd(q, p, m, gv, gw, gc, ctx.sigma, ctx.withlogdet,
                                  ctx.order)
        return dq, dp, None, None, None, None, None


class Hamiltonian(torch.autograd.Function):
    """H = 1/2 sum_ij m_i m_j k_ij p_i.p_j at eta = 0, per frame, from one
    forward-kernel call: H = 1/2 sum_i p_i.v_i.  The gradient is an epilogue
    on the saved outputs: dH/dq = -w, dH/dp = v (the JAX package's
    ``pallas_ksum.make_hamiltonian``); the rows in ``order`` as for
    ``RHSSelf``."""

    @staticmethod
    def forward(ctx, q, p, m, sigma, order=None):
        q, p, m = q.contiguous(), p.contiguous(), m.contiguous()
        v, w, _ = rhs_self_fwd(q, p, m, sigma, False, order=order)
        ctx.save_for_backward(v, w)
        return 0.5 * (p * v).sum((-2, -1))

    @staticmethod
    def backward(ctx, g):
        v, w = ctx.saved_tensors
        g = g[..., None, None]
        return -g * w, g * v, None, None, None


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


def lddmm_rhs_self(q, p, sigma, withlogdet, mask_q=None, eta=0.0, order=None):
    """Kernel-route fused RHS: (vq, -Gq, dcost) with autograd; at eta = 0
    the rows in ``order`` (``row_order``, computed per kernel call when
    None)."""
    m = _ones_mask(q) if mask_q is None else mask_q
    return RHSSelf.apply(q, p, m, float(sigma), bool(withlogdet), float(eta), order)


def hamiltonian(q, p, sigma, mask_q=None, eta=0.0, order=None):
    """Kernel-route Hamiltonian, with autograd; ``order`` as for
    ``lddmm_rhs_self``."""
    m = _ones_mask(q) if mask_q is None else mask_q
    if eta != 0.0:
        return HamiltonianEta.apply(q, p, m, float(sigma), float(eta))
    return Hamiltonian.apply(q, p, m, float(sigma), order)
