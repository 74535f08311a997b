"""Top-2 smallest squared distances (the KeOps Kmin(2) role), with a
hand-written CUDA kernel.

For every x_i: (m1_i, m2_i), the two smallest |x_i - y_j|^2 over the y_j with
mask_j > 0, as a multiset (two equal minima give m2 = m1), +inf where fewer
remain.  ``exclude_self`` skips the pair j == i (x is y), which makes m1 the
nearest-neighbour distance of a set.  The kernel (``csrc/kmin2.cu``) replaces
the TPU kernel ``_kmin2_kernel`` (via ``kmin2_pallas``) of
``difficp_tpu/ops/pallas_reductions.py``; what bounds it and how its design
answers it is noted in the source and in ``ops_per_pair``.

Beside it is its plain PyTorch version, chunked over rows.  A tensor on the
CPU takes the plain version; a CUDA tensor launches the kernel or the call
raises.  ``launches`` counts kernel launches.

Shapes: x (..., N, D), y (..., M, D) with D in {2, 3}, mask_y (..., M); all
leading dimensions are frames (one grid row of blocks each), so a batch of
trajectories is one launch.
"""

from __future__ import annotations

import ctypes

import torch

from difficp_torch.ops import _build
from difficp_torch.ops.rhs_self import _check, _chunk_rows, _frames, _ones_mask, _raise_on

# kernel launches since the last reset (reset by assigning 0)
launches = {"kmin2": 0}

# the kernel's block (csrc/kmin2.cu): threads a block (kK2Threads), rows a
# thread (kK2Rows), so rows a block and columns a staged tile (kK2Tile)
THREADS = 128
ROWS_PER_THREAD = 4
TILE = THREADS * ROWS_PER_THREAD

_bound = False


def ops_per_pair(d: int) -> int:
    """The least FP32 work per (x_i, y_j) pair, for its bound (an FMA counts
    as two):

        delta = x_i - y_j                           d
        r2 = |delta|^2                              2d - 1
        m2 = max(m1, min(m2, r2)); m1 = min(m1, r2) 3

    The expanded form |y_j|^2 - 2 x_i.y_j (|x_i|^2 left out of the ranking)
    would take 2d, but it loses the small distances the coverage check reads
    to cancellation, so the count keeps the difference form.

    What bounds the kernel is issue slots.  At d = 2 a pair is 4 FP32
    instructions (FADD, FADD, FMUL, FFMA) and, one column at a time, 3
    FMNMX: 7 issue slots for its 8 operations, so at best 4/7 of the FP32
    peak.  On sm_90 the min/max issue at half the rate of FADD (2.07 FMNMX,
    IMNMX or VIMNMX3 against 4.00 FADD warp instructions an SM cycle alone,
    the SM's issue limit; tools/kmin2_ab.py sass on an H100, every
    instruction of each stream's loop counted), but on a pipe of their own:
    the 4:3 mix interleaved issues at 3.92, FP32 beside integer min/max at
    4.00, grouped (as ptxas orders much of the pair loop) at 3.29.  The
    kernel takes two columns a step on the distances' bits as int32, with
    Hopper's three-input integer min (VIMNMX3): 2.5 min/max a pair, 6.69
    issue slots with the record loads and the loop, which it issues at 3.18
    of the SM's 4 warp instructions a cycle (kmin2_ab clock: the SM clock
    measured while it runs), near the grouped mix's rate: ptxas groups a
    step's integer min/max into runs of up to 20.
    """
    return 3 * d + 2


def kmin2_reference(x, y, mask_y, exclude_self=False):
    """Plain version of the kernel: (m1, m2)."""
    n = x.shape[-2]
    chunk = _chunk_rows(y.shape[-2], y.shape[-1])
    m1s, m2s = [], []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        d2 = ((x[..., lo:hi, None, :] - y[..., None, :, :]) ** 2).sum(-1)
        d2 = torch.where(mask_y[..., None, :] > 0, d2, torch.inf)
        if exclude_self:
            rows = torch.arange(hi - lo, device=x.device)
            d2[..., rows, rows + lo] = torch.inf
        m1, pos = d2.min(-1)
        # knock out exactly one instance of the minimum (tie-robust)
        m2 = d2.scatter(-1, pos[..., None], torch.inf).min(-1).values
        m1s.append(m1)
        m2s.append(m2)
    return torch.cat(m1s, -1), torch.cat(m2s, -1)


def _lib():
    global _bound
    lib = _build.library()
    if not _bound:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.difficp_kmin2.argtypes = [vp] * 5 + [ci] * 6 + [vp]
        lib.difficp_kmin2.restype = ci
        _bound = True
    return lib


def kmin2(x, y, mask_y=None, exclude_self=False):
    """(m1, m2) of |x_i - y_j|^2 over masked y.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if mask_y is None:
        mask_y = _ones_mask(y)
    if exclude_self and x.shape != y.shape:
        raise ValueError("exclude_self needs x and y of one shape (x is y)")
    if x.device.type == "cpu":
        return kmin2_reference(x, y, mask_y, exclude_self)
    if x.device.type != "cuda":
        raise ValueError(f"kmin2: unsupported device {x.device}")
    nb, n, d = _frames(x)
    _, m, dy = _frames(y)
    if tuple(x.shape[:-2]) != tuple(y.shape[:-2]) or d != dy:
        raise ValueError(f"kmin2: x {tuple(x.shape)} and y {tuple(y.shape)} "
                         "differ in frames or dimension")
    _check("x", x, x.shape, x.device)
    _check("y", y, y.shape, x.device)
    _check("mask_y", mask_y, y.shape[:-1], x.device)
    m1 = torch.empty(x.shape[:-1], dtype=x.dtype, device=x.device)
    m2 = torch.empty_like(m1)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().difficp_kmin2(
        x.data_ptr(), y.data_ptr(), mask_y.data_ptr(), m1.data_ptr(), m2.data_ptr(),
        nb, n, m, d, TILE, int(bool(exclude_self)), stream)
    _raise_on(err, "kmin2")
    launches["kmin2"] += 1
    return m1, m2
