"""The direct forward kernels of difficp_torch/csrc/ (direct.cuh, with the
any-eta self/cross forward of rhs_self.cu and the ext forward of
rhs_ext.cu): a float32 emulation of their arithmetic against the JAX
package's Pallas kernels they replace, run as tests/test_pallas.py runs them
(interpret mode on the CPU), and the split of their column axis
(ops/rhs_self.py direct_chunk_cols).

The emulation takes the kernels' steps in float32: coordinates prescaled by
s = sqrt(u log2(e) / 2), so that k = 2^(-|d'|^2); the column mask folded
into the payload (p~ = m p) and k~ = k m for the other sums; the self
kernel's w sums as one sum of t d'; each tile of 32 columns summed apart,
the tiles of a chunk taken by four warps in turn, the warps' totals summed in
warp order, the per-row epilogue on each chunk's sums and the chunks'
outputs summed in chunk order, with the chunks direct_chunk_cols gives the
launch.  A thread's R rows share column records only: each row's sums are
those of the emulation.  The CUDA kernels themselves are held against the
plain versions on the card (tests/test_torch_cuda.py and chip_smoke.py).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difficp_tpu.ops.pallas_reductions as PR
from difficp_torch.ops import rhs_ext as RE
from difficp_torch.ops import rhs_self as RS

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "difficp_torch" / "csrc"
SIG = 0.2
ETA = 1.0 / 200.0
# an H100 SXM's SMs, as the wrappers size the split for
SMS = 132
LOG2E = 1.4426950408889634
# the emulation against the Pallas kernels and the float64 plain versions:
# float32 sums over a few hundred terms in other orders, relative to the
# largest output (chip_smoke.py's TOL_FWD)
TOL = 1e-5


def _f32(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def _scale(u):
    """s, u / s, u / s^2 as the kernels form them in float32."""
    u = _f32(u)
    s = torch.sqrt(_f32(0.5) * u * _f32(LOG2E))
    us = u / s
    return s, us, us / s


def _chunked(terms, n, row_blocks):
    """The kernels' summation order of per-pair terms (..., rows, n, S):
    tiles of 32 columns summed apart, the tiles of a chunk taken by
    RS.DIRECT_WARPS warps in turn, warps summed in order; one (..., rows, S)
    sum per chunk, in chunk order (a list)."""
    cols = RS.direct_chunk_cols(n, row_blocks, SMS)
    out = []
    for lo in range(0, n, cols):
        chunk = terms[..., lo:min(n, lo + cols), :]
        width = chunk.shape[-2]
        tiles = -(-width // 32)
        pad = tiles * 32 - width
        chunk = torch.nn.functional.pad(chunk, (0, 0, 0, pad))
        per_tile = chunk.reshape(*chunk.shape[:-2], tiles, 32, chunk.shape[-1]).sum(-2)
        warps = [torch.zeros_like(per_tile[..., 0, :]) for _ in range(RS.DIRECT_WARPS)]
        for t in range(tiles):
            warps[t % RS.DIRECT_WARPS] = warps[t % RS.DIRECT_WARPS] + per_tile[..., t, :]
        total = warps[0]
        for w in warps[1:]:
            total = total + w
        out.append(total)
    return out


def self_scheme(q, p, m, qc, pc, mc, sigma, withlogdet, eta):
    """The any-eta self/cross kernel's arithmetic in float32: (v, w, per-row
    dc) of rows (q, p, m) against columns (qc, pc, mc), one frame (M, D)."""
    mm, d = q.shape
    u = 1.0 / (sigma * sigma)
    s, us, us2 = _scale(u)
    eu = _f32(eta * u)
    alpha, beta = us, _f32(eta) * _f32(u) * us2
    gamma = -beta * _f32(eta) * _f32(u) / s
    x, qs, ps = s * q, s * qc, mc[:, None] * pc
    ap, bp = alpha * p, beta * p
    dd = x[:, None, :] - qs[None, :, :]                       # (M, N, D)
    r2n = -(dd * dd).sum(-1)
    k = torch.exp2(r2n)
    km = k * mc[None, :]
    g = (ps[None, :, :] * (ap[:, None, :] - beta * dd)).sum(-1)
    b = (dd * bp[:, None, :]).sum(-1) - gamma * r2n
    t = k * g + km * b
    terms = torch.cat([k[..., None] * ps[None], t[..., None] * dd, km[..., None],
                       km[..., None] * dd, (km * r2n)[..., None]], -1)
    v = w = dc = 0.0
    cv = eu / s
    cw = eu * cv * (d + 2)
    for S in _chunked(terms, qc.shape[0], -(-mm // RS.DIRECT_ROWS)):
        V, T, K = S[:, :d], S[:, d:2 * d], S[:, 2 * d:2 * d + 1]
        KD, KR2 = S[:, 2 * d + 1:3 * d + 1], S[:, 3 * d + 1]
        mi = m[:, None]
        kc = p * K - V
        v = v + mi * (V + cv * KD)
        w = w + mi * (T - eu * kc + cw * KD)
        if withlogdet:
            dc = dc + m * (eu * (-us2 * KR2 - d * K[:, 0]) - us * (p * KD).sum(-1))
    if not withlogdet:
        dc = torch.zeros_like(m)
    return v, w, dc


def ext_scheme(x, mx, q, p, mq, sigma, withlogdet, eta):
    """The ext forward kernel's arithmetic in float32: (vx, per-row dc) of
    data rows (x, mx) against the support (q, p, mq), one frame."""
    n, d = x.shape
    u = 1.0 / (sigma * sigma)
    s, us, us2 = _scale(u)
    xs, qs, ps = s * x, s * q, mq[:, None] * p
    dd = xs[:, None, :] - qs[None, :, :]
    r2n = -(dd * dd).sum(-1)
    k = torch.exp2(r2n)
    km = k * mq[None, :]
    pd = (ps[None] * dd).sum(-1)
    terms = torch.cat([k[..., None] * ps[None], (k * pd)[..., None], km[..., None],
                       (km * r2n)[..., None], km[..., None] * dd], -1)
    vx = dc = 0.0
    me = mx * _f32(eta * u)
    for S in _chunked(terms, q.shape[0], -(-n // RE.FWD_ROWS)):
        V, DC, K, KR2, KD = S[:, :d], S[:, d], S[:, d + 1], S[:, d + 2], S[:, d + 3:]
        out_v = mx[:, None] * V
        out_dc = us * mx * DC
        if eta != 0.0:
            out_v = out_v + (me / s)[:, None] * KD
            out_dc = out_dc + me * (-us2 * KR2 - d * K)
        vx = vx + out_v
        dc = dc + (out_dc if withlogdet else 0.0)
    if not withlogdet:
        dc = torch.zeros_like(mx)
    return vx, dc


def _cloud(n, d, rng, shift=0.0):
    """A box cloud of side 1 (R / sigma = 5) with momenta and a ragged mask
    with a padded tail."""
    q = rng.uniform(size=(n, d)).astype(np.float32) + np.float32(shift)
    p = (0.05 * rng.normal(size=(n, d))).astype(np.float32)
    m = (rng.uniform(size=n) > 0.1).astype(np.float32)
    m[-5:] = 0.0
    return q, p, m


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300))


def _dc_rel(dc_sum, ref_rows):
    """A frame's dcost against the sum of its terms' magnitudes (the sum
    cancels)."""
    ref_rows = np.asarray(ref_rows, np.float64)
    return abs(float(dc_sum) - ref_rows.sum()) / max(np.abs(ref_rows).sum(), 1e-300)


@pytest.mark.parametrize("eta", [0.0, ETA])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_self_scheme_matches_pallas_streaming_kernel(kind, d, eta):
    """The any-eta self/cross kernel's arithmetic against _rhs_self_fwd_pallas
    (TPU row #9, the self entry) or _rhs_cross_fwd_stream (row #11: 300 rows
    against 500 other columns), both on _rhs_self_kernel in interpret mode,
    withlogdet on and off: v, w and each frame's dcost within TOL of the
    Pallas kernel's and of the float64 plain version.  The columns take two
    (self) or four (cross) chunks here (the split on a 132-SM card)."""
    rng = np.random.default_rng(3 * d + int(eta > 0))
    q, p, m = _cloud(300, d, rng)
    qc, pc, mc = (q, p, m) if kind == "self" else _cloud(500, d, rng, shift=0.1)
    assert -(-qc.shape[0] // RS.direct_chunk_cols(qc.shape[0], 5, SMS)) > 1
    for wl in (True, False):
        v, w, dc = self_scheme(*map(_f32, (q, p, m, qc, pc, mc)), SIG, wl, eta)
        rv, rw, rdc = RS.fwd_reference(*(torch.as_tensor(a, dtype=torch.float64)
                                         for a in (q, p, m, qc, pc, mc)), SIG, wl, eta)
        js = [jnp.asarray(a) for a in (q, p, m)]
        if kind == "self":
            jv, jgq, jdc = PR._rhs_self_fwd_pallas(*js, SIG, eta, wl)
        else:
            jv, jgq, jdc = PR._rhs_cross_fwd_stream(*js, *(jnp.asarray(a) for a in (qc, pc, mc)),
                                                   SIG, eta, wl)
        for got, jax_ref, ref in ((v, jv, rv), (w, -np.asarray(jgq), rw)):
            assert _rel(got, jax_ref) <= TOL
            assert _rel(got, ref) <= TOL
        if wl:
            assert _dc_rel(dc.sum(), rdc) <= TOL
            assert _dc_rel(jdc, rdc) <= TOL
        else:
            assert float(dc.abs().max()) == 0.0


@pytest.mark.parametrize("eta", [0.0, ETA])
@pytest.mark.parametrize("d", [2, 3])
def test_ext_scheme_matches_pallas_vx_kernels(d, eta, monkeypatch):
    """The ext forward kernel's arithmetic against _vx_fwd_pallas (TPU row #6:
    _vx_mm_kernel at eta = 0, its payload product in the package's
    full-float32 mode "highest", as test_torch_rhs_ext's table test runs it;
    _vx_kernel at eta != 0) in interpret mode, 300 data rows against 500
    support points (four chunks of 128), withlogdet on and off, masked data
    and support: vx and the frame's dcost within TOL of the Pallas kernel's
    and of the float64 plain version."""
    monkeypatch.setattr(PR, "_MM_MODE", "highest")
    rng = np.random.default_rng(7 * d + int(eta > 0))
    x, _, mx = _cloud(300, d, rng)
    q, p, mq = _cloud(500, d, rng, shift=0.05)
    assert -(-500 // RS.direct_chunk_cols(500, 3, SMS)) > 1
    for wl in (True, False):
        vx, dc = ext_scheme(*map(_f32, (x, mx, q, p, mq)), SIG, wl, eta)
        rvx, rdc = RE.rhs_ext_fwd_reference(*(torch.as_tensor(a, dtype=torch.float64)
                                              for a in (x, mx, q, p, mq)), SIG, wl, eta)
        jvx, jdc = PR._vx_fwd_pallas(*(jnp.asarray(a) for a in (x, mx, q, p, mq)), SIG, eta, wl)
        assert _rel(vx, jvx) <= TOL
        assert _rel(vx, rvx) <= TOL
        if wl:
            assert _dc_rel(dc.sum(), rdc) <= TOL
            assert _dc_rel(jdc, rdc) <= TOL
        else:
            assert float(dc.abs().max()) == 0.0


def _partition(n, cols):
    return [(lo, min(n, lo + cols)) for lo in range(0, n, cols)]


@pytest.mark.parametrize("n,row_blocks", [(1, 1), (31, 1), (33, 2), (380, 60), (380, 5120),
                                          (8192, 128), (65536, 30), (65536, 3), (5003, 7),
                                          (100000, 1)])
def test_direct_chunks_cover_every_column_once(n, row_blocks):
    """The chunks of direct_chunk_cols: whole 32-column tiles, every column
    in exactly one chunk, in order, none empty, at least DIRECT_WARPS tiles
    each where there is more than one, and at most 65,535 of them."""
    cols = RS.direct_chunk_cols(n, row_blocks, SMS)
    assert cols % 32 == 0 and cols > 0
    parts = _partition(n, cols)
    covered = [j for lo, hi in parts for j in range(lo, hi)]
    assert covered == list(range(n))
    assert all(hi > lo for lo, hi in parts)
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    assert len(parts) == 1 or cols >= 32 * RS.DIRECT_WARPS
    assert len(parts) <= 65535


def test_direct_split_adds_no_block_at_the_grid_main_shape():
    """At the grid main path's ext forward (10 frames of 65,536 data rows in
    blocks of 128 against the grid support's ~380 points) the row blocks give
    every SM more than DIRECT_BLOCKS_PER_SM blocks already: one chunk, so the
    launch has the row blocks only, no added wave."""
    row_blocks = 10 * -(-65536 // RE.FWD_ROWS)
    assert row_blocks >= RS.DIRECT_BLOCKS_PER_SM * SMS
    for m in (342, 380, 420):
        assert RS.direct_chunk_cols(m, row_blocks, SMS) >= m


@pytest.mark.parametrize("label,frames,rows,cols,block", [
    ("dense eta and ring eta, 8,192^2", 1, 8192, 8192, RS.DIRECT_ROWS),
    ("grid eta self, 10 x 380^2", 10, 380, 380, RS.DIRECT_ROWS),
    ("v_field, 10 x 380 x 65,536", 10, 380, 65536, RE.FWD_ROWS),
    ("one frame of 380 against 65,536", 1, 380, 65536, RE.FWD_ROWS),
])
def test_direct_split_reaches_every_sm(label, frames, rows, cols, block):
    """The main paths' launches whose rows alone would leave SMs idle (the
    kernels before ran 64, 30 and 30 blocks there) run at least one block on
    every SM of a 132-SM card, and no more than one wave of
    DIRECT_BLOCKS_PER_SM blocks an SM."""
    row_blocks = frames * -(-rows // block)
    chunks = -(-cols // RS.direct_chunk_cols(cols, row_blocks, SMS))
    blocks = row_blocks * chunks
    assert chunks > 1 and blocks >= SMS, (label, blocks)
    assert blocks <= RS.DIRECT_BLOCKS_PER_SM * SMS, (label, blocks)


def test_python_constants_match_the_kernels():
    """The wrappers size the blocks, the split and the scratch with what the
    CUDA sources compile: 4 warps a block, at least 4 blocks an SM, 2 rows a
    thread for the any-eta self forward and 4 for the ext forward."""
    direct = (CSRC / "direct.cuh").read_text()
    warps = int(re.search(r"constexpr int kDirectWarps = (\d+);", direct).group(1))
    blocks = int(re.search(r"constexpr int kDirectMinBlocks = (\d+);", direct).group(1))
    assert warps == RS.DIRECT_WARPS and blocks == RS.DIRECT_BLOCKS_PER_SM
    self_rows = re.search(r"struct SelfEta \{\n\s*static constexpr int kD = D, kRows = (\d+),",
                          (CSRC / "rhs_self.cu").read_text())
    ext_rows = re.search(r"struct ExtFwd \{\n\s*static constexpr int kD = D, kRows = (\d+),",
                         (CSRC / "rhs_ext.cu").read_text())
    assert 32 * int(self_rows.group(1)) == RS.DIRECT_ROWS
    assert 32 * int(ext_rows.group(1)) == RE.FWD_ROWS


def test_prescaled_exponent_is_the_gaussian():
    """2^(-|s d|^2) with s = sqrt(u log2(e) / 2) is exp(-u |d|^2 / 2): the
    prescaled exponent the kernels take, in float64."""
    u = 1.0 / SIG ** 2
    s = math.sqrt(0.5 * u * LOG2E)
    for r in (0.0, 0.05, 0.3, 0.9):
        assert math.isclose(2.0 ** (-(s * r) ** 2), math.exp(-0.5 * u * r * r), rel_tol=1e-12)
