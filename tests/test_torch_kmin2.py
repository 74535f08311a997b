"""The port's top-2 minimum op (difficp_torch/ops/kmin2.py) against the JAX
package: kmin2_pallas as the JAX package runs it on the CPU (interpret mode)
and the dense min_sqdist / second_min_sqdist, with exact ties; and the
backend routes that take kmin2 above the dense pair limit.

On the CPU the op takes the kernel's plain PyTorch version; the CUDA kernel is
checked against it on the card (tests/test_torch_cuda.py, chip_smoke.py).
Here ``kernel_scheme`` emulates the kernel's tile loop (csrc/kmin2.cu) in
float32: blocks of THREADS R rows, tiles of as many columns staged with NaN
coordinates where masked or past the frame, each tile's columns taken to
a whole step of the pair loop, the pair j == i replaced by NaN in the
block's own tile only, the NaN-ignoring update m2 = max(m1, min(m2, r)),
m1 = min(m1, r) (torch.fmin / fmax: the other operand of a NaN, as min.f32
/ max.f32) there and its two-column form on the distances' bits as int32
everywhere else; it is held against the plain version.
"""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from difficp_tpu.ops import reductions as R
from difficp_torch.ops import backend as TB
from difficp_torch.ops import kmin2 as K2

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parents[1] / "difficp_torch" / "csrc"
# columns a step of the kernel's pair loop
UNROLL = int(re.search(r"constexpr int kK2Unroll = (\d+);",
                       (CSRC / "kmin2.cu").read_text()).group(1))


def _push(a1, a2, r):
    """The kernel's update, NaN-ignoring: (m1, m2) after one column."""
    return torch.fmin(a1, r), torch.fmax(a1, torch.fmin(a2, r))


def _push2(a1, a2, r, s):
    """The kernel's two-column update on the distances' bits as int32:
    m1 = min3(m1, r, s), m2 = min3(max(m1, min(r, s)), m2, max(r, s))."""
    b1, b2, ri, si = (t.contiguous().view(torch.int32) for t in (a1, a2, r, s))
    lo, hi = torch.minimum(ri, si), torch.maximum(ri, si)
    n2 = torch.minimum(torch.minimum(torch.maximum(b1, lo), b2), hi)
    n1 = torch.minimum(torch.minimum(b1, ri), si)
    return n1.view(torch.float32), n2.view(torch.float32)


def _sqdist(x, c):
    """|x - c|^2 as the kernel forms it in float32: dx * dx, then one fma a
    further coordinate (a product of two float32 numbers is exact in float64,
    the sum rounded once more)."""
    dd = x - c
    r = dd[..., 0] * dd[..., 0]
    for e in range(1, x.shape[-1]):
        r = (dd[..., e].double() ** 2 + r.double()).float()
    return r


def kernel_scheme(x, y, my, exclude_self=False, threads=K2.THREADS,
                  rows=K2.ROWS_PER_THREAD, unroll=None):
    """(m1, m2) by the kernel's steps: ``threads`` x ``rows`` rows a block
    and columns a tile, the pair loop taking ``unroll`` columns a step, two
    at a time in the integer domain (the block's own tile with
    exclude_self: one at a time)."""
    unroll = unroll or UNROLL
    tile = threads * rows
    lead = x.shape[:-2]
    n, d = x.shape[-2:]
    m = y.shape[-2]
    xf, yf, mf = x.reshape(-1, n, d), y.reshape(-1, m, d), my.reshape(-1, m)
    assert tile % unroll == 0 and unroll % 2 == 0
    out1 = torch.empty(xf.shape[:2])
    out2 = torch.empty(xf.shape[:2])
    for b in range(xf.shape[0]):
        for row0 in range(0, n, tile):
            # slot s = t + threads r of the block holds row row0 + s
            slots = row0 + torch.arange(tile)
            xr = torch.where((slots < n)[:, None], xf[b, slots.clamp(max=n - 1)],
                             torch.zeros(()))
            a1 = torch.full((tile,), torch.inf)
            a2 = torch.full((tile,), torch.inf)
            for base in range(0, m, tile):
                nn = min(tile, m - base)
                jj = torch.arange(tile)
                j = (base + jj).clamp(max=m - 1)
                ok = (jj < nn) & (mf[b, j] > 0)
                rec = torch.where(ok[:, None], yf[b, j], torch.full((), torch.nan))
                nu = -(-nn // unroll) * unroll
                if exclude_self and base == row0:
                    for c in range(nu):
                        r = _sqdist(xr, rec[c])
                        r[c] = torch.nan  # the block's own tile: slot c is column c
                        a1, a2 = _push(a1, a2, r)
                else:
                    for c in range(0, nu, 2):
                        a1, a2 = _push2(a1, a2, _sqdist(xr, rec[c]), _sqdist(xr, rec[c + 1]))
            keep = slots < n
            out1[b, slots[keep]] = a1[keep]
            out2[b, slots[keep]] = a2[keep]
    return out1.reshape(*lead, n), out2.reshape(*lead, n)


def _ragged(frames, m, seed, d=2):
    """Frames of y with a different count of valid columns each and the
    padding at the end (as utils/io.pad_frames pads a per-frame support),
    exact duplicates among the valid columns, the padded columns on a point
    of their own, off the lattice of the valid ones, and three rows x on that
    point."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 16, size=(frames, m, d)).astype(np.float32) / 8.0
    my = np.zeros((frames, m), np.float32)
    for f in range(frames):
        valid = [m, m - 3, 1, 0, m // 2, 2][f % 6]
        my[f, :valid] = 1.0
        y[f, valid:] = -1.0
        if valid:
            y[f, valid // 2: valid // 2 + min(5, valid // 4)] = y[f, :min(5, valid // 4)]
    x = rng.integers(0, 16, size=(frames, 37, d)).astype(np.float32) / 8.0
    x[:, :3] = -1.0  # on the padding's place
    return x, y, my


def _cloud(n, m, seed, dup=True, d=2):
    """x (n, d) and y (m, d) on a coarse lattice, so equal distances (ties)
    are common, with exact duplicates in y and a ragged y mask."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 12, size=(m, d)).astype(np.float32) / 8.0
    if dup:
        y[m // 2: m // 2 + 20] = y[:20]
    x = rng.integers(0, 12, size=(n, d)).astype(np.float32) / 8.0
    my = (rng.uniform(size=m) > 0.15).astype(np.float32)
    return x, y, my


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("d", [2, 3])
def test_plain_matches_pallas_interpret(exclude_self, d):
    """(m1, m2) against kmin2_pallas (ti=64, tj=128 so several tiles) in
    interpret mode, both modes, with ties and duplicates: equal up to one
    rounding of the squares (rtol 1e-6)."""
    from difficp_tpu.ops.pallas_reductions import kmin2_pallas

    x, y, my = _cloud(150, 300, seed=d, d=d)
    if exclude_self:
        x = y
    r1, r2 = kmin2_pallas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(my),
                          exclude_self=exclude_self, ti=64, tj=128)
    m1, m2 = K2.kmin2(*_t(x, y, my), exclude_self=exclude_self)
    np.testing.assert_allclose(m1.numpy(), np.asarray(r1), rtol=1e-6)
    np.testing.assert_allclose(m2.numpy(), np.asarray(r2), rtol=1e-6)
    assert np.any(m1.numpy() == m2.numpy())  # the ties were exercised


def test_plain_matches_dense_min_and_second_min():
    """m1 is the dense min_sqdist; with self-exclusion m1 is the dense
    second_min_sqdist (the nearest neighbour other than the point)."""
    x, y, my = _cloud(90, 210, seed=5)
    m1, _ = K2.kmin2(*_t(x, y, my))
    np.testing.assert_allclose(
        m1.numpy(), np.asarray(R.min_sqdist(jnp.asarray(x), jnp.asarray(y), jnp.asarray(my))),
        rtol=1e-6)
    n1, _ = K2.kmin2(*_t(y, y, my), exclude_self=True)
    np.testing.assert_allclose(
        n1.numpy(), np.asarray(R.second_min_sqdist(jnp.asarray(y), jnp.asarray(my))),
        rtol=1e-6)


def test_leading_frames_are_independent():
    """All leading axes are frames: a (2, 3) batch gives what each frame
    gives alone (the coverage pass sends (nt + 1, K) trajectories as one
    call); a fully masked frame gives +inf."""
    sets = [_cloud(40, 70, seed=s) for s in range(6)]
    x = torch.as_tensor(np.stack([s[0] for s in sets]).reshape(2, 3, 40, 2))
    y = torch.as_tensor(np.stack([s[1] for s in sets]).reshape(2, 3, 70, 2))
    my = torch.as_tensor(np.stack([s[2] for s in sets]).reshape(2, 3, 70))
    my[1, 2] = 0.0
    m1, m2 = K2.kmin2(x, y, my)
    assert m1.shape == (2, 3, 40)
    for a in range(2):
        for b in range(3):
            o1, o2 = K2.kmin2(x[a, b], y[a, b], my[a, b])
            np.testing.assert_array_equal(m1[a, b].numpy(), o1.numpy())
            np.testing.assert_array_equal(m2[a, b].numpy(), o2.numpy())
    assert torch.isinf(m1[1, 2]).all() and torch.isinf(m2[1, 2]).all()


def test_backend_routes_through_kmin2():
    """Forced onto the kernel route, min_sqdist, second_min_sqdist and
    check_coverage (with a mask broadcast over leading frames) give the
    dense route's answers."""
    x, y, my = _cloud(60, 130, seed=8, dup=False)
    xt, yt, myt = _t(x, y, my)
    xb = torch.stack([xt, xt + 0.05, xt - 0.3])           # (3, 60, 2)
    yb = torch.stack([yt, yt, yt + 0.1])                  # (3, 130, 2)
    mx = torch.ones(60)
    try:
        dense = (TB.min_sqdist(xt, yt, myt), TB.second_min_sqdist(yt, myt),
                 TB.check_coverage(xb, yb, 0.1, 1.0, mx, myt))
        TB.set_backend("kernel")
        kern = (TB.min_sqdist(xt, yt, myt), TB.second_min_sqdist(yt, myt),
                TB.check_coverage(xb, yb, 0.1, 1.0, mx, myt))
    finally:
        TB.set_backend(None)
    np.testing.assert_allclose(kern[0].numpy(), dense[0].numpy(), rtol=1e-6)
    np.testing.assert_allclose(kern[1].numpy(), dense[1].numpy(), rtol=1e-6)
    np.testing.assert_array_equal(kern[2].numpy(), dense[2].numpy())
    assert kern[2].dtype == torch.bool and 0 < int(kern[2].sum()) < kern[2].numel()


def test_ops_per_pair_and_bad_input():
    assert K2.ops_per_pair(2) == 8 and K2.ops_per_pair(3) == 11
    x, y, my = _t(*_cloud(10, 12, seed=1, dup=False))
    with pytest.raises(ValueError, match="exclude_self"):
        K2.kmin2(x, y, my, exclude_self=True)
    with pytest.raises(ValueError):
        K2.kmin2(x.to("meta"), y.to("meta"), my.to("meta"))


def test_update_ignoring_nan_equals_the_masked_update():
    """On numbers the kernel's update m2 = max(m1, min(m2, r)), m1 = min(m1,
    r) equals the rule m2 = min(m2, max(m1, r)); a NaN r leaves (m1, m2) as
    they were; the two-column integer update equals two one-column updates,
    bit for bit, with ties, +0, +inf and NaN (the positive quiet NaN a
    masked column stages, and the canonical NaN 0x7fffffff that float
    arithmetic on it gives on the card) among the columns."""
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 6, size=(4000, 40)).astype(np.float32)
    vals[rng.uniform(size=vals.shape) < 0.1] = np.inf
    vals[rng.uniform(size=vals.shape) < 0.2] = np.nan
    canonical = np.array([0x7FFFFFFF], np.int32).view(np.float32)[0]
    vals[:, 1::7] = np.where(np.isnan(vals[:, 1::7]), canonical, vals[:, 1::7])
    vals = torch.as_tensor(vals)
    a1 = a2 = b1 = b2 = c1 = c2 = torch.full((4000,), torch.inf)
    saw_inf = False
    for c in range(vals.shape[1]):
        r = vals[:, c]
        a1, a2 = _push(a1, a2, r)
        ok = ~torch.isnan(r)
        b1, b2 = (torch.where(ok, torch.minimum(b1, r), b1),
                  torch.where(ok, torch.minimum(b2, torch.maximum(b1, r)), b2))
        n1, n2 = _push(a1, a2, torch.full_like(r, torch.nan))
        assert torch.equal(n1, a1) and torch.equal(n2, a2)
        if c % 2:
            c1, c2 = _push2(c1, c2, vals[:, c - 1], r)
            assert torch.equal(c1, a1) and torch.equal(c2, a2)
            saw_inf |= bool(torch.isinf(c2).any())
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert bool((a1 == a2).any()) and saw_inf  # ties, and m2 still +inf


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("threads,rows,unroll", [(4, 2, 4), (4, 2, 2), (8, 2, UNROLL)])
def test_kernel_scheme_matches_plain(exclude_self, d, threads, rows, unroll):
    """The emulation of the kernel's tile loop (small blocks, so that rows
    span several blocks and the columns several tiles) against
    the plain version: ragged masks per frame with the padding at the end,
    ties and duplicates, rows on the padding's place; +inf where fewer than
    two valid columns remain; relative 1e-6 (one rounding of a square)."""
    x, y, my = _ragged(6, 45, seed=d, d=d)
    if exclude_self:
        x = y
    xt, yt, mt = (torch.as_tensor(a) for a in (x, y, my))
    got = kernel_scheme(xt, yt, mt, exclude_self, threads, rows, unroll)
    ref = K2.kmin2(xt, yt, mt, exclude_self)
    for g, r in zip(got, ref):
        assert torch.equal(torch.isinf(g), torch.isinf(r))
        fin = torch.isfinite(r)
        np.testing.assert_allclose(g[fin].numpy(), r[fin].numpy(), rtol=1e-6, atol=0)
    m1, m2 = got
    # each row's valid columns (without its own with exclude_self): fewer
    # than two give m2 = +inf (fewer than one m1), never a padded column's
    n_valid = mt.sum(-1, keepdim=True) - (mt if exclude_self else 0.0)
    n_valid = n_valid.expand_as(m1)
    assert bool(torch.isinf(m2[n_valid < 2]).all()) and bool((n_valid < 2).any())
    assert bool(torch.isinf(m1[n_valid < 1]).all())
    if not exclude_self:
        # the rows on a padded column's place: the padding (distance 0) never wins
        on_pad = m1[:, :3][mt[:, -1] == 0]
        assert bool((on_pad > 0).all())
    assert bool((m1 == m2).any())  # ties


def test_sentinel_never_wins_a_minimum():
    """A masked column at the row's own place (distance 0) and real columns
    far away: m1 and m2 are the real ones, in frames of one, two and three
    valid columns."""
    y = torch.tensor([[[0.0, 0.0], [5.0, 0.0], [0.0, 7.0], [0.0, 0.0]]] * 3)
    my = torch.tensor([[0.0, 1.0, 0.0, 0.0], [0.0, 1.0, 1.0, 0.0], [1.0, 1.0, 1.0, 0.0]])
    x = torch.zeros((3, 1, 2))
    for fn in (K2.kmin2, lambda *a: kernel_scheme(*a, threads=8, rows=2)):
        m1, m2 = fn(x, y, my)
        assert m1.flatten().tolist() == [25.0, 25.0, 0.0]
        assert m2.flatten().tolist() == [float("inf"), 49.0, 25.0]


def test_block_constants():
    """The wrapper's block constants are the kernel's."""
    src = (CSRC / "kmin2.cu").read_text()
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
             for name in ("kK2Warps", "kK2Rows")}
    assert K2.THREADS == 32 * const["kK2Warps"]
    assert K2.ROWS_PER_THREAD == const["kK2Rows"]
    assert K2.TILE == K2.THREADS * K2.ROWS_PER_THREAD
    assert K2.TILE % UNROLL == 0 and UNROLL % 2 == 0
