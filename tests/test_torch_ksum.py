"""The port's generic kernel-sum layer (difficp_torch/ops/ksum.py) against the
JAX package's pallas_ksum, run as tests/test_ksum.py runs it (Pallas in
interpret mode on the CPU): pairwise_ksum with masks, several frames and a
shared y; pairwise_ksum_sym; grad_kred_mm and the eta != 0 Hamiltonian,
values and gradients; mm_center.  Also the kernel's column chunks and y-axis
splits, the term lists of its bounds, and its 3xTF32 arithmetic emulated on
the CPU against float64.

On the CPU the ops take the kernel's plain PyTorch version; the CUDA kernel
itself is checked against that on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from difficp_tpu.ops import pallas_ksum as PK
from difficp_tpu.ops.pallas_reductions import _mm_center
from difficp_torch.ops import ksum as KS
from difficp_torch.ops import rhs_self as RS
from tf32_emulation import ksum_3xtf32 as _ksum_3xtf32
from tf32_emulation import tf32_rna as _tf32_rna

torch.set_num_threads(1)

SIG = 0.55


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def _close(x, ref, rtol):
    """|x - ref| <= rtol (|ref| + max|ref|): float32 sums in two orders."""
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(x, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _cloud(rng, n, d, shift):
    return (rng.normal(size=(n, d)) + shift).astype(np.float32)


@pytest.mark.parametrize("d", [2, 3])
def test_pairwise_ksum_matches_jax(d):
    """Three frames of 70 x 90 points, ragged y masks, 5 payload columns;
    each frame against the JAX pairwise_ksum.  rtol 2e-4, the bound of
    tests/test_ksum.py::test_pairwise_ksum_matches_dense."""
    rng = np.random.default_rng(d)
    x = np.stack([_cloud(rng, 70, d, 3.0) for _ in range(3)])
    y = np.stack([_cloud(rng, 90, d, 3.0) for _ in range(3)])
    b = rng.normal(size=(3, 90, 5)).astype(np.float32)
    my = (rng.uniform(size=(3, 90)) > 0.25).astype(np.float32)
    got = KS.pairwise_ksum(*_t(x, y, b), SIG, torch.as_tensor(my))
    assert got.shape == (3, 70, 5)
    for k in range(3):
        want = PK.pairwise_ksum(jnp.asarray(x[k]), jnp.asarray(y[k]), jnp.asarray(b[k]),
                                SIG, jnp.asarray(my[k]))
        _close(got[k].numpy(), want, 2e-4)


def test_pairwise_ksum_shared_y_and_no_mask():
    """A y (and table) without a frame axis serves every frame of x; no mask
    means all ones.  rtol 2e-4 against the JAX pairwise_ksum."""
    rng = np.random.default_rng(11)
    x = np.stack([_cloud(rng, 40, 2, 0.0) for _ in range(2)])
    y = _cloud(rng, 50, 2, 0.0)
    b = rng.normal(size=(50, 3)).astype(np.float32)
    got = KS.pairwise_ksum(*_t(x, y, b), SIG)
    for k in range(2):
        want = PK.pairwise_ksum(jnp.asarray(x[k]), jnp.asarray(y), jnp.asarray(b), SIG)
        _close(got[k].numpy(), want, 2e-4)


def test_pairwise_ksum_sym_matches_jax():
    """The self kernel-sum over variable rows, the binary mask applied once
    per column: two frames of 120 points, degree-3 monomials.  rtol 2e-4."""
    rng = np.random.default_rng(5)
    d, m = 2, 120
    q = np.stack([_cloud(rng, m, d, 0.0) for _ in range(2)])
    p = (0.4 * rng.normal(size=(2, m, d))).astype(np.float32)
    mask = (rng.uniform(size=(2, m)) > 0.2).astype(np.float32)
    monos = ((), (0,), (2,), (0, 1), (1, 3), (0, 0, 2), (1, 2, 3))
    qt, pt, mt = _t(q, p, mask)
    rows = [qt[..., 0], qt[..., 1], pt[..., 0], pt[..., 1], mt]
    got = KS.pairwise_ksum_sym(rows, d, 4, monos, SIG)
    assert got.shape == (2, m, len(monos))
    for k in range(2):
        jrows = [jnp.asarray(r[k].numpy()) for r in rows]
        want = PK.pairwise_ksum_sym(jrows, d, 4, monos, SIG, t=128)
        _close(got[k].numpy(), want, 2e-4)


def test_mm_center_matches_jax():
    rng = np.random.default_rng(2)
    q = np.stack([_cloud(rng, 30, 3, 5.0) for _ in range(2)])
    mask = (rng.uniform(size=(2, 30)) > 0.3).astype(np.float32)
    mask[1] = 0.0  # an empty frame: divided by 1, as in JAX
    got = KS.mm_center(*_t(q, mask))
    assert got.shape == (2, 1, 3)
    for k in range(2):
        np.testing.assert_allclose(got[k, 0].numpy(), np.asarray(
            _mm_center(jnp.asarray(q[k]), jnp.asarray(mask[k]))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d", [2, 3])
def test_grad_kred_matches_jax(d):
    """grad_kred through the kernel route and its VJP against the JAX
    grad_kred_mm (two frames, ragged y mask): values rtol 2e-4, gradients
    rtol 1e-3, the bounds of tests/test_ksum.py."""
    rng = np.random.default_rng(20 + d)
    x = np.stack([_cloud(rng, 60, d, 3.0) for _ in range(2)])
    y = np.stack([_cloud(rng, 80, d, 3.0) for _ in range(2)])
    my = (rng.uniform(size=(2, 80)) > 0.25).astype(np.float32)
    g = rng.normal(size=(2, 60, d)).astype(np.float32)
    xt, yt = (t.clone().requires_grad_(True) for t in _t(x, y))
    got = KS.grad_kred(xt, yt, SIG, torch.as_tensor(my))
    gx, gy = torch.autograd.grad((got * torch.as_tensor(g)).sum(), (xt, yt))
    for k in range(2):
        want, vjp = jax.vjp(lambda a, b: PK.grad_kred_mm(a, b, SIG, jnp.asarray(my[k])),
                            jnp.asarray(x[k]), jnp.asarray(y[k]))
        _close(got[k].detach().numpy(), want, 2e-4)
        wx, wy = vjp(jnp.asarray(g[k]))
        _close(gx[k].numpy(), wx, 1e-3)
        _close(gy[k].numpy(), wy, 1e-3)


@pytest.mark.parametrize("d", [2, 3])
def test_hamiltonian_eta_matches_jax(d):
    """The eta != 0 Hamiltonian (kernel-sum value, any-eta forward as its
    gradient) against the JAX make_hamiltonian, two frames: value rtol 2e-4,
    gradients rtol 1e-3 (tests/test_ksum.py::test_hamiltonian_mm_value_and_grads)."""
    rng = np.random.default_rng(30 + d)
    eta = 0.3
    q = np.stack([_cloud(rng, 150, d, -2.0) for _ in range(2)])
    p = (0.4 * rng.normal(size=(2, 150, d))).astype(np.float32)
    m = (rng.uniform(size=(2, 150)) > 0.2).astype(np.float32)
    qt, pt = (t.clone().requires_grad_(True) for t in _t(q, p))
    h = RS.hamiltonian(qt, pt, SIG, torch.as_tensor(m), eta)
    gq, gp = torch.autograd.grad(h.sum(), (qt, pt))
    op = PK.make_hamiltonian(SIG, eta)
    for k in range(2):
        args = (jnp.asarray(q[k]), jnp.asarray(p[k]))
        want = op(*args, jnp.asarray(m[k]))
        np.testing.assert_allclose(float(h[k].detach()), float(want), rtol=2e-4, atol=1e-4)
        wq, wp = jax.grad(lambda a, b: op(a, b, jnp.asarray(m[k])), argnums=(0, 1))(*args)
        _close(gq[k].numpy(), wq, 1e-3)
        _close(gp[k].numpy(), wp, 1e-3)


@pytest.mark.parametrize("ncols,cc,n", [(3, 8, 1), (6, 8, 1), (9, 16, 1), (20, 24, 1),
                                        (40, 40, 1), (121, 128, 1), (333, 112, 3),
                                        (1, 8, 1), (8, 8, 1), (18, 24, 1), (36, 40, 1),
                                        (128, 128, 1), (129, 72, 2)])
def test_kernel_column_chunks(ncols, cc, n):
    """The kernel's column chunks: the fewest of at most 128 columns (N of
    the wgmma up to 128, in steps of 8), each a multiple of 8, covering the table
    (the widths the eta model and the ring send, and the tile edges), so
    that a pair takes ceil(ncols / 128) exponentials."""
    assert KS.chunking(ncols) == (cc, n)
    assert cc * n >= ncols and cc % 8 == 0 and cc <= KS.MAX_CHUNK_COLS
    assert n == -(-ncols // KS.MAX_CHUNK_COLS)


def test_kernel_y_splits():
    """The y axis is split only where the launch would leave the card idle
    (fewer than two blocks an SM; the kernel runs one block an SM): the
    support-side dq/dp sum (10 frames of 380 rows against 65,536 columns)
    splits, the data-side sums and the dense self sums at run_large's
    131,072 points do not.  Splits are whole 64-column tiles (an unsplit
    axis is padded to one)."""
    assert KS.block_rows(20) == 256 and KS.block_rows(121) == 128
    assert KS.splitting(10, 65536, 380, 20) == 384
    assert KS.splitting(1, 131072, 131072, 121) == 131072
    cols = KS.splitting(10, 380, 65536, 20)
    assert cols % 128 == 0 and cols >= KS.MIN_SPLIT_COLS
    splits = -(-65536 // cols)
    assert 10 * -(-380 // KS.block_rows(20)) * splits >= KS.TARGET_BLOCKS
    # too few columns to split
    assert KS.splitting(1, 100, 1500, 3) == 1536
    for args in ((10, 65536, 380, 20), (1, 100, 1500, 3), (3, 300, 20000, 20)):
        assert KS.splitting(*args) % KS.TILE_COLS == 0


def test_ops_per_pair_counts_the_function():
    """The term lists of the bounds.  FP32 route: 3d - 1 for the distance,
    one multiply-add per column.  Tensor-core route: three TF32 products of
    two FLOP per column; beside them on the FP32 pipe the distance, the
    exponent's scale and the split of k (one rounding, one subtraction)."""
    assert KS.ops_per_pair(2, 20) == 45
    assert KS.ops_per_pair(3, 121) == 250
    assert KS.tensor_flops_per_pair(36) == 216
    assert KS.tensor_flops_per_pair(18) == 108
    assert KS.fp32_ops_per_pair(2) == 8
    assert KS.fp32_ops_per_pair(3) == 11
    # the ring's bound at 65,536^2 (one exponential a pair, 4.1875e12 a
    # second on the MUFU; 495 TFLOP/s TF32): tensor-bound at 36 columns,
    # MUFU-bound at 18
    pairs = 65536.0 ** 2
    for ncols, want_ms, by in ((36, 1.874, "tensor"), (18, 1.026, "mufu")):
        terms = {"tensor": pairs * KS.tensor_flops_per_pair(ncols) / 495e12,
                 "mufu": pairs / 4.1875e12,
                 "fp32": pairs * KS.fp32_ops_per_pair(2) / 67e12}
        assert max(terms, key=terms.get) == by
        assert abs(1e3 * terms[by] - want_ms) < 1e-3


def _scheme_inputs(ncols):
    """3 frames of 400 rows against 600 columns on clouds about 1 wide, sigma
    = 0.05 (the grid eta path's), a ragged mask and a random table."""
    rng = np.random.default_rng(ncols)
    x = rng.uniform(-0.5, 0.5, size=(3, 400, 2)).astype(np.float32)
    y = rng.uniform(-0.5, 0.5, size=(3, 600, 2)).astype(np.float32)
    my = (rng.uniform(size=(3, 600)) > 0.1).astype(np.float32)
    t = rng.normal(size=(3, ncols, 600)).astype(np.float32)
    return _t(x, y, t, my)


TOL_FWD = 1e-5  # chip_smoke.py's bound on ksum against its float64 plain version


@pytest.mark.parametrize("ncols", [6, 20, 36, 121])
def test_3xtf32_scheme_meets_the_forward_tolerance(ncols):
    """The kernel's 3xTF32 arithmetic, emulated, stays within TOL_FWD of the
    float64 plain version (relative to the largest output), and a single
    TF32 product does not: the negative control that makes the three
    passes necessary."""
    x, y, t, my = _scheme_inputs(ncols)
    sig = 0.05
    ref = KS.ksum_reference(x.double(), y.double(), t.double(), my.double(), sig)
    scale = float(ref.abs().max())
    err3 = float((_ksum_3xtf32(x, y, t, my, sig).double() - ref).abs().max()) / scale
    err1 = float((_ksum_3xtf32(x, y, t, my, sig, passes=1).double() - ref).abs().max()) / scale
    assert err3 <= TOL_FWD, err3
    assert err1 > TOL_FWD, err1


@pytest.mark.parametrize("sigma", [0.05, 0.2])
def test_tiles_keep_truncated_accumulation_within_tolerance(sigma):
    """The emulated 3xTF32 sums over one 16,384-column row with a positive
    table: summed in tiles of TILE_COLS columns they stay within TOL_FWD of
    the float64 plain version; accumulated over the whole row, the
    truncation after each k-step misses it."""
    rng = np.random.default_rng(7)
    ny = 16384
    x = rng.uniform(-0.5, 0.5, size=(1, 64, 2)).astype(np.float32)
    y = rng.uniform(-0.5, 0.5, size=(1, ny, 2)).astype(np.float32)
    t = np.abs(rng.normal(size=(1, 6, ny))).astype(np.float32)
    x, y, t, my = _t(x, y, t, np.ones((1, ny), np.float32))
    ref = KS.ksum_reference(x.double(), y.double(), t.double(), my.double(), sigma)
    scale = float(ref.abs().max())

    def err(tile):
        return float((_ksum_3xtf32(x, y, t, my, sigma, tile=tile).double() - ref).abs().max()) / scale

    assert err(KS.TILE_COLS) <= TOL_FWD
    assert err(ny) > TOL_FWD


def test_tf32_rounding_is_nearest_ties_away():
    """_tf32_rna on hand-made bit patterns: below half a TF32 ulp rounds
    down, at half rounds away from zero (either sign), a carry reaches the
    exponent; and hi + lo recovers v to 2^-22 of it."""
    one = 1.0
    ulp = 2.0 ** -10
    v = torch.tensor([one + 0.49 * ulp, one + 0.5 * ulp, -(one + 0.5 * ulp),
                      2.0 - 0.5 * ulp, 3.0], dtype=torch.float32)
    got = _tf32_rna(v).tolist()
    assert got == [one, one + ulp, -(one + ulp), 2.0, 3.0]
    w = torch.as_tensor(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    hi = _tf32_rna(w)
    lo = _tf32_rna(w - hi)
    assert float(((hi.double() + lo.double()) - w.double()).abs().div(w.abs()).max()) <= 2.0 ** -21


def test_monomials_builder():
    """Products built one degree at a time equal the direct products."""
    rng = np.random.default_rng(1)
    rows = torch.as_tensor(rng.normal(size=(2, 4, 7)))
    root = torch.as_tensor(rng.normal(size=(2, 7)))
    monos = [(), (2,), (0, 0), (1, 3, 3), (0, 1, 2, 3), (3,)]
    got = KS.Monomials(monos)(root, rows)
    for i, mn in enumerate(monos):
        want = root.clone()
        for v in mn:
            want = want * rows[:, v]
        np.testing.assert_allclose(got[:, i].numpy(), want.numpy(), rtol=1e-14)
