"""The port's fused self-RHS op (difficp_torch/ops/rhs_self.py) against the JAX
package: the dense reduction and its jax.vjp, and the Pallas kernels as
tests/test_pallas.py runs them (interpret mode on the CPU).

On the CPU the op's autograd Functions take the kernels' plain PyTorch
versions; the CUDA kernels themselves are checked against those on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from difficp_tpu.ops import reductions as R
from difficp_torch.ops import backend as TB
from difficp_torch.ops import ksum as KS
from difficp_torch.ops import reductions as TR
from difficp_torch.ops import rhs_self as RS

torch.set_num_threads(1)

SIG = 0.6


def _inputs(m, d, seed, box=False, ragged=True):
    rng = np.random.default_rng(seed)
    if box:
        q = rng.uniform(size=(m, d)).astype(np.float32)
    else:
        q = rng.normal(size=(m, d)).astype(np.float32)
    p = (0.3 * rng.normal(size=(m, d))).astype(np.float32)
    mask = np.ones(m, np.float32)
    if ragged:
        mask = (rng.uniform(size=m) > 0.2).astype(np.float32)
        mask[-7:] = 0.0  # a padded tail, as pad_frames makes
    a = rng.normal(size=(m, d)).astype(np.float32)
    b = rng.normal(size=(m, d)).astype(np.float32)
    c = np.float32(rng.normal())
    return q, p, mask, a, b, c


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def _close(x, ref, rtol):
    """|x - ref| <= rtol (|ref| + max|ref|): float32 sums in two orders."""
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(x, ref, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("withlogdet", [True, False])
def test_plain_kernels_match_jax_dense_and_vjp(d, withlogdet):
    """Forward and VJP at M = 300, masked and ragged.  rtol 1e-5: both sides
    are float32 direct sums over 300 terms."""
    q, p, mask, a, b, c = _inputs(300, d, seed=d)
    (vq, mgq, dc), vjp = jax.vjp(
        lambda q_, p_: R.lddmm_rhs_self(q_, p_, SIG, 0.0, withlogdet, jnp.asarray(mask)),
        jnp.asarray(q), jnp.asarray(p))
    dq_ref, dp_ref = vjp((jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))

    qt, pt, mt, at, bt = _t(q, p, mask, a, b)
    v, w, dcr = RS.rhs_self_fwd(qt, pt, mt, SIG, withlogdet)
    _close(v, vq, 1e-5)
    _close(w, mgq, 1e-5)
    np.testing.assert_allclose(float(dcr.sum()), float(dc), rtol=1e-5, atol=1e-6)
    dq, dp = RS.rhs_self_bwd(qt, pt, mt, at, bt, torch.tensor(c), SIG, withlogdet)
    _close(dq, dq_ref, 1e-5)
    _close(dp, dp_ref, 1e-5)


@pytest.mark.parametrize("withlogdet", [True, False])
def test_function_matches_pallas_interpret(withlogdet):
    """RHSSelf forward against make_rhs_self(ti=tj=64) and its backward
    against the symmetric block-pair backward _rhs_self_bwd_sym_mm(mb=512),
    on box clouds.  Forward rtol 1e-5; dq rtol 1e-4, since the JAX fast
    backward's own floor is 3e-6 to 1e-5 on box geometry (BASELINE.md:113-116)."""
    from difficp_tpu.ops.pallas_reductions import (
        _mm_center, _rhs_self_bwd_sym_mm, make_rhs_self,
    )

    sig = 0.3
    q, p, mask, a, b, c = _inputs(1024, 2, seed=11, box=True)
    qj, pj, mj = jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask)
    vq, mgq, dc = make_rhs_self(sig, 0.0, withlogdet, ti=64, tj=64)(qj, pj, mj)
    qc = qj - _mm_center(qj, mj)
    # cotangents of (v, -Gq, dcost), as test_pallas.py hands them over
    dq_ref, dp_ref = _rhs_self_bwd_sym_mm(qc, pj, mj, jnp.asarray(a), jnp.asarray(b),
                                          jnp.asarray(c), sig, mb=512)

    qt, pt, mt, at, bt = _t(q, p, mask, a, b)
    qt.requires_grad_(True)
    pt.requires_grad_(True)
    v, w, dcost = RS.RHSSelf.apply(qt, pt, mt, sig, withlogdet)
    _close(v.detach(), vq, 1e-5)
    _close(w.detach(), mgq, 1e-5)
    if withlogdet:
        np.testing.assert_allclose(float(dcost.detach()), float(dc), rtol=1e-5, atol=1e-5)
        dq, dp = torch.autograd.grad(
            (v * at).sum() + (w * bt).sum() + float(c) * dcost, (qt, pt))
        _close(dq, dq_ref, 1e-4)
        _close(dp, dp_ref, 1e-5)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("withlogdet", [True, False])
def test_backward_matches_pallas_streaming_bwd(d, withlogdet):
    """The port's self backward against the streaming Pallas VJP
    _rhs_self_bwd_pallas (TPU row #12, interpret mode on the CPU), which has
    rhs_self_bwd's contract: (dq, dp) from the cotangents of (v, -Gq, dc).
    Both rhs_self_bwd itself and RHSSelf's backward (the kernel route's
    Function) are held; M = 300 with holes and a padded tail, gc != 0 with
    logdet on, and gc = 0 with it off (dc is then no output).  dq rtol 1e-4,
    dp 1e-5, as against the Pallas interpret backward above."""
    from difficp_tpu.ops.pallas_reductions import _rhs_self_bwd_pallas

    q, p, mask, a, b, c = _inputs(300, d, seed=40 + d)
    gc = c if withlogdet else np.float32(0.0)
    dq_ref, dp_ref = _rhs_self_bwd_pallas(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(mask), jnp.asarray(a),
        jnp.asarray(b), jnp.asarray(gc), SIG)

    qt, pt, mt, at, bt = _t(q, p, mask, a, b)
    dq, dp = RS.rhs_self_bwd(qt, pt, mt, at, bt, torch.tensor(c), SIG, withlogdet)
    _close(dq, dq_ref, 1e-4)
    _close(dp, dp_ref, 1e-5)

    qt.requires_grad_(True)
    pt.requires_grad_(True)
    v, w, dcost = RS.RHSSelf.apply(qt, pt, mt, SIG, withlogdet)
    fdq, fdp = torch.autograd.grad(
        (v * at).sum() + (w * bt).sum() + float(c) * dcost, (qt, pt))
    _close(fdq, dq_ref, 1e-4)
    _close(fdp, dp_ref, 1e-5)


@pytest.mark.parametrize("d", [2, 3])
def test_masked_equals_subset(d):
    q, p, mask, a, b, c = _inputs(120, d, seed=5)
    idx = np.nonzero(mask)[0]
    qt, pt, mt = _t(q, p, mask)
    v, w, dc = RS.RHSSelf.apply(qt, pt, mt, SIG, True)
    vs, ws, dcs = RS.RHSSelf.apply(qt[idx], pt[idx], torch.ones(len(idx)), SIG, True)
    np.testing.assert_allclose(v[idx].numpy(), vs.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w[idx].numpy(), ws.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(dc), float(dcs), rtol=1e-5, atol=1e-6)
    assert np.all(v.numpy()[mask == 0] == 0.0)
    h = RS.Hamiltonian.apply(qt, pt, mt, SIG)
    hs = RS.Hamiltonian.apply(qt[idx], pt[idx], torch.ones(len(idx)), SIG)
    np.testing.assert_allclose(float(h), float(hs), rtol=1e-5)


def _unordered_pair_terms(q, p, m, a, b, c, u):
    """The forward and the VJP taken once per unordered pair i < j, term by
    term as rhs_self.{fwd,bwd}_ops_per_unordered_pair count them, plus the
    diagonal (k = 1, d = 0).  Float64 numpy; m is 0/1, so m_i^2 = m_i."""
    i, j = np.triu_indices(q.shape[0], 1)

    def both(x_i, x_j):  # row sums of x_i at i and x_j at j
        out = np.zeros_like(q)
        np.add.at(out, i, x_i)
        np.add.at(out, j, x_j)
        return out

    d = q[i] - q[j]
    kt = m[i] * m[j] * np.exp(-0.5 * u * (d * d).sum(1))
    k1 = kt[:, None]
    pp = (p[i] * p[j]).sum(1)
    v = m[:, None] * p + both(k1 * p[j], k1 * p[i])
    t = (kt * pp)[:, None] * d
    w = u * both(t, -t)
    dcost = -u * (kt * ((p[i] - p[j]) * d).sum(1)).sum()

    db = b[i] - b[j]
    dpv = p[i] - p[j]
    dbd = (db * d).sum(1)
    s = ((a[i] * p[j]).sum(1) + (a[j] * p[i]).sum(1) + u * pp * dbd
         - u * c * (dpv * d).sum(1))
    kx = k1 * (-s[:, None] * d + pp[:, None] * db - c * dpv)
    dq = u * both(kx, -kx)
    g = (kt * dbd)[:, None]
    h = k1 * d
    dp = (m[:, None] * a + both(k1 * a[j], k1 * a[i])
          + u * both(g * p[j], g * p[i]) - u * c * both(h, -h))
    return v, w, dcost, dq, dp


@pytest.mark.parametrize("d", [2, 3])
def test_unordered_pair_terms_match_plain_versions(d):
    """The term lists behind the kernels' bound (each unordered pair once)
    compute the same function as the plain versions; float64, M = 40."""
    q, p, mask, a, b, c = (np.asarray(x, np.float64) for x in _inputs(40, d, seed=7))
    want = _unordered_pair_terms(q, p, mask, a, b, float(c), 1.0 / SIG ** 2)
    qt, pt, mt, at, bt = (torch.as_tensor(x) for x in (q, p, mask, a, b))
    v, w, dcr = RS.rhs_self_fwd_reference(qt, pt, mt, SIG, True)
    dq, dp = RS.rhs_self_bwd_reference(qt, pt, mt, at, bt,
                                       torch.tensor(float(c), dtype=torch.float64),
                                       SIG, True)
    for got, ref in zip((v, w, dcr.sum(), dq, dp), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("withlogdet", [True, False])
def test_gradcheck_float64(withlogdet):
    """The Functions' backward (the backward kernel's plain version) against
    finite differences, float64 at M = 20, two frames."""
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.normal(size=(2, 20, 2)) * 0.5, requires_grad=True)
    p = torch.tensor(rng.normal(size=(2, 20, 2)) * 0.3, requires_grad=True)
    m = torch.tensor((rng.uniform(size=(2, 20)) > 0.2).astype(np.float64))
    assert torch.autograd.gradcheck(
        lambda q_, p_: RS.RHSSelf.apply(q_, p_, m, SIG, withlogdet), (q, p))
    assert torch.autograd.gradcheck(
        lambda q_, p_: RS.Hamiltonian.apply(q_, p_, m, SIG), (q, p))


def test_hamiltonian_matches_jax():
    """Value and gradient of the Hamiltonian Function against
    reductions.hamiltonian and jax.grad; rtol 1e-5 (float32 sums)."""
    q, p, mask, *_ = _inputs(200, 2, seed=9)
    h_ref, (gq_ref, gp_ref) = jax.value_and_grad(
        lambda q_, p_: R.hamiltonian(q_, p_, SIG, 0.0, jnp.asarray(mask)),
        argnums=(0, 1))(jnp.asarray(q), jnp.asarray(p))
    qt, pt, mt = _t(q, p, mask)
    qt.requires_grad_(True)
    pt.requires_grad_(True)
    h = RS.Hamiltonian.apply(qt, pt, mt, SIG)
    gq, gp = torch.autograd.grad(h, (qt, pt))
    np.testing.assert_allclose(float(h), float(h_ref), rtol=1e-5)
    _close(gq, gq_ref, 1e-5)
    _close(gp, gp_ref, 1e-5)


def test_dense_reductions_match_jax_any_eta():
    """The port's dense route (ops/reductions.py), eta = 0 and eta != 0."""
    q, p, mask, *_ = _inputs(150, 3, seed=4)
    qt, pt, mt = _t(q, p, mask)
    for eta in (0.0, 0.3):
        ref = R.lddmm_rhs_self(jnp.asarray(q), jnp.asarray(p), SIG, eta, True,
                               jnp.asarray(mask))
        got = TR.lddmm_rhs_self(qt, pt, SIG, eta, True, mt)
        for x, r in zip(got[:2], ref[:2]):
            _close(x, r, 1e-5)
        np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            float(TR.hamiltonian(qt, pt, SIG, eta, mt)),
            float(R.hamiltonian(jnp.asarray(q), jnp.asarray(p), SIG, eta,
                                jnp.asarray(mask))), rtol=1e-5)
    np.testing.assert_allclose(
        TR.second_min_sqdist(qt, mt).numpy(),
        np.asarray(R.second_min_sqdist(jnp.asarray(q), jnp.asarray(mask))), rtol=1e-6)
    np.testing.assert_allclose(
        TR.min_sqdist(qt[:40], qt, mt).numpy(),
        np.asarray(R.min_sqdist(jnp.asarray(q[:40]), jnp.asarray(q), jnp.asarray(mask))),
        rtol=1e-6)


def test_backend_routes():
    """Dense at or under the pair limit, the kernel Functions when forced (at
    eta = 0 and eta != 0), the blockwise functions when forced, and
    ValueError for an unknown route."""
    q, p, mask, *_ = _inputs(64, 2, seed=2)
    qt, pt, mt = _t(q, p, mask)
    try:
        dense = TB.lddmm_rhs_self(qt, pt, SIG, 0.0, True, mt)
        TB.set_backend("kernel")
        kern = TB.lddmm_rhs_self(qt, pt, SIG, 0.0, True, mt)
        assert kern[0].grad_fn is not None or not kern[0].requires_grad
        for x, r in zip(kern, dense):
            _close(x, r, 1e-5)
        kern_eta = TB.lddmm_rhs_self(qt, pt, SIG, 0.5, True, mt)
        for x, r in zip(kern_eta, TR.lddmm_rhs_self(qt, pt, SIG, 0.5, True, mt)):
            _close(x, r, 1e-5)
        # kmin2 (its plain version here) takes the nearest-neighbour search
        np.testing.assert_allclose(TB.second_min_sqdist(qt, mt).numpy(),
                                   TR.second_min_sqdist(qt, mt).numpy(), rtol=1e-6)
        TB.set_backend("blockwise")
        block = TB.lddmm_rhs_self(qt, pt, SIG, 0.0, True, mt)
        for x, r in zip(block, dense):
            _close(x, r, 1e-5)
        with pytest.raises(ValueError):
            TB.set_backend("pallas")
    finally:
        TB.set_backend(None)


def test_kernel_wrapper_rejects_bad_input():
    q, p, mask, *_ = _inputs(16, 2, seed=1, ragged=False)
    qt, pt, mt = _t(q, p, mask)
    with pytest.raises(ValueError):
        RS.rhs_self_fwd(qt.to("meta"), pt.to("meta"), mt.to("meta"), SIG, True)
    with pytest.raises(ValueError):
        RS._check("q", qt.double(), qt.shape, qt.device)
    with pytest.raises(ValueError):
        RS._check("q", qt.t(), qt.shape, qt.device)


# ---------------------------------------------------------------------------
# the eta = 0 table kernels' scheme (csrc/rhs_self.cu), emulated on the CPU
# ---------------------------------------------------------------------------

# float32 sums in another order than the plain version, relative to the
# largest |plain| output (chip_smoke.py's bounds); dq's bar on registration
# geometry (the JAX package's, BASELINE.md:111-121)
TOL_FWD = 1e-5
TOL_BWD = 1e-4
TOL_DQ_REGISTRATION = 1e-5


@pytest.mark.parametrize("d", [2, 3])
def test_tables_match_jax(d):
    """The kernels' payload columns are the JAX package's, in names and
    order: _fwd_col_table (9 / 16 columns) and _bwd_col_table (45 / 104)."""
    from difficp_tpu.ops.pallas_reductions import _bwd_col_table, _fwd_col_table

    assert RS.fwd_table(d) == list(_fwd_col_table(d))
    assert RS.bwd_table(d) == list(_bwd_col_table(d))
    assert len(RS.bwd_table(d)) == {2: 45, 3: 104}[d]


@pytest.mark.parametrize("d", [2, 3])
def test_morton_codes_match_jax(d, monkeypatch):
    """The port's Morton codes equal those _morton_order sorts by, on a
    masked cloud with a padded tail (the codes, not the argsort: ties may
    fall either way).  XLA's float32 division on the CPU is not IEEE-exact
    (its 1023 / span can differ from the port's in the last bit), so a point
    whose scaled coordinate lies within float32 rounding (1e-4 of a cell of
    1/1023 of the span) of a cell boundary may fall into the next cell: the
    codes are held equal everywhere else, with at most 0.5% such points.
    The order sorts the codes, stably, and counts itself."""
    import difficp_tpu.ops.pallas_reductions as PR

    q, _, mask, *_ = _inputs(3000, d, seed=30 + d)
    q[::7] = q[3::7]  # duplicated points: ties
    monkeypatch.setattr(PR.jnp, "argsort", lambda code: code)
    want = np.asarray(PR._morton_order(jnp.asarray(q), jnp.asarray(mask)))
    qt, mt = _t(q, mask)
    got = RS.morton_codes(qt, mt).numpy()
    on = mask > 0
    lo, hi = q[on].min(0), q[on].max(0)
    cell = (q - lo) * np.float32(2.0 ** RS.MORTON_BITS - 1.0) / (hi - lo)
    at_boundary = (np.abs(cell - np.round(cell)) < 1e-4).any(-1)
    differ = got != want
    assert not (differ & ~at_boundary).any()
    assert differ.sum() <= 0.005 * len(want)
    assert len(np.unique(want)) > 2000
    RS.orders["row_order"] = 0
    order = RS.row_order(qt[None], mt[None], SIG)[0]
    assert order.dtype == torch.int32 and RS.orders["row_order"] == 1
    # the runs of the order, padding taken out, are the codes' stable sort
    np.testing.assert_array_equal(order[order >= 0].numpy(), np.argsort(got, kind="stable"))


def _spiral(m, seed, d=2):
    """A spiral cloud of the main paths (its points in random order, as
    spiral_cloud draws them), random momenta, ~10% masked, cotangents."""
    from difficp_torch.examples.run_large import spiral_cloud

    rng = np.random.default_rng(seed)
    q = spiral_cloud(m, rng, dim=d)
    p = (0.05 * rng.normal(size=(m, d))).astype(np.float32)
    mask = (rng.uniform(size=m) > 0.1).astype(np.float32)
    a, b = rng.normal(size=(2, m, d)).astype(np.float32)
    return _t(q, p, mask, a, b) + [float(np.float32(rng.normal()))]


def _rel(x, ref):
    return float((x.double() - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("sigma", [0.1, 0.05])
def test_table_scheme_meets_the_tolerances(sigma):
    """The table kernels' float32 arithmetic, emulated (tests/tf32_emulation:
    blocks of 256 rows in the rows' Morton order, each block's table centred
    on its masked centroid, TF32 splits as tf32_rna, 32-column tiles summed
    in truncating accumulators), on a spiral cloud of 2,048 points at the
    dense (0.1) and grid (0.05) paths' sigma: v, w and dcost within TOL_FWD,
    dq and dp within TOL_BWD of the float64 plain versions, and dq within
    TOL_DQ_REGISTRATION."""
    from tf32_emulation import table_scheme

    q, p, mask, a, b, c = _spiral(2048, seed=1)
    f64 = [t.double() for t in (q, p, mask, a, b)]
    rv, rw, rdc = RS.rhs_self_fwd_reference(*f64[:3], sigma, True)
    rq, rp = RS.rhs_self_bwd_reference(*f64, torch.tensor(c, dtype=torch.float64), sigma,
                                       True)
    order = RS.row_order(q, mask, sigma)
    v, w, dc = table_scheme(q, p, mask, q, p, mask, sigma, order)
    dq, dp = table_scheme(q, p, mask, q, p, mask, sigma, order, backward=True, a=a, b=b, c=c)
    assert max(_rel(v, rv), _rel(w, rw)) <= TOL_FWD
    assert float((dc.double().sum() - rdc.sum()).abs() / rdc.abs().sum()) <= TOL_FWD
    assert max(_rel(dq, rq), _rel(dp, rp)) <= TOL_BWD
    assert _rel(dq, rq) <= TOL_DQ_REGISTRATION


def test_table_scheme_needs_the_row_order():
    """The negative control: the same emulated backward with the rows in the
    cloud's own (random) order, each block then spanning the whole cloud,
    puts dq above TOL_DQ_REGISTRATION at the grid path's sigma = 0.05, where
    the Morton order keeps it within (test above)."""
    from tf32_emulation import table_scheme

    sigma = 0.05
    q, p, mask, a, b, c = _spiral(2048, seed=1)
    rq, _ = RS.rhs_self_bwd_reference(*(t.double() for t in (q, p, mask, a, b)),
                                      torch.tensor(c, dtype=torch.float64), sigma, True)
    natural = torch.arange(2048, dtype=torch.int32)
    dq, _ = table_scheme(q, p, mask, q, p, mask, sigma, natural, backward=True, a=a, b=b, c=c)
    assert _rel(dq, rq) > TOL_DQ_REGISTRATION


def test_route_bound_counts():
    """The table route's per-pair terms: three TF32 products of two FLOP on
    the padded table (16 columns forward at d = 2 and 3; 48 and 104
    backward), the distance, scale and split on the FP32 pipe (3d + 2, as
    ksum's), one exponential; and at the dense main path's 65,536^2 (ordered pairs;
    4.1875e12 exponentials a second, 495 TFLOP/s TF32, 67 TFLOP/s FP32) the
    forward bound by the MUFU at 1.026 ms, the backward by the tensor cores
    at 2.498 ms."""
    assert RS.tensor_flops_per_pair(2, False) == 3 * 2 * 16
    assert RS.tensor_flops_per_pair(3, False) == 3 * 2 * 16
    assert RS.tensor_flops_per_pair(2, True) == 3 * 2 * 48
    assert RS.tensor_flops_per_pair(3, True) == 3 * 2 * 104
    assert KS.fp32_ops_per_pair(2) == 8
    assert KS.fp32_ops_per_pair(3) == 11
    pairs = 65536.0 ** 2
    for backward, want_ms, by in ((False, 1.026, "mufu"), (True, 2.498, "tensor")):
        terms = {"tensor": pairs * RS.tensor_flops_per_pair(2, backward) / 495e12,
                 "mufu": pairs / 4.1875e12,
                 "fp32": pairs * KS.fp32_ops_per_pair(2) / 67e12}
        assert max(terms, key=terms.get) == by
        assert abs(1e3 * terms[by] - want_ms) < 1e-3


def test_row_order_cuts_the_z_curve_at_its_jumps():
    """At the dense main path's size (a spiral of 65,536 points, sigma =
    0.1) the Morton order's blocks of 256 rows (the kernels' there) reach a
    radius of ~0.45, about the cloud's, where the Z-curve jumps between arms;
    row_order cuts it at gaps wider than tau and pads each run to a whole
    number of blocks: every row once, at most 1/16 more slots, every block
    within 0.15 of its centroid."""
    from difficp_torch.examples.run_large import spiral_cloud

    m = 65536
    q = torch.as_tensor(spiral_cloud(m, np.random.default_rng(65538)))
    mask = torch.ones(m)
    order = RS.row_order(q, mask, 0.1)
    rows = RS.block_rows(q)
    assert rows == 256 and m < order.shape[0] <= m * (1 + RS.ORDER_PAD_BUDGET)
    np.testing.assert_array_equal(np.sort(order[order >= 0].numpy()), np.arange(m))

    def radius(slots):
        n = slots.shape[0] // rows * rows
        out = 0.0
        for blk in slots[:n].reshape(-1, rows):
            pts = q[blk[blk >= 0].long()]
            out = max(out, float((pts - pts.mean(0)).norm(dim=-1).max()))
        return out

    assert radius(order) <= 0.15
    assert radius(torch.argsort(RS.morton_codes(q, mask), stable=True)) > 0.3
