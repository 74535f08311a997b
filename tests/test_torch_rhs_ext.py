"""The port's external-point RHS op (difficp_torch/ops/rhs_ext.py) against the
JAX package: the dense reduction and its jax.vjp, and the Pallas kernels of
make_rhs_ext as tests/test_pallas.py runs them (interpret mode on the CPU).
Also the dense reductions this slice adds (ops/reductions.py) and the
backend routes over them.

On the CPU the op's autograd Function takes the kernels' plain PyTorch
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
from difficp_torch.ops import reductions as TR
from difficp_torch.ops import rhs_ext as RE

torch.set_num_threads(1)

SIG = 0.6


def _inputs(n, m, d, seed, box=False):
    """x (n, d) with a ragged mask, support (m, d) with a few masked rows,
    momenta and cotangents of (vq, -Gq, dcost, vx)."""
    rng = np.random.default_rng(seed)
    draw = rng.uniform if box else rng.normal
    x = draw(size=(n, d)).astype(np.float32)
    q = draw(size=(m, d)).astype(np.float32)
    p = (0.3 * rng.normal(size=(m, d))).astype(np.float32)
    mx = (rng.uniform(size=n) > 0.2).astype(np.float32)
    mx[-5:] = 0.0
    mq = (rng.uniform(size=m) > 0.1).astype(np.float32)
    gv, gg = (rng.normal(size=(m, d)).astype(np.float32) for _ in range(2))
    gx = rng.normal(size=(n, d)).astype(np.float32)
    gc = np.float32(rng.normal())
    return x, q, p, mx, mq, gv, gg, gc, gx


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def _close(x, ref, rtol):
    """|x - ref| <= rtol (|ref| + max|ref|): float32 sums in two orders."""
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(x, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _function(q, p, x, mq, mx, sigma, withlogdet, cot):
    """RHSExt forward and its VJP for the cotangents cot = (gv, gg, gc, gx)."""
    qt, pt, xt = (t.clone().requires_grad_(True) for t in _t(q, p, x))
    mqt, mxt = _t(mq, mx)
    out = RE.RHSExt.apply(qt, pt, xt, mqt, mxt, sigma, withlogdet)
    gv, gg, gc, gx = _t(*cot)
    loss = (out[0] * gv).sum() + (out[1] * gg).sum() + gc * out[2] + (out[3] * gx).sum()
    grads = torch.autograd.grad(loss, (qt, pt, xt))
    return [o.detach() for o in out], grads


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("withlogdet", [True, False])
def test_function_matches_jax_dense_and_vjp(d, withlogdet):
    """RHSExt forward and VJP against reductions.lddmm_rhs_ext and jax.vjp,
    N = 250, M = 90, masked.  rtol 1e-5: both sides are float32 direct sums
    over at most 250 terms."""
    x, q, p, mx, mq, gv, gg, gc, gx = _inputs(250, 90, d, seed=d)
    out_ref, vjp = jax.vjp(
        lambda q_, p_, x_: R.lddmm_rhs_ext(q_, p_, x_, SIG, 0.0, withlogdet,
                                           jnp.asarray(mq), jnp.asarray(mx)),
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(x))
    grads_ref = vjp(tuple(jnp.asarray(c) for c in (gv, gg, gc, gx)))
    out, grads = _function(q, p, x, mq, mx, SIG, withlogdet, (gv, gg, gc, gx))
    for got, ref in zip(out[:2] + out[3:], out_ref[:2] + out_ref[3:]):
        _close(got, ref, 1e-5)
    np.testing.assert_allclose(float(out[2]), float(out_ref[2]), rtol=1e-5, atol=1e-5)
    for got, ref in zip(grads, grads_ref):
        _close(got, ref, 1e-5)


def test_function_matches_pallas_interpret():
    """RHSExt against make_rhs_ext(ti=tj=64) in interpret mode, values and
    custom-VJP gradients, at tests/test_pallas.py's tolerances (forward rtol
    1e-4 / atol 5e-5, dcost 1e-3 / 1e-4, gradients 1e-3 / 1e-3)."""
    from difficp_tpu.ops.pallas_reductions import make_rhs_ext

    x, q, p, mx, mq, gv, gg, gc, gx = _inputs(150, 300, 2, seed=0)
    mq = np.ones_like(mq)
    op = make_rhs_ext(SIG, 0.0, True, ti=64, tj=64)
    vq, mgq, dc, vx = op(jnp.asarray(q), jnp.asarray(p), jnp.asarray(x),
                         jnp.asarray(mq), jnp.asarray(mx))

    def loss(q_, p_, x_):
        a, b, c, e = op(q_, p_, x_, jnp.asarray(mq), jnp.asarray(mx))
        return jnp.sum(e ** 2) + jnp.sum(a * b) + c

    g_ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(p),
                                              jnp.asarray(x))
    out, _ = _function(q, p, x, mq, mx, SIG, True, (gv, gg, gc, gx))
    for got, ref in ((out[0], vq), (out[1], mgq), (out[3], vx)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(float(out[2]), float(dc), rtol=1e-3, atol=1e-4)

    qt, pt, xt = (t.clone().requires_grad_(True) for t in _t(q, p, x))
    a, b, c, e = RE.RHSExt.apply(qt, pt, xt, *_t(mq, mx), SIG, True)
    grads = torch.autograd.grad((e ** 2).sum() + (a * b).sum() + c, (qt, pt, xt))
    for got, ref in zip(grads, g_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("d", [2, 3])
def test_masked_equals_subset(d):
    """Masked data rows and masked support rows contribute exactly nothing:
    the op on the subsets gives the same values and gradients."""
    x, q, p, mx, mq, gv, gg, gc, gx = _inputs(120, 40, d, seed=5)
    ix, iq = np.nonzero(mx)[0], np.nonzero(mq)[0]
    cot = (gv, gg, gc, gx)
    out, grads = _function(q, p, x, mq, mx, SIG, True, cot)
    sub_cot = (gv[iq], gg[iq], gc, gx[ix])
    out_s, grads_s = _function(q[iq], p[iq], x[ix], np.ones(len(iq), np.float32),
                               np.ones(len(ix), np.float32), SIG, True, sub_cot)
    for got, ref, idx in ((out[0], out_s[0], iq), (out[1], out_s[1], iq),
                          (out[3], out_s[3], ix), (grads[0], grads_s[0], iq),
                          (grads[1], grads_s[1], iq), (grads[2], grads_s[2], ix)):
        np.testing.assert_allclose(got[idx].numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(out[2]), float(out_s[2]), rtol=1e-5, atol=1e-6)
    assert np.all(out[3].numpy()[mx == 0] == 0.0)
    assert np.all(grads[1].numpy()[mq == 0] == 0.0)


@pytest.mark.parametrize("withlogdet", [True, False])
def test_gradcheck_float64(withlogdet):
    """The Function's backward (the three backward kernels' plain versions
    and the self backward) against finite differences, float64, two
    frames."""
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.normal(size=(2, 12, 2)) * 0.5, requires_grad=True)
    p = torch.tensor(rng.normal(size=(2, 12, 2)) * 0.3, requires_grad=True)
    x = torch.tensor(rng.normal(size=(2, 17, 2)) * 0.5, requires_grad=True)
    mq = torch.tensor((rng.uniform(size=(2, 12)) > 0.2).astype(np.float64))
    mx = torch.tensor((rng.uniform(size=(2, 17)) > 0.2).astype(np.float64))
    assert torch.autograd.gradcheck(
        lambda q_, p_, x_: RE.RHSExt.apply(q_, p_, x_, mq, mx, SIG, withlogdet),
        (q, p, x))


def _pair_terms(x, mx, q, p, mq, gx, gc, u):
    """The forward and the cross-term VJP per (x_i, q_j) pair, term by term
    as rhs_ext.{fwd,dx,dqdp}_ops_per_pair count them (per-point factors
    applied per point).  Float64 numpy; masks are 0/1."""
    pt = mq[:, None] * p                          # mq folded into p
    qp = (q * pt).sum(1)                          # q_j.p_j per column
    big_g = mx[:, None] * gx
    n, m = x.shape[0], q.shape[0]
    vx = np.zeros_like(x)
    a_qp = np.zeros(n)
    dx_e, dx_a = np.zeros_like(x), np.zeros_like(x)
    cl = gc * u * mx
    g1 = big_g + cl[:, None] * x                  # g'_l per data row
    dq_a, dq_h = np.zeros_like(q), np.zeros_like(q)
    dq_n = np.zeros(m)
    h = big_g + gc * u * mx[:, None] * x          # per data point
    c_l = gc * u * (p * q).sum(1)                 # per support row
    for i in range(n):
        for j in range(m):
            delta = x[i] - q[j]
            r2 = (delta * delta).sum()
            k = np.exp(-0.5 * u * r2)
            # forward
            vx[i] += k * pt[j]
            a_qp[i] += k * qp[j]
            # dx
            s = k * (g1[i] @ pt[j] - cl[i] * qp[j])
            dx_e[i] += s * delta
            dx_a[i] += k * pt[j]
            # dq, dp (row j of the support, e = q_j - x_i)
            e = -delta
            km = k * mx[i]
            s2 = k * (h[i] @ p[j]) - c_l[j] * km
            dq_a[j] += s2 * e
            dq_h[j] += k * h[i]
            dq_n[j] += km
    vx_out = mx[:, None] * vx
    dcost = u * (mx * ((x * vx).sum(1) - a_qp)).sum()
    dx = -u * dx_e + cl[:, None] * dx_a
    dq = mq[:, None] * (-u * dq_a - gc * u * dq_n[:, None] * p)
    dp = mq[:, None] * (dq_h - gc * u * dq_n[:, None] * q)
    return vx_out, dcost, dx, dq, dp


@pytest.mark.parametrize("d", [2, 3])
def test_pair_terms_match_plain_versions(d):
    """The term lists behind the kernels' bound compute the same function as
    the plain versions; float64, N = 30, M = 11."""
    x, q, p, mx, mq, _, _, gc, gx = (np.asarray(t, np.float64)
                                      for t in _inputs(30, 11, d, seed=7))
    u = 1.0 / SIG ** 2
    want = _pair_terms(x, mx, q, p, mq, gx, float(gc), u)
    xt, mxt, qt, pt, mqt, gxt = (torch.as_tensor(t) for t in (x, mx, q, p, mq, gx))
    gct = torch.tensor(float(gc), dtype=torch.float64)
    vx, dc = RE.rhs_ext_fwd_reference(xt, mxt, qt, pt, mqt, SIG, True)
    dx = RE.rhs_ext_bwd_dx_reference(xt, mxt, gxt, qt, pt, mqt, gct, SIG, True)
    dq, dp = RE.rhs_ext_bwd_dqdp_reference(xt, mxt, gxt, qt, pt, mqt, gct, SIG, True)
    for got, ref in zip((vx, dc.sum(), dx, dq, dp), want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12)
    assert (RE.fwd_ops_per_pair(2), RE.dx_ops_per_pair(2), RE.dqdp_ops_per_pair(2)) == (11, 19, 21)


def test_dense_reductions_match_jax_any_eta():
    """The dense ops this slice adds: lddmm_rhs_ext and v_field at eta = 0 and
    eta != 0, kred and check_coverage, with a leading frame axis on the
    port's side; rtol 1e-5."""
    x, q, p, mx, mq, *_ = _inputs(80, 30, 3, seed=4)
    xt, qt, pt, mxt, mqt = (t[None] for t in _t(x, q, p, mx, mq))
    for eta in (0.0, 0.3):
        ref = R.lddmm_rhs_ext(jnp.asarray(q), jnp.asarray(p), jnp.asarray(x), SIG,
                              eta, True, jnp.asarray(mq), jnp.asarray(mx))
        got = TR.lddmm_rhs_ext(qt, pt, xt, SIG, eta, True, mqt, mxt)
        for g, r in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
            _close(g[0], r, 1e-5)
        np.testing.assert_allclose(float(got[2][0]), float(ref[2]), rtol=1e-5, atol=1e-5)
        _close(TR.v_field(xt, qt, pt, SIG, eta, mqt)[0],
               R.v_field(jnp.asarray(x), jnp.asarray(q), jnp.asarray(p), SIG, eta,
                         jnp.asarray(mq)), 1e-5)
    _close(TR.kred(xt, qt, pt, SIG, mqt)[0],
           R.kred(jnp.asarray(x), jnp.asarray(q), jnp.asarray(p), SIG, jnp.asarray(mq)),
           1e-5)
    for r in (0.3, 1.0):
        np.testing.assert_array_equal(
            TR.check_coverage(xt, qt, SIG, r, mxt, mqt)[0].numpy(),
            np.asarray(R.check_coverage(jnp.asarray(x), jnp.asarray(q), SIG, r,
                                        jnp.asarray(mx), jnp.asarray(mq))))


def test_backend_routes_for_external_points():
    """Dense at or under the pair limit (on m (m + n) pairs for the ext RHS),
    the kernel route when forced: the same values, at eta = 0 and eta != 0;
    v_field and kred(q, q) through the kernels' plain versions; kred between
    two sets through the generic kernel-sum's plain version."""
    x, q, p, mx, mq, *_ = _inputs(64, 20, 2, seed=2)
    xt, qt, pt, mxt, mqt = (t[None] for t in _t(x, q, p, mx, mq))
    try:
        dense = TB.lddmm_rhs_ext(qt, pt, xt, SIG, 0.0, True, mqt, mxt)
        v_dense = TB.v_field(xt, qt, pt, SIG, 0.0, mqt)
        k_dense = TB.kred(qt, qt, pt, SIG, mqt)
        kx_dense = TB.kred(xt, qt, pt, SIG, mqt)
        TB.set_backend("kernel")
        kern = TB.lddmm_rhs_ext(qt, pt, xt, SIG, 0.0, True, mqt, mxt)
        for g, r in zip(kern, dense):
            _close(g, r, 1e-5)
        _close(TB.v_field(xt, qt, pt, SIG, 0.0, mqt), v_dense, 1e-5)
        # the self kernel zeroes masked rows, which kred keeps
        _close(TB.kred(qt, qt, pt, SIG, mqt), mqt[..., None] * k_dense, 1e-5)
        TB.set_backend("dense")
        dense_eta = (TB.lddmm_rhs_ext(qt, pt, xt, SIG, 0.2, True, mqt, mxt),
                     TB.v_field(xt, qt, pt, SIG, 0.2, mqt))
        TB.set_backend("kernel")
        kern_eta = (TB.lddmm_rhs_ext(qt, pt, xt, SIG, 0.2, True, mqt, mxt),
                    TB.v_field(xt, qt, pt, SIG, 0.2, mqt))
        for g, r in zip(kern_eta[0], dense_eta[0]):
            _close(g, r, 1e-5)
        _close(kern_eta[1], dense_eta[1], 1e-5)
        TB.set_backend("kernel")
        _close(TB.kred(xt, qt, pt, SIG, mqt), kx_dense, 1e-5)
    finally:
        TB.set_backend(None)
    # the auto route follows the JAX package's pair count m (m + n_x)
    limit = TB.DENSE_PAIR_LIMIT
    assert 20 * (20 + 64) <= limit


def test_kernel_wrappers_reject_bad_input():
    x, q, p, mx, mq, _, _, gc, gx = _inputs(16, 8, 2, seed=1)
    xt, qt, pt, mxt, mqt, gxt = _t(x, q, p, mx, mq, gx)
    with pytest.raises(ValueError):
        RE.rhs_ext_fwd(xt.to("meta"), mxt.to("meta"), qt.to("meta"), pt.to("meta"),
                       mqt.to("meta"), SIG, True)
    with pytest.raises(ValueError):
        RE.rhs_ext_bwd_dx(xt.to("meta"), mxt, gxt, qt, pt, mqt, torch.tensor(gc),
                          SIG, True)


# ---------------------------------------------------------------------------
# the VJP's table kernels (csrc/rhs_ext.cu), emulated on the CPU
# ---------------------------------------------------------------------------

# float32 sums in another order than the plain version, relative to the
# largest |plain| output (chip_smoke.py's bound for the backward kernels)
TOL_BWD = 1e-4
GRID_SIGMA = 0.05


def _spiral_frame(n, d, support, seed, sigma=GRID_SIGMA):
    """One frame of the grid paths: a spiral cloud of n points (in the random
    order spiral_cloud draws them), ~10% masked with a padded tail, and its
    grid support at sigma (the grid paths' 0.05 by default) or a masked
    custom support of 500 points in its box; momenta and cotangents."""
    from difficp_torch.examples.run_large import spiral_cloud
    from difficp_torch.utils.point_sets import grid_support

    rng = np.random.default_rng(seed)
    x = spiral_cloud(n, rng, dim=d)
    mx = (rng.uniform(size=n) > 0.1).astype(np.float32)
    mx[-7:] = 0.0
    if support == "grid":
        q = grid_support(x, sigma)
        mq = np.ones(q.shape[0], np.float32)
    else:
        lo, hi = x.min(0), x.max(0)
        q = (lo + (hi - lo) * rng.uniform(size=(500, d))).astype(np.float32)
        mq = (rng.uniform(size=500) > 0.2).astype(np.float32)
    p = (0.05 * rng.normal(size=q.shape)).astype(np.float32) * mq[:, None]
    gx = rng.normal(size=x.shape).astype(np.float32)
    gc = np.float32(rng.normal())
    return _t(x, mx, gx, q, p, mq) + [float(gc)]


def _rel(x, ref):
    return float((x.double() - ref).abs().max() / ref.abs().max())


def _plain64(x, mx, gx, q, p, mq, gc, sigma, wl):
    f64 = [t.double() for t in (x, mx, gx, q, p, mq)]
    gc8 = torch.tensor(gc, dtype=torch.float64)
    return (RE.rhs_ext_bwd_dx_reference(*f64, gc8, sigma, wl),
            *RE.rhs_ext_bwd_dqdp_reference(*f64, gc8, sigma, wl))


def _kernel_layout(x, mx, q, mq, sigma):
    """What the kernels take at these shapes: dx's data rows in
    data_order of (x, mx) in blocks of dx_block_rows, the support's
    rows in rhs_self.row_order of (q, mq) in blocks of rhs_self.block_rows,
    the dq/dp chunks (dqdp_chunk_cols on an H100's 132 SMs); tiles of 64
    columns."""
    from difficp_torch.ops import rhs_self as RS

    order = RS.row_order(q, mq, sigma)
    rows = RS.block_rows(q)
    cols = RE.dqdp_chunk_cols(x.shape[0], -(-order.shape[0] // rows), 132)
    return dict(dx=dict(order=RE.data_order(x, mx, sigma), rows=RE.dx_block_rows(x)),
                dqdp=dict(order=order, rows=rows, chunk=cols))


def _schemes_meet_the_tolerance(d, support, sigma):
    from tf32_emulation import ext_table_scheme

    n = 4096 if d == 2 else 2048
    if d == 3 and support == "grid" and sigma < GRID_SIGMA:
        n = 1024  # its grid support has ~20,000 points at 2,048
    x, mx, gx, q, p, mq, gc = _spiral_frame(n, d, support, seed=d, sigma=sigma)
    lay = _kernel_layout(x, mx, q, mq, sigma)
    for wl in (True, False):
        rdx, rdq, rdp = _plain64(x, mx, gx, q, p, mq, gc, sigma, wl)
        args = (x, mx, gx, q, p, mq, gc, sigma, wl)
        (dx,) = ext_table_scheme(*args, "dx", **lay["dx"])
        dq, dp = ext_table_scheme(*args, "dqdp", **lay["dqdp"])
        assert _rel(dx, rdx) <= TOL_BWD
        assert max(_rel(dq, rdq), _rel(dp, rdp)) <= TOL_BWD
        assert bool((dx[mx == 0] == 0).all()) and bool((dq[mq == 0] == 0).all())


@pytest.mark.parametrize("support", ["grid", "custom"])
@pytest.mark.parametrize("d", [2, 3])
def test_ext_table_schemes_meet_the_tolerance(d, support):
    """The dx and dq/dp table kernels' float32 arithmetic, emulated
    (tests/tf32_emulation: each block's table centred on its rows' masked
    centroid, TF32 splits as tf32_rna, tiles summed in truncating
    accumulators, dq/dp's chunk partials summed in chunk order), on a spiral
    frame of 4,096 points (2,048 at d = 3) at the grid paths' sigma = 0.05,
    with its grid support and with a masked custom support, logdet on and
    off: dx, dq and dp within TOL_BWD of the float64 plain versions.  Both
    take their rows in a spatial order, as the kernels do."""
    _schemes_meet_the_tolerance(d, support, GRID_SIGMA)


@pytest.mark.parametrize("support", ["grid", "custom"])
@pytest.mark.parametrize("d", [2, 3])
def test_ext_table_schemes_meet_the_tolerance_at_half_sigma(d, support):
    """As test_ext_table_schemes_meet_the_tolerance at sigma = 0.025: the
    cloud twice as wide against the Gaussian, where the recombination's
    amplification of rounding is four times larger (1,024 points at d = 3
    with the grid support, whose support has ~20,000 points at 2,048)."""
    _schemes_meet_the_tolerance(d, support, GRID_SIGMA / 2)


def test_ext_table_scheme_needs_three_products():
    """The negative control: the same emulated scheme with one TF32 product
    (k_hi T_hi alone, no split of k and the table) puts dx above TOL_BWD, and
    dq/dp too, where the three products keep them within (test above)."""
    from tf32_emulation import ext_table_scheme

    x, mx, gx, q, p, mq, gc = _spiral_frame(4096, 2, "grid", seed=2)
    lay = _kernel_layout(x, mx, q, mq, GRID_SIGMA)
    rdx, rdq, _ = _plain64(x, mx, gx, q, p, mq, gc, GRID_SIGMA, True)
    args = (x, mx, gx, q, p, mq, gc, GRID_SIGMA, True)
    (dx,) = ext_table_scheme(*args, "dx", passes=1, **lay["dx"])
    dq, _ = ext_table_scheme(*args, "dqdp", passes=1, **lay["dqdp"])
    assert _rel(dx, rdx) > TOL_BWD and _rel(dq, rdq) > TOL_BWD


def test_dx_needs_the_data_order():
    """The negative control of dx's data order: the same emulated scheme
    with the data rows in their own (random) order, each block of 128 then
    spanning the whole cloud, puts dx's error at least 5x above the order's
    on a spiral frame of 16,384 points at sigma = 0.05 (the recombination
    amplifies the sums' rounding by (R / sigma)^2 for a block of radius R)."""
    from tf32_emulation import ext_table_scheme

    x, mx, gx, q, p, mq, gc = _spiral_frame(16384, 2, "grid", seed=4)
    lay = _kernel_layout(x, mx, q, mq, GRID_SIGMA)
    rdx = _plain64(x, mx, gx, q, p, mq, gc, GRID_SIGMA, True)[0]
    args = (x, mx, gx, q, p, mq, gc, GRID_SIGMA, True)
    (dx,) = ext_table_scheme(*args, "dx", **lay["dx"])
    (dx_natural,) = ext_table_scheme(*args, "dx", order=torch.arange(16384, dtype=torch.int32),
                                     rows=128)
    assert _rel(dx_natural, rdx) > 5 * _rel(dx, rdx)


@pytest.mark.parametrize("d", [2, 3])
def test_ext_tables_and_epilogues_match_pallas_mm_kernels(d, monkeypatch):
    """The kernels' tables and epilogues, with exact float64 sums in place of
    the tensor cores (tests/tf32_emulation ext_table_scheme, exact), against
    _ext_bwd_pallas (TPU row #7: _ext_bwd_dx_mm_kernel and
    _ext_bwd_dqdp_mm_kernel, interpret mode on the CPU, frame-centred as
    make_rhs_ext hands it the coordinates) within 1e-5 of the largest output;
    and within 1e-9 of the float64 plain versions.  The Pallas kernels run
    their payload products in the package's full-float32 mode ("highest"),
    at bench.py's sigma = 0.2 with the grid support at that sigma: there
    their own float32 error stays under 8e-7, where the default "split3" (a
    bf16 emulation of the TPU's matrix unit) floors at ~1e-5 on dx.  A spiral
    of 1,000 points, logdet on (gc != 0) and off."""
    import difficp_tpu.ops.pallas_reductions as PR
    from tf32_emulation import ext_table_scheme

    monkeypatch.setattr(PR, "_MM_MODE", "highest")
    sig = 0.2
    x, mx, gx, q, p, mq, gc = _spiral_frame(1000, d, "grid", seed=10 + d, sigma=sig)
    lay = _kernel_layout(x, mx, q, mq, sig)
    for wl in (True, False):
        rdx, rdq, rdp = _plain64(x, mx, gx, q, p, mq, gc, sig, wl)
        args = (x, mx, gx, q, p, mq, gc, sig, wl)
        (dx,) = ext_table_scheme(*args, "dx", exact=True, **lay["dx"])
        dq, dp = ext_table_scheme(*args, "dqdp", exact=True, **lay["dqdp"])
        qj, xj, mqj = jnp.asarray(q.numpy()), jnp.asarray(x.numpy()), jnp.asarray(mq.numpy())
        c = PR._mm_center(qj, mqj)
        jdq, jdp, jdx = PR._ext_bwd_pallas(qj - c, jnp.asarray(p.numpy()), xj - c, mqj,
                                           jnp.asarray(mx.numpy()), jnp.asarray(gx.numpy()),
                                           jnp.asarray(gc if wl else 0.0, jnp.float32), sig)
        for got, jax_ref, ref in ((dx, jdx, rdx), (dq, jdq, rdq), (dp, jdp, rdp)):
            _close(got, np.asarray(jax_ref), 1e-5)
            assert _rel(got, ref) <= 1e-9


def test_dqdp_chunks_fill_the_card():
    """dq/dp's split of the data axis: at the grid main path's shape (10
    frames of 65,536 points, 7 row blocks of 64 a frame) 31 chunks of 2,176
    columns, 2,170 blocks, more than two waves of 132 SMs; chunks are whole
    multiples of 64 columns, none shorter than 1,024 (one chunk below
    that)."""
    cols = RE.dqdp_chunk_cols(65536, 70, 132)
    assert cols == 2176 and 70 * -(-65536 // cols) == 2170 >= 2 * 132
    for n, blocks in ((5003, 2), (16381, 24), (1000, 6), (300, 1)):
        c = RE.dqdp_chunk_cols(n, blocks, 132)
        assert c % 64 == 0 and (c >= 1024 or c >= n) and -(-n // c) * c - n < c


def test_support_order_is_a_permutation_with_masked_rows_last():
    """The order dq/dp takes the support's rows in (rhs_self.row_order, as
    RHSExt receives it): per frame of a masked custom support, every row once,
    the masked rows after every unmasked one, -1 in the padding slots (the
    kernel takes the slots past the last as padding too)."""
    from difficp_torch.ops import rhs_self as RS

    frames = [_spiral_frame(2000, 2, "custom", seed=s) for s in (1, 2, 3)]
    q = torch.stack([f[3] for f in frames])
    mq = torch.stack([f[5] for f in frames])
    order = RS.row_order(q, mq, GRID_SIGMA)
    assert order.dtype == torch.int32 and order.shape[-1] >= q.shape[1]
    for k in range(3):
        o = order[k]
        rows = o[o >= 0].long()
        np.testing.assert_array_equal(np.sort(rows.numpy()), np.arange(q.shape[1]))
        on = (mq[k][rows] > 0).numpy()
        assert not (np.diff(on.astype(int)) > 0).any()  # no unmasked row after a masked one
        assert bool(((o >= 0) | (o == -1)).all())


def test_data_order_is_a_permutation_with_masked_rows_last():
    """The order dx takes the data rows in (data_order of (x, mx), as
    RHSExt receives it): per masked frame every row once, the masked rows
    after every unmasked one, -1 in the padding slots, at most
    DATA_ORDER_PAD_BUDGET of the rows in padding, and dx_block_rows dividing
    the order's runs (rhs_self.block_rows long)."""
    from difficp_torch.ops import rhs_self as RS

    frames = [_spiral_frame(3000, 2, "grid", seed=s) for s in (1, 2, 3)]
    x = torch.stack([f[0] for f in frames])
    mx = torch.stack([f[1] for f in frames])
    order = RE.data_order(x, mx, GRID_SIGMA)
    rows = RE.dx_block_rows(x)
    assert order.dtype == torch.int32
    assert x.shape[1] <= order.shape[-1] <= x.shape[1] * (1 + RE.DATA_ORDER_PAD_BUDGET)
    assert RS.block_rows(x) % rows == 0
    for k in range(3):
        o = order[k]
        kept = o[o >= 0].long()
        np.testing.assert_array_equal(np.sort(kept.numpy()), np.arange(x.shape[1]))
        on = (mx[k][kept] > 0).numpy()
        assert not (np.diff(on.astype(int)) > 0).any()  # no unmasked row after a masked one
        assert bool(((o >= 0) | (o == -1)).all())


def test_ext_route_bound_counts():
    """The table route's per-pair terms: three TF32 products of two FLOP on
    the padded table (16 columns for dx at d = 2 and 3, 16 and 24 for dq/dp),
    3d + 2 FP32 operations, one exponential; at the grid main path's 10 x
    65,536 x 380 pairs (4.1875e12 exponentials a second, 495 TFLOP/s TF32,
    67 TFLOP/s FP32) the MUFU bounds both at 0.0595 ms, the tensor cores
    0.0483 and the FP32 pipe 0.0297."""
    from difficp_torch.ops import ksum as KS

    assert [RE.tensor_flops_per_pair(d, w) for d in (2, 3) for w in ("dx", "dqdp")] == [
        96, 96, 96, 144]
    assert (len(RE.dx_table(2)), len(RE.dx_table(3)), len(RE.dqdp_table(2)),
            len(RE.dqdp_table(3))) == (9, 16, 12, 22)
    pairs = 10 * 65536 * 380.0
    terms = {"mufu": pairs / 4.1875e12,
             "tensor": pairs * RE.tensor_flops_per_pair(2, "dqdp") / 495e12,
             "fp32": pairs * KS.fp32_ops_per_pair(2) / 67e12}
    assert max(terms, key=terms.get) == "mufu"
    for key, want in (("mufu", 0.0595), ("tensor", 0.0483), ("fp32", 0.0297)):
        assert abs(1e3 * terms[key] - want) < 1e-4


def test_table_bound_is_the_lower_of_least_work_and_route():
    """chip_smoke.py's bound of a table kernel is the lower of the
    function's least work on the FP32 pipe and the table route's own: at
    the grid main path's 10 x 65,536 x 380 pairs dx's least work (9d + 1
    FP32 operations a pair) gives 0.0706 ms and dq/dp's (9d + 3) 0.0781 ms,
    the route's MUFU term 0.0595 ms for both, which is their bound_ms; a
    route slower than the least work (the self backward's tensor cores at
    d = 2, over twice the pairs) leaves the least work's."""
    import runpy
    from pathlib import Path

    from difficp_torch.ops import rhs_self as RS

    cs = runpy.run_path(str(Path(__file__).resolve().parents[1] / "chip_smoke.py"),
                        run_name="not_main")
    pairs, nbytes = 10 * 65536 * 380.0, 4.0 * 10 * 65536 * 7
    for which, ops, least_ms in (("dx", RE.dx_ops_per_pair(2), 0.0706),
                                 ("dqdp", RE.dqdp_ops_per_pair(2), 0.0781)):
        least = cs["bound"](pairs, ops, pairs, nbytes)
        bd = cs["table_bound"](least, pairs, 2, RE.tensor_flops_per_pair(2, which))
        assert abs(bd["bound_least_work_ms"] - least_ms) < 1e-4
        assert bd["bound_route_by"] == "mufu" and bd["bound_by"] == "operations"
        assert bd["bound_ms"] == bd["bound_route_ms"] and abs(bd["bound_ms"] - 0.0595) < 1e-4
    upairs = 65536 * 65535 / 2.0
    least = cs["bound"](upairs, RS.bwd_ops_per_unordered_pair(2), upairs, 4.0 * 65536 * 13)
    bd = cs["table_bound"](least, 65536.0 ** 2, 2, RS.tensor_flops_per_pair(2, True))
    assert bd["bound_route_ms"] > least["bound_ms"] == bd["bound_ms"]
