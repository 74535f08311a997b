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
    two sets, which no path runs above the limit, raises."""
    x, q, p, mx, mq, *_ = _inputs(64, 20, 2, seed=2)
    xt, qt, pt, mxt, mqt = (t[None] for t in _t(x, q, p, mx, mq))
    try:
        dense = TB.lddmm_rhs_ext(qt, pt, xt, SIG, 0.0, True, mqt, mxt)
        v_dense = TB.v_field(xt, qt, pt, SIG, 0.0, mqt)
        k_dense = TB.kred(qt, qt, pt, SIG, mqt)
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
        with pytest.raises(NotImplementedError, match="kernel op layer"):
            TB.kred(xt, qt, pt, SIG, mqt)
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
