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
    """Dense at or under the pair limit, the kernel Functions when forced,
    NotImplementedError for routes that are not ported."""
    q, p, mask, *_ = _inputs(64, 2, seed=2)
    qt, pt, mt = _t(q, p, mask)
    try:
        dense = TB.lddmm_rhs_self(qt, pt, SIG, 0.0, True, mt)
        TB.set_backend("kernel")
        kern = TB.lddmm_rhs_self(qt, pt, SIG, 0.0, True, mt)
        assert kern[0].grad_fn is not None or not kern[0].requires_grad
        for x, r in zip(kern, dense):
            _close(x, r, 1e-5)
        with pytest.raises(NotImplementedError):
            TB.lddmm_rhs_self(qt, pt, SIG, 0.5, True, mt)
        with pytest.raises(NotImplementedError):
            TB.second_min_sqdist(qt, mt)
        with pytest.raises(NotImplementedError):
            TB.set_backend("blockwise")
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
