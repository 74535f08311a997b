"""The dense pair reductions of the port (ops/reductions.py), the kernel
route's KRed, kred_scal and mdivsum (ops/ksum.py, their plain versions on the
CPU) and point_set_distance, against the JAX package.

Mirrors tests/test_reductions.py (test_kbase ... test_gradlapk_red,
test_mdivsum_is_minus_divergence, test_masked_equals_subset) and
tests/test_point_sets.py (the blurred distance against brute force, zero on
identical sets, the intrinsic-scale warning).  Tolerances: the dense
reductions and the kernel route against JAX within 1e-5 of the largest
reference entry (float32 sums in another order), values and gradients; the
brute-force and identity checks with the JAX tests' own bounds.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difficp_tpu.ops import backend as JB
from difficp_tpu.ops import reductions as R
from difficp_tpu.utils import point_sets as JP
from difficp_torch.ops import backend as TB
from difficp_torch.ops import ksum as KS
from difficp_torch.ops import reductions as TR
from difficp_torch.utils import point_sets as TP

torch.set_num_threads(1)

M, N, D, SIG = 17, 29, 2, 0.7
RTOL = 1e-5
rng = np.random.default_rng(0)
X = rng.normal(size=(M, D)).astype(np.float32)
Y = rng.normal(size=(N, D)).astype(np.float32)
B = rng.normal(size=(N, D)).astype(np.float32)
C = rng.normal(size=(M, D)).astype(np.float32)
P = rng.normal(size=(M, D)).astype(np.float32)
DSCAL = rng.normal(size=(N,)).astype(np.float32)
MASK_X = (rng.uniform(size=M) > 0.3).astype(np.float32)
MASK_Y = (rng.uniform(size=N) > 0.3).astype(np.float32)


def _t(*arrays):
    return [torch.as_tensor(np.array(a, np.float32)) for a in arrays]


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


# each reduction's point and payload arguments (sigma and the mask follow)
REDUCTIONS = {
    "kbase": (X, Y),
    "kred_scal": (X, Y, DSCAL),
    "kred": (X, Y, B),
    "grad_kred": (X, Y),
    "grad_kred_rev": (X, Y, C),
    "ddkred": (X, Y, B),
    "gendk_red": (X, Y, B, C),
    "hessk_red": (X, Y, B, C),
    "lapk_red": (X, Y),
    "gradlapk_red": (X, Y),
}


@pytest.mark.parametrize("name", list(REDUCTIONS))
@pytest.mark.parametrize("masked", [False, True])
def test_dense_reduction_matches_jax(name, masked):
    """Each dense reduction against the JAX package's on the same inputs
    (grad_kred_rev's mask on x, every other's on y), and with a leading axis
    of two frames (the second with the rows reversed) equal to two calls."""
    args = REDUCTIONS[name]
    mask = (MASK_X if name == "grad_kred_rev" else MASK_Y) if masked else None
    want = getattr(R, name)(*(jnp.asarray(a) for a in args), SIG,
                            None if mask is None else jnp.asarray(mask))
    targs = _t(*args)
    tmask = None if mask is None else _t(mask)[0]
    got = getattr(TR, name)(*targs, SIG, tmask)
    _close(got.numpy(), want)
    # two frames: the rows of x and of its payloads reversed in the second
    rev = [a.flip(0) if a.shape[0] == M else a for a in targs]
    stacked = [torch.stack([a, r]) for a, r in zip(targs, rev)]
    tm2 = None if tmask is None else torch.stack([tmask, tmask.flip(0) if
                                                  name == "grad_kred_rev" else tmask])
    both = getattr(TR, name)(*stacked, SIG, tm2)
    _close(both[0].numpy(), got.numpy(), 1e-6)
    _close(both[1].numpy(), getattr(TR, name)(*rev, SIG, None if tm2 is None else tm2[1]),
           1e-6)


@pytest.mark.parametrize("eta", [0.0, 0.37])
def test_mdivsum_matches_jax(eta):
    mx, mq = _t(MASK_Y, MASK_X)
    got = TR.mdivsum(*_t(Y, X, P), SIG, eta, mask_q=mq, mask_x=mx)
    want = R.mdivsum(jnp.asarray(Y), jnp.asarray(X), jnp.asarray(P), SIG, eta,
                     mask_q=jnp.asarray(MASK_X), mask_x=jnp.asarray(MASK_Y))
    _close(float(got), float(want))


def test_mdivsum_is_minus_divergence():
    """The numeric divergence of v at the data points y (the JAX test's
    central differences and bound)."""
    eps = 1e-3
    xt, yt, pt = _t(X, Y, P)

    def v_at(pts):
        return TR.v_field(pts, xt, pt, SIG, 0.0).numpy()

    div = np.zeros(N)
    for d in range(D):
        e = torch.zeros(D)
        e[d] = eps
        div += (v_at(yt + e)[:, d] - v_at(yt - e)[:, d]) / (2 * eps)
    want = -div.sum()
    got = float(TR.mdivsum(yt, xt, pt, SIG, 0.0))
    assert abs(got - want) < 1e-2 * max(1.0, abs(want))


def test_masked_equals_subset():
    mask = _t(MASK_Y)[0]
    idx = np.nonzero(MASK_Y)[0]
    xt, yt, bt, pt = _t(X, Y, B, P)
    _close(TR.kbase(xt, yt, SIG, mask), TR.kbase(xt, yt[idx], SIG), 1e-4)
    _close(TR.kred(xt, yt, bt, SIG, mask), TR.kred(xt, yt[idx], bt[idx], SIG), 1e-4)
    _close(TR.kred_scal(xt, yt, bt[:, 0], SIG, mask), TR.kred_scal(xt, yt[idx],
                                                                   bt[idx, 0], SIG), 1e-4)
    _close(TR.grad_kred(xt, yt, SIG, mask), TR.grad_kred(xt, yt[idx], SIG), 1e-4)
    _close(TR.lapk_red(xt, yt, SIG, mask), TR.lapk_red(xt, yt[idx], SIG), 1e-4)
    _close(float(TR.mdivsum(yt, xt, pt, SIG, 0.3, mask_x=mask)),
           float(TR.mdivsum(yt[idx], xt, pt, SIG, 0.3)), 1e-3)


# ---------------------------------------------------------------------------
# the kernel route above the pair limit (forced), against JAX's blockwise
# ---------------------------------------------------------------------------

def _jax_vjp(fn, primals, cot):
    JB.set_backend("blockwise")
    try:
        out, vjp = jax.vjp(fn, *primals)
        return out, vjp(cot)
    finally:
        JB.set_backend(None)


@pytest.mark.parametrize("case", ["two_sets", "masked", "self"])
def test_kred_matches_jax(case):
    """KRed (backend.kred between two sets above the limit; for x is y the
    Function itself, which kred_scal takes there, while backend.kred(q, q)
    keeps the self kernel) through its plain version against the JAX
    package's blockwise route: values and the gradients in x, y and b (in the
    one tensor when x is y), on two frames (the port's one call against two
    JAX calls)."""
    g = np.random.default_rng(5)
    frames = 2
    xs = g.normal(size=(frames, M, D)).astype(np.float32)
    ys = xs if case == "self" else g.normal(size=(frames, N, D)).astype(np.float32)
    n = ys.shape[1]
    bs = g.normal(size=(frames, n, 3)).astype(np.float32)
    my = (g.uniform(size=(frames, n)) > 0.3).astype(np.float32) if case == "masked" else None
    cot = g.normal(size=(frames, M, 3)).astype(np.float32)

    xt = torch.tensor(xs, requires_grad=True)
    yt = xt if case == "self" else torch.tensor(ys, requires_grad=True)
    bt = torch.tensor(bs, requires_grad=True)
    TB.set_backend("kernel")
    try:
        kred = KS.kred if case == "self" else TB.kred
        out = kred(xt, yt, bt, SIG, None if my is None else torch.tensor(my))
    finally:
        TB.set_backend(None)
    assert out.grad_fn is not None  # the generic kernel-sum, not the self kernel
    grads = torch.autograd.grad((out * torch.tensor(cot)).sum(),
                                [xt, bt] if case == "self" else [xt, yt, bt])
    for k in range(frames):
        mk = None if my is None else jnp.asarray(my[k])
        if case == "self":
            fn = lambda a, b: JB.kred(a, a, b, SIG, mk)  # noqa: E731
            want, (dx, db) = _jax_vjp(fn, (jnp.asarray(xs[k]), jnp.asarray(bs[k])),
                                      jnp.asarray(cot[k]))
            wants = [dx, db]
        else:
            fn = lambda a, c, b: JB.kred(a, c, b, SIG, mk)  # noqa: E731
            want, wants = _jax_vjp(fn, tuple(jnp.asarray(a[k]) for a in (xs, ys, bs)),
                                   jnp.asarray(cot[k]))
        _close(out[k].detach().numpy(), want)
        for got, ref in zip(grads, wants):
            _close(got[k].numpy(), ref)


def test_kred_scal_matches_jax():
    """kred_scal (a scalar payload through KRed, the data_distance term
    <fy, fx>) against the JAX blockwise route, value and gradients, and the
    self kernel's route for kred(q, q) untouched."""
    xs, ys, ds = (jnp.asarray(a) for a in (X, Y, DSCAL))
    xt, yt, dt = (torch.tensor(a, requires_grad=True) for a in (X, Y, DSCAL))
    cot = np.random.default_rng(2).normal(size=(M,)).astype(np.float32)
    TB.set_backend("kernel")
    try:
        out = TB.kred_scal(xt, yt, dt, SIG)
        # kred(q, q) stays on the self forward kernel (no gradient)
        assert TB.kred(xt.detach(), xt.detach(), _t(P)[0], SIG).grad_fn is None
    finally:
        TB.set_backend(None)
    grads = torch.autograd.grad((out * torch.tensor(cot)).sum(), [xt, yt, dt])
    want, wants = _jax_vjp(lambda a, b, c: JB.kred_scal(a, b, c, SIG), (xs, ys, ds),
                           jnp.asarray(cot))
    _close(out.detach().numpy(), want)
    for got, ref in zip(grads, wants):
        _close(got.numpy(), ref)


@pytest.mark.parametrize("eta", [0.0, 0.37])
def test_mdivsum_kernel_route_matches_jax(eta):
    """mdivsum on the kernel route (the generated kernel-sums' plain
    versions) against the JAX blockwise route: the value and dx, dq, dp, with
    masks on both sides, on two frames."""
    g = np.random.default_rng(3)
    xs = g.normal(size=(2, N, D)).astype(np.float32)
    qs = g.normal(size=(2, M, D)).astype(np.float32)
    ps = g.normal(size=(2, M, D)).astype(np.float32)
    mq = (g.uniform(size=(2, M)) > 0.2).astype(np.float32)
    mx = (g.uniform(size=(2, N)) > 0.2).astype(np.float32)
    xt, qt, pt = (torch.tensor(a, requires_grad=True) for a in (xs, qs, ps))
    TB.set_backend("kernel")
    try:
        out = TB.mdivsum(xt, qt, pt, SIG, eta, *_t(mq, mx))
    finally:
        TB.set_backend(None)
    cot = torch.tensor([0.7, -1.3])
    grads = torch.autograd.grad((out * cot).sum(), [xt, qt, pt])
    for k in range(2):
        fn = lambda a, b, c: JB.mdivsum(a, b, c, SIG, eta, jnp.asarray(mq[k]),  # noqa: E731
                                        jnp.asarray(mx[k]))
        want, wants = _jax_vjp(fn, tuple(jnp.asarray(a[k]) for a in (xs, qs, ps)),
                               jnp.asarray(float(cot[k])))
        _close(float(out[k]), float(want))
        for got, ref in zip(grads, wants):
            _close(got[k].numpy(), ref)


def test_ksum_module_exports_the_standard_ops():
    """kred / kred_scal / mdivsum on a CPU tensor take the plain versions and
    agree with the dense reductions (one frame, no mask)."""
    xt, yt, bt, pt = _t(X, Y, B, P)
    _close(KS.kred(xt, yt, bt, SIG).detach(), TR.kred(xt, yt, bt, SIG))
    _close(KS.kred_scal(xt, yt, bt[:, 0], SIG).detach(), TR.kred_scal(xt, yt, bt[:, 0], SIG))
    _close(float(KS.mdivsum(yt, xt, pt, SIG, 0.0)), float(TR.mdivsum(yt, xt, pt, SIG, 0.0)))


# ---------------------------------------------------------------------------
# point_set_distance (tests/test_point_sets.py:25,49,83)
# ---------------------------------------------------------------------------

PX = rng.normal(size=(40, 2)).astype(np.float32)
PY = rng.normal(size=(30, 2)).astype(np.float32)


def test_point_set_distance_bruteforce():
    """The closed-form L2 distance of Gaussian-blurred clouds (reference
    point_sets.py:46-95) against a brute-force loop and the JAX package's."""
    sx, sy = 0.4, 0.3

    def blur_ip(a, b, sa, sb):
        s = np.sqrt(sa**2 + sb**2)
        c = 1.0 / ((2 * np.pi) ** (a.shape[1] / 2) * s ** a.shape[1])
        z2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return c * np.exp(-z2 / (2 * s**2)).sum() / (a.shape[0] * b.shape[0])

    want = blur_ip(PX, PX, sx, sx) + blur_ip(PY, PY, sy, sy) - 2 * blur_ip(PX, PY, sx, sy)
    got = float(TP.point_set_distance(*_t(PX, PY), sigma_x=sx, sigma_y=sy))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    jwant = float(JP.point_set_distance(PX, PY, sigma_x=sx, sigma_y=sy))
    np.testing.assert_allclose(got, jwant, rtol=1e-5)


def test_point_set_distance_zero_on_identical():
    xt = _t(PX)[0]
    assert abs(float(TP.point_set_distance(xt, xt, sigma_x=0.3, sigma_y=0.3))) < 1e-5


def test_point_set_distance_intrinsic_scale_warning():
    """A blur below the set's intrinsic (mean nearest-neighbour) scale warns,
    as the JAX package's; at or above it stays silent; None takes it."""
    xt, yt = _t(PX, PY)
    s_int = TP.intrinsic_scale(xt)
    np.testing.assert_allclose(s_int, JP.intrinsic_scale(PX), rtol=1e-6)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        TP.point_set_distance(xt, yt, sigma_x=0.1 * s_int, sigma_y=1.0)
    assert any("intrinsic scale" in str(w.message) for w in rec)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = TP.point_set_distance(xt, yt, sigma_x=2.0 * s_int,
                                    sigma_y=2.0 * TP.intrinsic_scale(yt))
        default = TP.point_set_distance(xt, yt)
    assert not [w for w in rec if "intrinsic scale" in str(w.message)]
    np.testing.assert_allclose(float(default), float(JP.point_set_distance(PX, PY)),
                               rtol=1e-5)
    assert np.isfinite(float(got))
