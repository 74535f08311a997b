"""The gradcomponent (eta != 0) model's ops against the JAX package:
RHSSelf, RHSExt and v_field at eta != 0, values and gradients, on both of
their routes (the any-eta kernels, and the generated kernel-sums with the
size gates lowered to 1) against make_rhs_self, make_rhs_ext and
make_v_field run as tests/test_eta_scale.py runs them (Pallas in interpret
mode on the CPU); v2p with the gradcomponent right-hand side; the self
forward at a v2p start.  The registrations are in test_torch_eta_psr.py,
the API entries in test_torch_eta_api.py.

On the CPU the kernel route takes the kernels' plain PyTorch versions; the
CUDA kernels are checked against those on the card (tests/test_torch_cuda.py
and chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import difficp_tpu.ops.pair_poly as JPP
import difficp_tpu.ops.pallas_reductions as PR
from difficp_tpu.models import lddmm as jl
from difficp_tpu.ops import backend as JB
from difficp_tpu.ops.pallas_ksum import make_v_field
from difficp_torch.models import lddmm as tl
from difficp_torch.ops import backend as TB
from difficp_torch.ops import ksum as KS
from difficp_torch.ops import pair_poly as PP
from difficp_torch.ops import reductions as TR
from difficp_torch.ops import rhs_ext as RE
from difficp_torch.ops import rhs_self as RS

torch.set_num_threads(1)

SIG = 0.5
ETA = 0.07  # tests/test_eta_scale.py's


def _data(m, d, seed):
    """tests/test_eta_scale.py's data(): q normal, p 0.3-normal on unmasked
    rows, ~20% masked."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(m, d)).astype(np.float32)
    mask = (rng.uniform(size=m) > 0.2).astype(np.float32)
    p = (rng.normal(size=(m, d)) * 0.3).astype(np.float32) * mask[:, None]
    return q, p, mask


def _close(x, ref, rtol):
    """|x - ref| <= rtol (|ref| + max|ref|): float32 sums in two orders."""
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(x, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


@pytest.fixture(params=["kernel", "poly"])
def route(request, monkeypatch):
    """The any-eta forward kernels, or (gates at 1, in both packages) the
    generated self and ext forwards, the self forward through the symmetric
    table.  Exact float32 products on the JAX side
    (tests/test_pair_poly.py:47-50)."""
    monkeypatch.setattr(PR, "_MM_MODE", "highest")
    if request.param == "poly":
        for mod in (PR, RS):
            monkeypatch.setattr(mod, "_POLY_FWD_MIN_M", 1)
        for mod in (JPP, PP):
            monkeypatch.setattr(mod, "_SYM_MIN_M", 1)
    return request.param


# values: 2e-4 for the any-eta kernels (tests/test_eta_scale.py), 1e-3 for
# the generated forwards (tests/test_pair_poly.py); gradients 1e-2, the bound
# of tests/test_pair_poly.py::test_make_rhs_self_eta_grads_end_to_end
VAL_TOL = {"kernel": 2e-4, "poly": 1e-3}
GRAD_TOL = 1e-2


@pytest.mark.parametrize("withlogdet", [False, True])
@pytest.mark.parametrize("d", [2, 3])
def test_rhs_self_eta_matches_jax(d, withlogdet, route):
    """RHSSelf at eta != 0 against make_rhs_self: (v, -Gq, dcost) and the VJP
    for random cotangents, two frames of 130 points."""
    frames = [_data(130, d, seed) for seed in (1, 2)]
    q, p, m = (np.stack(a) for a in zip(*frames))
    r = np.random.default_rng(d)
    gv, gg = (r.normal(size=q.shape).astype(np.float32) for _ in range(2))
    gc = r.normal(size=2).astype(np.float32)
    qt, pt = (t.clone().requires_grad_(True) for t in _t(q, p))
    out = RS.RHSSelf.apply(qt, pt, torch.as_tensor(m), SIG, withlogdet, ETA)
    loss = (out[0] * torch.as_tensor(gv)).sum() + (out[1] * torch.as_tensor(gg)).sum() \
        + (out[2] * torch.as_tensor(gc)).sum()
    gq, gp = torch.autograd.grad(loss, (qt, pt))
    op = PR.make_rhs_self(SIG, ETA, withlogdet, ti=64, tj=64)
    for k in range(2):
        want, vjp = jax.vjp(lambda a, b: op(a, b, jnp.asarray(m[k])),
                            jnp.asarray(q[k]), jnp.asarray(p[k]))
        for g, w in zip(out[:2], want[:2]):
            _close(g[k].detach().numpy(), w, VAL_TOL[route])
        np.testing.assert_allclose(float(out[2][k].detach()), float(want[2]),
                                   rtol=VAL_TOL[route], atol=1e-5)
        wq, wp = vjp((jnp.asarray(gv[k]), jnp.asarray(gg[k]), jnp.asarray(gc[k])))
        _close(gq[k].numpy(), wq, GRAD_TOL)
        _close(gp[k].numpy(), wp, GRAD_TOL)


@pytest.mark.parametrize("withlogdet", [False, True])
def test_rhs_ext_eta_matches_jax(withlogdet, route):
    """RHSExt at eta != 0 against make_rhs_ext: (v, -Gq, dcost, vx) and the
    VJP, two frames of 120 data points on 90 support points."""
    r = np.random.default_rng(5)
    q, p, mq = (np.stack(a) for a in zip(*[_data(90, 2, s) for s in (3, 4)]))
    x = r.normal(size=(2, 120, 2)).astype(np.float32)
    mx = (r.uniform(size=(2, 120)) > 0.2).astype(np.float32)
    cots = [r.normal(size=q.shape).astype(np.float32) for _ in range(2)] + [
        r.normal(size=2).astype(np.float32), r.normal(size=x.shape).astype(np.float32)]
    qt, pt, xt = (t.clone().requires_grad_(True) for t in _t(q, p, x))
    out = RE.RHSExt.apply(qt, pt, xt, *_t(mq, mx), SIG, withlogdet, ETA)
    loss = sum((o * c).sum() for o, c in zip(out, _t(*cots)))
    grads = torch.autograd.grad(loss, (qt, pt, xt))
    op = PR.make_rhs_ext(SIG, ETA, withlogdet, ti=64, tj=64)
    for k in range(2):
        want, vjp = jax.vjp(lambda a, b, c: op(a, b, c, jnp.asarray(mq[k]), jnp.asarray(mx[k])),
                            jnp.asarray(q[k]), jnp.asarray(p[k]), jnp.asarray(x[k]))
        for i in (0, 1, 3):
            _close(out[i][k].detach().numpy(), want[i], VAL_TOL[route])
        np.testing.assert_allclose(float(out[2][k].detach()), float(want[2]),
                                   rtol=VAL_TOL[route], atol=1e-5)
        wants = vjp(tuple(jnp.asarray(c[k]) for c in cots))
        for g, w in zip(grads, wants):
            _close(g[k].numpy(), w, GRAD_TOL)


def test_v_field_eta_matches_jax():
    """v_field at eta != 0 through the kernel route (the any-eta forward; the
    generated ext backward with a zero dcost cotangent) against
    make_v_field (whose backward is a blockwise VJP): values rtol 2e-4,
    gradients 1e-3 (tests/test_ksum.py::test_v_field_mm_value_and_grads)."""
    r = np.random.default_rng(8)
    q, p, mq = _data(70, 2, 9)
    x = r.normal(size=(2, 80, 2)).astype(np.float32)
    g = r.normal(size=x.shape).astype(np.float32)
    qq, pp, mm = (np.stack([a, a]) for a in (q, p, mq))
    xt, qt, pt = (t.clone().requires_grad_(True) for t in _t(x, qq, pp))
    TB.set_backend("kernel")
    try:
        v = TB.v_field(xt, qt, pt, SIG, ETA, torch.as_tensor(mm))
    finally:
        TB.set_backend(None)
    gx, gq, gp = torch.autograd.grad((v * torch.as_tensor(g)).sum(), (xt, qt, pt))
    op = make_v_field(SIG, ETA)
    for k in range(2):
        want, vjp = jax.vjp(lambda a, b, c: op(a, b, c, jnp.asarray(mq)),
                            jnp.asarray(x[k]), jnp.asarray(q), jnp.asarray(p))
        _close(v[k].detach().numpy(), want, 2e-4)
        for got, w in zip((gx, gq, gp), vjp(jnp.asarray(g[k]))):
            _close(got[k].numpy(), w, 1e-3)


@pytest.mark.parametrize("backend", [None, "kernel"])
def test_v2p_eta_matches_jax(backend):
    """v2p with the gradcomponent right-hand side v + eta grad_kred(q, q), on
    the dense route and with grad_kred on the kernel route (the JAX package
    forced to its Pallas route), pinv: the speeds the momenta produce agree
    to 1e-4 of the largest right-hand side (tests/test_torch_grid.py's pinv
    bound), for a random field and for the zero field of initialize_a0,
    whose momenta are not zero."""
    cfg_t, cfg_j = (m.make_config(sigma=0.4, lambd=5.0, version="logdet") for m in (tl, jl))
    q, _, _ = _data(60, 2, 11)
    q = 0.4 * q
    vt = (0.1 * np.random.default_rng(12).normal(size=q.shape)).astype(np.float32)
    qt = torch.as_tensor(q)[None]
    TB.set_backend(backend)
    JB.set_backend(None if backend is None else "pallas")
    try:
        # the zero field's solve reads the gradcomponent right-hand side
        gk = cfg_t.eta * TR.grad_kred(qt, qt, cfg_t.sigma)[0].numpy()
        for target in (vt, np.zeros_like(vt)):
            got = tl.v2p(cfg_t, qt, torch.as_tensor(target)[None])
            ref = np.array(jl.v2p(cfg_j, jnp.asarray(q), jnp.asarray(target)))
            speed = tl.v(cfg_t, qt, qt, got)[0].numpy()
            speed_ref = tl.v(cfg_t, qt, qt, torch.as_tensor(ref)[None])[0].numpy()
            scale = np.abs(target + gk).max()
            np.testing.assert_allclose(speed, speed_ref, rtol=0, atol=1e-4 * scale)
            assert float(got.abs().max()) > 0.0
    finally:
        TB.set_backend(None)
        JB.set_backend(None)


def test_self_forward_routes_as_jax_at_the_v2p_start(monkeypatch):
    """RHSSelf's forward at eta != 0 routes as make_rhs_self: the any-eta
    kernel below _POLY_FWD_MIN_M points, the generated forward (symmetric
    table) from there on, each bit for bit.  At the start momenta of a
    gradcomponent registration (v2p of a zero field, dense support of 1,024
    spiral points, the dense eta path's sigma and lambda), where (v, -Gq)
    nearly cancel, the generated forward's error against float64 is no worse
    than twice the JAX package's own generated forward on the same inputs
    (the precision criterion of test_torch_pair_poly.py)."""
    from difficp_torch.examples.run_large import spiral_cloud

    monkeypatch.setattr(PR, "_MM_MODE", "highest")
    cfg = tl.make_config(sigma=0.1, lambd=200.0, version="logdet")
    q = torch.as_tensor(spiral_cloud(1024, np.random.default_rng(0)))[None]
    m = torch.ones(q.shape[:-1])
    a0 = tl.v2p(cfg, q, torch.zeros_like(q), rcond=1e-3, qmask=m)
    ref = TR.lddmm_rhs_self(q.double(), a0.double(), cfg.sigma, cfg.eta, True, m.double())

    def err(got):
        return np.array([float(np.abs(np.asarray(g, np.float64) - r[0].numpy()).max()
                               / np.abs(r[0].numpy()).max()) for g, r in zip(got, ref[:2])])

    direct = RS.rhs_self_fwd_reference(q, a0, m, cfg.sigma, True, cfg.eta)
    got = RS.RHSSelf.apply(q, a0, m, cfg.sigma, True, cfg.eta)
    for g, d in zip(got[:2], direct[:2]):
        assert torch.equal(g, d)
    for mod in (PR, RS):
        monkeypatch.setattr(mod, "_POLY_FWD_MIN_M", 1)
    for mod in (JPP, PP):
        monkeypatch.setattr(mod, "_SYM_MIN_M", 1)
    qc = q - KS.mm_center(q, m)
    gen = PP.rhs_self_fwd_poly(qc, a0, m, cfg.sigma, cfg.eta, True)
    got = RS.RHSSelf.apply(q, a0, m, cfg.sigma, True, cfg.eta)
    assert torch.equal(got[0], gen[0]) and torch.equal(got[1], -gen[1])
    op = PR.make_rhs_self(cfg.sigma, cfg.eta, True, ti=256, tj=256)
    want = op(jnp.asarray(q[0].numpy()), jnp.asarray(a0[0].numpy()), jnp.asarray(m[0].numpy()))
    port_err, jax_err = err([g[0].numpy() for g in got[:2]]), err(want[:2])
    assert (port_err <= 2.0 * jax_err + 1e-7).all(), (port_err, jax_err)
