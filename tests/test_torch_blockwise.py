"""The port's blockwise route (difficp_torch/ops/blockwise.py) against its
dense reductions and against the JAX package's blockwise functions on the
same inputs: values (rtol 1e-4 / atol 1e-5) and gradients (rtol 1e-3 / atol
1e-4), the bars of tests/test_blockwise.py; the tiled minima as
tests/test_streaming.py:44-66 holds them (rtol 1e-6, duplicates kept).  Also:
the checkpointed backward keeps the tiles' inputs, not their temporaries;
the forced route (set_backend("blockwise")) takes every dispatch and no row
order; icp_atlas with computversion="blockwise" against the JAX package's
(FE within 5e-3); and backward_precision="accurate" on the forced kernel
route against the blockwise route's gradients.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from difficp_tpu.api.icp_atlas import icp_atlas as j_icp_atlas
from difficp_tpu.ops import backend as JB
from difficp_tpu.ops import blockwise as JBW
from difficp_torch.api.icp_atlas import icp_atlas as t_icp_atlas
from difficp_torch.ops import backend as TB
from difficp_torch.ops import blockwise as B
from difficp_torch.ops import reductions as R

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
SPIRAL = np.load(os.path.join(HERE, "goldens", "spiral.npz"))

rng = np.random.default_rng(0)
K, M, N, D = 2, 130, 70, 2  # deliberately not multiples of the tile
TILE = 32
NQ = rng.normal(size=(K, M, D)).astype(np.float32)
NP = (rng.normal(size=(K, M, D)) * 0.3).astype(np.float32)
NX = rng.normal(size=(K, N, D)).astype(np.float32)
NMQ = (rng.uniform(size=(K, M)) > 0.2).astype(np.float32)
NMX = (rng.uniform(size=(K, N)) > 0.2).astype(np.float32)
SIG = 0.6
VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


Q, P, X, MQ, MX = map(_t, (NQ, NP, NX, NMQ, NMX))


def _jax(fn, *arrays, **kw):
    """The JAX package's blockwise function on each frame, stacked."""
    outs = [fn(*(jnp.asarray(a[k]) for a in arrays), **kw) for k in range(K)]
    if isinstance(outs[0], tuple):
        return tuple(np.stack([np.asarray(o[i]) for o in outs]) for i in range(len(outs[0])))
    return np.stack([np.asarray(o) for o in outs])


def _close(got, *refs, tol=VAL):
    for ref in refs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **tol)


@pytest.fixture(autouse=True)
def _reset_routes():
    yield
    TB.set_backend(None)
    TB.set_bwd_precision("fast")


@pytest.mark.parametrize("eta", [0.0, 0.4])
@pytest.mark.parametrize("withlogdet", [False, True])
def test_rhs_self_matches_dense_and_jax(eta, withlogdet):
    got = B.lddmm_rhs_self(Q, P, SIG, eta, withlogdet, MQ, tile=TILE)
    dense = R.lddmm_rhs_self(Q, P, SIG, eta, withlogdet, MQ)
    jax_out = _jax(lambda q, p, m: JBW.lddmm_rhs_self(q, p, SIG, eta, withlogdet, m, tile=TILE),
                   NQ, NP, NMQ)
    for g, d, j in zip(got, dense, jax_out):
        _close(g, d.numpy(), j)


@pytest.mark.parametrize("eta", [0.0, 0.4])
@pytest.mark.parametrize("withlogdet", [False, True])
def test_rhs_ext_matches_dense_and_jax(eta, withlogdet):
    got = B.lddmm_rhs_ext(Q, P, X, SIG, eta, withlogdet, MQ, MX, tile=TILE)
    dense = R.lddmm_rhs_ext(Q, P, X, SIG, eta, withlogdet, MQ, MX)
    jax_out = _jax(lambda q, p, x, mq, mx: JBW.lddmm_rhs_ext(q, p, x, SIG, eta, withlogdet, mq,
                                                             mx, tile=TILE),
                   NQ, NP, NX, NMQ, NMX)
    for g, d, j in zip(got, dense, jax_out):
        _close(g, d.numpy(), j)


@pytest.mark.parametrize("eta", [0.0, 0.3])
def test_rhs_cross_sums_to_self_and_matches_jax(eta):
    """The rows against a partition of the columns sum to the self RHS."""
    cut = 50
    parts = [B.lddmm_rhs_cross(Q, P, Q[:, lo:hi], P[:, lo:hi], SIG, eta, True, MQ,
                               MQ[:, lo:hi], tile=TILE) for lo, hi in ((0, cut), (cut, M))]
    whole = B.lddmm_rhs_self(Q, P, SIG, eta, True, MQ, tile=TILE)
    for i in range(3):
        _close(parts[0][i] + parts[1][i], whole[i].detach().numpy())
    jax_out = _jax(lambda qr, pr, qc, pc, mr, mc: JBW.lddmm_rhs_cross(
        qr, pr, qc, pc, SIG, eta, True, mr, mc, tile=TILE),
        NQ, NP, NQ[:, :cut], NP[:, :cut], NMQ, NMQ[:, :cut])
    for g, j in zip(parts[0], jax_out):
        _close(g, j)


def _loss_self(rhs, q, p, eta):
    vq, mgq, dc = rhs(q, p, SIG, eta, True, MQ)
    return (vq**2).sum() + (mgq * vq).sum() + dc.sum()


@pytest.mark.parametrize("eta", [0.0, 0.3])
def test_gradients_match_dense_and_jax(eta):
    """d/dq and d/dp of a loss of the self RHS, through the checkpointed
    tiles, against dense autograd and jax.grad of the JAX blockwise RHS."""
    grads = {}
    for name, rhs in (("block", lambda *a: B.lddmm_rhs_self(*a, tile=TILE)),
                      ("dense", R.lddmm_rhs_self)):
        q, p = Q.clone().requires_grad_(True), P.clone().requires_grad_(True)
        grads[name] = torch.autograd.grad(_loss_self(rhs, q, p, eta), (q, p))

    def jloss(q, p, m):
        vq, mgq, dc = JBW.lddmm_rhs_self(q, p, SIG, eta, True, m, tile=TILE)
        return jnp.sum(vq**2) + jnp.sum(mgq * vq) + dc

    jg = [jax.grad(jloss, argnums=(0, 1))(jnp.asarray(NQ[k]), jnp.asarray(NP[k]),
                                          jnp.asarray(NMQ[k])) for k in range(K)]
    for i in range(2):
        _close(grads["block"][i], grads["dense"][i].numpy(),
               np.stack([np.asarray(g[i]) for g in jg]), tol=GRAD)


def _cases():
    """name -> (port blockwise, port dense, JAX blockwise with its arrays)."""
    w = _t(rng.uniform(0.5, 1.5, size=(K, M)))
    nw = w.numpy()
    return {
        "v_field": (lambda: B.v_field(X, Q, P, SIG, 0.4, MQ, tile=TILE),
                    lambda: R.v_field(X, Q, P, SIG, 0.4, MQ),
                    (lambda x, q, p, m: JBW.v_field(x, q, p, SIG, 0.4, m, tile=TILE),
                     (NX, NQ, NP, NMQ))),
        "kred": (lambda: B.kred(X, Q, P, SIG, MQ, tile=TILE),
                 lambda: R.kred(X, Q, P, SIG, MQ),
                 (lambda x, y, b, m: JBW.kred(x, y, b, SIG, m, tile=TILE), (NX, NQ, NP, NMQ))),
        "kred_scal": (lambda: B.kred_scal(X, Q, w, SIG, MQ, tile=TILE),
                      lambda: R.kred_scal(X, Q, w, SIG, MQ),
                      (lambda x, y, d, m: JBW.kred_scal(x, y, d, SIG, m, tile=TILE),
                       (NX, NQ, nw, NMQ))),
        "grad_kred": (lambda: B.grad_kred(X, Q, SIG, MQ, tile=TILE),
                      lambda: R.grad_kred(X, Q, SIG, MQ),
                      (lambda x, y, m: JBW.grad_kred(x, y, SIG, m, tile=TILE), (NX, NQ, NMQ))),
        "mdivsum": (lambda: B.mdivsum(X, Q, P, SIG, 0.4, MQ, MX, tile=TILE),
                    lambda: R.mdivsum(X, Q, P, SIG, 0.4, MQ, MX),
                    (lambda x, q, p, mq, mx: JBW.mdivsum(x, q, p, SIG, 0.4, mq, mx, tile=TILE),
                     (NX, NQ, NP, NMQ, NMX))),
        "hamiltonian": (lambda: B.hamiltonian(Q, P, SIG, 0.4, MQ, tile=TILE),
                        lambda: R.hamiltonian(Q, P, SIG, 0.4, MQ),
                        (lambda q, p, m: JBW.hamiltonian(q, p, SIG, 0.4, m, tile=TILE),
                         (NQ, NP, NMQ))),
        "hamiltonian_cross": (
            lambda: B.hamiltonian_cross(Q, P, Q[:, :60], P[:, :60], SIG, 0.4, MQ, MQ[:, :60],
                                        tile=TILE)
            + B.hamiltonian_cross(Q, P, Q[:, 60:], P[:, 60:], SIG, 0.4, MQ, MQ[:, 60:],
                                  tile=TILE),
            lambda: R.hamiltonian(Q, P, SIG, 0.4, MQ),
            (lambda q, p, m: JBW.hamiltonian_cross(q, p, q[:60], p[:60], SIG, 0.4, m, m[:60],
                                                   tile=TILE)
             + JBW.hamiltonian_cross(q, p, q[60:], p[60:], SIG, 0.4, m, m[60:], tile=TILE),
             (NQ, NP, NMQ))),
    }


@pytest.mark.parametrize("name", ["v_field", "kred", "kred_scal", "grad_kred", "mdivsum",
                                  "hamiltonian", "hamiltonian_cross"])
def test_reductions_match_dense_and_jax(name):
    block, dense, (jfn, arrays) = _cases()[name]
    _close(block(), dense().numpy(), _jax(jfn, *arrays))


@pytest.mark.parametrize("name", ["kred", "mdivsum", "hamiltonian"])
def test_reduction_gradients_match_dense(name):
    """Gradients through the checkpointed tiles of the other reductions."""
    def run(route):
        q, p, x = (t.clone().requires_grad_(True) for t in (Q, P, X))
        kw = {} if route is R else {"tile": TILE}
        if name == "kred":
            out = (route.kred(x, q, p, SIG, MQ, **kw) ** 2).sum()
        elif name == "mdivsum":
            out = route.mdivsum(x, q, p, SIG, 0.4, MQ, MX, **kw).sum()
        else:
            out = route.hamiltonian(q, p, SIG, 0.4, MQ, **kw).sum()
        return torch.autograd.grad(out, (q, p, x), allow_unused=True)

    for g, ref in zip(run(B), run(R)):
        if ref is None:
            assert g is None
        else:
            _close(g, ref.numpy(), tol=GRAD)


def _points(n, d, seed, with_dup=True):
    """tests/test_streaming.py's points: a normal cloud with an exact
    duplicate and a mask."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, d)).astype(np.float32)
    if with_dup:
        x[n // 2] = x[0]
    mask = (r.uniform(size=n) > 0.15).astype(np.float32)
    mask[0] = mask[n // 2] = 1.0
    return x, mask


@pytest.mark.parametrize("d", [2, 3])
def test_min_sqdist_matches_dense_and_jax(d):
    x, _ = _points(130, d, 1)
    y, my = _points(275, d, 2)
    got = B.min_sqdist(_t(x), _t(y), _t(my), tile=64)
    np.testing.assert_allclose(got.numpy(), R.min_sqdist(_t(x), _t(y), _t(my)).numpy(), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(JBW.min_sqdist(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(my), tile=64)), rtol=1e-6)


@pytest.mark.parametrize("d", [2, 3])
def test_second_min_matches_dense_and_jax(d):
    x, mx = _points(201, d, 3)
    got = B.second_min_sqdist(_t(x), _t(mx), tile=64)
    np.testing.assert_allclose(got.numpy(), R.second_min_sqdist(_t(x), _t(mx)).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(JBW.second_min_sqdist(
        jnp.asarray(x), jnp.asarray(mx), tile=64)), rtol=1e-6)


def test_second_min_tie_duplicate_and_top2():
    """An exact duplicate is at distance 0 from its twin (the tile top-2
    keeps duplicates); _top2_scan's pair is JAX's, a one-column last tile
    included (65 columns in tiles of 16)."""
    x, m = _points(64, 2, 4)
    got = B.second_min_sqdist(_t(x), _t(m), tile=16).numpy()
    assert got[0] == 0.0 and got[32] == 0.0
    y, my = _points(65, 2, 5)
    t1, t2 = B._top2_scan(_t(x), _t(y), _t(my), 16)
    j1, j2 = JBW._top2_scan(jnp.asarray(x), jnp.asarray(y), jnp.asarray(my), 16, None)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=1e-6)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=1e-6)


def test_checkpointed_backward_keeps_inputs_not_temporaries(monkeypatch):
    """The tensors a loss over 16 column tiles saves for its backward hold,
    counted by distinct storage (each tile's inputs are views of the same
    points), less than two tiles' (M, tile, D) float32 temporaries; the same
    loss with the tile bodies run plainly saves more than 16 of them."""
    m, tile = 512, 32
    r = np.random.default_rng(9)
    q = _t(r.normal(size=(m, 2)))
    p0 = _t(0.3 * r.normal(size=(m, 2)))
    x = _t(r.normal(size=(m, 2)))
    one_tile = m * tile * 2 * 4

    def saved_bytes():
        storages = {}

        def pack(t):
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
            return t

        p = p0.clone().requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            vq, mgq, dc, vx = B.lddmm_rhs_ext(q, p, x, 0.5, 0.0, True, tile=tile)
            loss = (vq**2).sum() + (mgq * vq).sum() + dc.sum() + (vx**2).sum()
        torch.autograd.grad(loss, p)
        return sum(storages.values())

    assert saved_bytes() < 2 * one_tile
    monkeypatch.setattr(B, "_ckpt", lambda fn, *args: fn(*args))
    assert saved_bytes() > 16 * one_tile


def test_backward_frees_each_tile_before_the_next():
    """Two chained self RHS calls over 16 tiles whose last -Gq gets no
    gradient (as the last Euler step's): the tensors the backward's
    recomputation saves are freed tile by tile: at most one tile's (under
    eight (M, tile, D) float32 tensors) alive at once of the 32 tiles.
    (torch.utils.checkpoint, non-reentrant, keeps those of the unused
    output's nodes until the backward ends: ops/blockwise.py.)"""
    import weakref

    m, tile = 512, 32
    r = np.random.default_rng(10)
    q0 = _t(r.normal(size=(m, 2)))
    p0 = _t(0.3 * r.normal(size=(m, 2)))
    one_tile = m * tile * 2 * 4

    def max_alive():
        live, peak = [0], [0]

        def pack(t):
            n = t.numel() * t.element_size()
            live[0] += n
            peak[0] = max(peak[0], live[0])
            weakref.finalize(t, lambda: live.__setitem__(0, live[0] - n))
            return t

        p = p0.clone().requires_grad_(True)
        vq, mgq, _ = B.lddmm_rhs_self(q0, p, 0.5, 0.0, False, tile=tile)
        q1, p1 = q0 + 0.1 * vq, p + 0.1 * mgq
        vq1, _, _ = B.lddmm_rhs_self(q1, p1, 0.5, 0.0, False, tile=tile)
        loss = ((q1 + 0.1 * vq1) ** 2).sum()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            torch.autograd.grad(loss, p)
        return peak[0]

    assert max_alive() < 8 * one_tile


def test_forced_route_takes_every_dispatch():
    """set_backend("blockwise") sends each dispatch to ops/blockwise.py at
    any size, with no rows' order, as the JAX package's forced mode does."""
    TB.set_backend("blockwise")
    assert TB.row_order(Q, SIG, MQ) is None
    assert TB.data_order(X, Q, SIG, MX) is None
    for got, want in zip(TB.lddmm_rhs_self(Q, P, SIG, 0.0, True, MQ),
                         B.lddmm_rhs_self(Q, P, SIG, 0.0, True, MQ)):
        assert torch.equal(got, want)
    for got, want in zip(TB.lddmm_rhs_ext(Q, P, X, SIG, 0.0, True, MQ, MX),
                         B.lddmm_rhs_ext(Q, P, X, SIG, 0.0, True, MQ, MX)):
        assert torch.equal(got, want)
    pairs = [(TB.hamiltonian(Q, P, SIG, 0.0, MQ), B.hamiltonian(Q, P, SIG, 0.0, MQ)),
             (TB.v_field(X, Q, P, SIG, 0.0, MQ), B.v_field(X, Q, P, SIG, 0.0, MQ)),
             (TB.kred(Q, Q, P, SIG, MQ), B.kred(Q, Q, P, SIG, MQ)),
             (TB.kred_scal(X, Q, MQ, SIG, MQ), B.kred_scal(X, Q, MQ, SIG, MQ)),
             (TB.grad_kred(X, Q, SIG, MQ), B.grad_kred(X, Q, SIG, MQ)),
             (TB.mdivsum(X, Q, P, SIG, 0.0, MQ, MX), B.mdivsum(X, Q, P, SIG, 0.0, MQ, MX)),
             (TB.min_sqdist(X, Q, MQ), B.min_sqdist(X, Q, MQ)),
             (TB.second_min_sqdist(Q, MQ), B.second_min_sqdist(Q, MQ)),
             (TB.check_coverage(X, Q, SIG, 0.5, MX, MQ),
              (B.min_sqdist(X, Q, MQ) > (0.5 * SIG) ** 2) & (MX > 0))]
    for got, want in pairs:
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        TB.set_bwd_precision("exact")


@pytest.mark.parametrize("eta", [0.0, 0.3])
def test_accurate_backward_is_the_blockwise_vjp(eta):
    """Under backward_precision "accurate" the forced kernel route's self and
    ext RHS backward (here at the kernels' plain versions) gives the
    blockwise route's gradients in q, p and x (rtol 1e-3 / atol 1e-4, within
    1e-6 relative of the largest entry); its forward stays the kernel's."""
    def grads(route, mode):
        TB.set_backend(route)
        TB.set_bwd_precision(mode)
        q, p, x = (t.clone().requires_grad_(True) for t in (Q, P, X))
        vq, mgq, dc = TB.lddmm_rhs_self(q, p, SIG, eta, True, MQ)
        loss = (vq**2).sum() + (mgq * vq).sum() + dc.sum()
        vq, mgq, dc, vx = TB.lddmm_rhs_ext(q, p, x, SIG, eta, True, MQ, MX)
        loss = loss + (vq * mgq).sum() + dc.sum() + (vx**3).sum()
        return loss.detach(), torch.autograd.grad(loss, (q, p, x))

    block_loss, block = grads("blockwise", "fast")
    kernel_loss, accurate = grads("kernel", "accurate")
    np.testing.assert_allclose(kernel_loss.numpy(), block_loss.numpy(), rtol=1e-5)
    for g, ref in zip(accurate, block):
        _close(g, ref.numpy(), tol=GRAD)
        assert float((g - ref).abs().max() / ref.abs().max()) < 1e-6


def test_icp_atlas_blockwise_matches_jax():
    """icp_atlas on three spiral frames with computversion="blockwise" in
    both packages: every reduction on the tiled route; the final FE within
    5e-3 and no free-energy increase."""
    frames = [SPIRAL[f"x{k}"] for k in range(3)]
    kw = dict(
        GMM_parameters={"init_components": ("set", 0)},
        registration_parameters={"type": "diffeomorphic", "sigma_LDDMM": 0.2,
                                 "lambda_LDDMM": 500.0},
        numerical_options={"integration_nt_LDDMM": 3, "computversion": "blockwise"},
        optim_options={"max_iterations": 2},
        printstuff=False,
    )
    try:
        jpsr, _ = j_icp_atlas(frames, **kw)
    finally:
        JB.set_backend(None)
    tpsr, _ = t_icp_atlas(frames, device="cpu", **kw)
    assert TB._FORCE["mode"] == "blockwise"
    assert tpsr.fe_increase_events == 0 and jpsr.fe_increase_events == 0
    np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=5e-3)
