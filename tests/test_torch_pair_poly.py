"""The port's pair-polynomial compiler (difficp_torch/ops/pair_poly.py)
against the JAX package's: the table widths, the four generated functions
with both packages' size gates lowered to 1 (as tests/test_pair_poly.py
lowers them), the coefficient-matrix recombination against a float64 pair
sum of the polynomials, and the precision of the generated route at the
grid path's geometry (R / sigma ~ 10) against float64 dense autograd, held
to twice the JAX package's own error there.

The JAX side runs its Pallas kernels in interpret mode with exact float32
products (``PR._MM_MODE = "highest"``, as tests/test_pair_poly.py:47-50).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import difficp_tpu.ops.pair_poly as JPP
import difficp_tpu.ops.pallas_reductions as PR
from difficp_tpu.ops import backend as JB
from difficp_torch.examples.run_large import spiral_cloud
from difficp_torch.ops import ksum as KS
from difficp_torch.ops import pair_poly as PP
from difficp_torch.ops import reductions as TR
from difficp_torch.ops import rhs_ext as RE
from difficp_torch.ops import rhs_self as RS
from difficp_torch.utils.point_sets import grid_support

torch.set_num_threads(1)

# the inputs of tests/test_pair_poly.py, with two frames on the port's side
rng = np.random.default_rng(3)
M, NX, D = 260, 170, 2
Q = rng.normal(size=(M, D)).astype(np.float32) + 2.0
P = rng.normal(size=(M, D)).astype(np.float32) * 0.4
X = rng.normal(size=(NX, D)).astype(np.float32) + 2.0
MQ = (rng.uniform(size=M) > 0.2).astype(np.float32)
MX = (rng.uniform(size=NX) > 0.2).astype(np.float32)
GV = rng.normal(size=(M, D)).astype(np.float32)
GG = rng.normal(size=(M, D)).astype(np.float32)
GX = rng.normal(size=(NX, D)).astype(np.float32)
GC = np.float32(0.7)
SIG = 0.6
ETA = 0.3


def _two(a, shift=0.0):
    """Two frames: a as given, and a reversed (plus a shift of the
    coordinates): the outputs of the second are those of the first,
    reversed."""
    return torch.as_tensor(np.stack([a, a[::-1] + np.float32(shift)]))


def _close(x, ref, rtol, atol):
    np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol)


@pytest.fixture
def gates_at_one(monkeypatch):
    """Both packages' size gates lowered to 1: the generated forwards and the
    symmetric table run at this size."""
    monkeypatch.setattr(PR, "_MM_MODE", "highest")
    for mod in (PR, RS):
        monkeypatch.setattr(mod, "_POLY_FWD_MIN_M", 1)
    for mod in (JPP, PP):
        monkeypatch.setattr(mod, "_SYM_MIN_M", 1)


def _width(polys):
    return len({cm for p in polys.values() for cm in p.col_monomials()})


@pytest.mark.parametrize("d,widths", [(2, (20, 121, 9, 20, 20, 6, 3)),
                                      (3, (40, 333, 13, 40, 40, 8, 4))])
def test_table_widths_match_jax(d, widths, monkeypatch):
    """The kernel-sum table widths of every generated function equal the JAX
    package's at d = 2 and 3: self forward, self backward, ext forward, ext
    dx, ext dq/dp; and the Hamiltonian's and grad_kred's tables, read off the
    kernel-sum calls."""
    sig, eta = 0.05, 1.0 / 500
    ours = [PP._self_fwd_polys(d, sig, eta, True), PP._self_bwd_polys(d, sig, eta),
            PP._ext_fwd_polys(d, sig, eta, True), *PP._ext_bwd_polys(d, sig, eta)]
    theirs = [JPP._self_fwd_polys(d, sig, eta, True), JPP._self_bwd_polys(d, sig, eta),
              JPP._ext_fwd_polys(d, sig, eta, True), *JPP._ext_bwd_polys(d, sig, eta)]
    for a, b in zip(ours, theirs):
        assert {k: v.t for k, v in a.items()} == {k: v.t for k, v in b.items()}
    assert tuple(_width(p) for p in ours) == widths[:5]
    seen = []
    real = KS.ksum
    monkeypatch.setattr(KS, "ksum", lambda x, y, t, m, s: seen.append(t.shape[-2]) or real(x, y, t, m, s))
    q = torch.rand((1, 12, d))
    m = torch.ones((1, 12))
    RS.hamiltonian(q, q, 0.3, m, eta)
    KS.grad_kred(q, q, 0.3, m)
    assert seen == list(widths[5:])


@pytest.mark.parametrize("withlogdet", [False, True])
def test_self_fwd_poly_matches_jax(withlogdet, gates_at_one):
    """rhs_self_fwd_poly through the symmetric table; rtol 1e-3 / atol 2e-3,
    the bound of tests/test_pair_poly.py::test_self_fwd_poly_matches_blockwise."""
    qc = Q - np.asarray(PR._mm_center(jnp.asarray(Q), jnp.asarray(MQ)))
    vq, gq, dc = JPP.rhs_self_fwd_poly(jnp.asarray(qc), jnp.asarray(P), jnp.asarray(MQ),
                                       SIG, ETA, withlogdet)
    got = PP.rhs_self_fwd_poly(_two(qc, 0.25), _two(P), _two(MQ), SIG, ETA, withlogdet)
    for g, r in zip(got[:2], (vq, gq)):
        _close(g[0], r, 1e-3, 2e-3)
    _close(float(got[2][0]), float(dc), 1e-3, 2e-3)
    # frame 1 holds the same points in reverse order, shifted
    _close(got[0][1].flip(0), vq, 1e-3, 2e-3)
    _close(got[1][1].flip(0), gq, 1e-3, 2e-3)


def test_ext_fwd_poly_matches_jax(gates_at_one):
    """rhs_ext_fwd_poly; rtol 1e-3 / atol 2e-3."""
    c = np.asarray(PR._mm_center(jnp.asarray(Q), jnp.asarray(MQ)))
    vx, dc = JPP.rhs_ext_fwd_poly(jnp.asarray(Q - c), jnp.asarray(P), jnp.asarray(X - c),
                                  jnp.asarray(MQ), jnp.asarray(MX), SIG, ETA, True)
    gvx, gdc = PP.rhs_ext_fwd_poly(_two(Q - c), _two(P), _two(X - c), _two(MQ), _two(MX),
                                   SIG, ETA, True)
    _close(gvx[0], vx, 1e-3, 2e-3)
    _close(float(gdc[0]), float(dc), 1e-3, 2e-3)


@pytest.mark.parametrize("eta", [0.0, ETA])
def test_self_bwd_poly_matches_jax(eta, gates_at_one):
    """rhs_self_bwd_poly, per-frame cotangent of dc; dq rtol 1e-2 at eta !=
    0 and 1e-3 at eta = 0, dp 1e-3 (tests/test_pair_poly.py::
    test_self_bwd_poly_matches_blockwise_vjp)."""
    qc = Q - np.asarray(PR._mm_center(jnp.asarray(Q), jnp.asarray(MQ)))
    dq, dp = JPP.rhs_self_bwd_poly(jnp.asarray(qc), jnp.asarray(P), jnp.asarray(MQ),
                                   jnp.asarray(GV), jnp.asarray(GG), jnp.asarray(GC),
                                   SIG, eta)
    got = PP.rhs_self_bwd_poly(_two(qc), _two(P), _two(MQ), _two(GV), _two(GG),
                               torch.tensor([GC, GC]), SIG, eta)
    tol = (1e-2, 1e-2) if eta else (1e-3, 2e-3)
    _close(got[0][0], dq, *tol)
    _close(got[1][0], dp, 1e-3, 2e-3)


@pytest.mark.parametrize("eta", [0.0, ETA])
def test_ext_bwd_poly_matches_jax(eta, gates_at_one):
    """rhs_ext_bwd_poly (dq, dp, dx); dx and dq rtol 1e-2 at eta != 0 and
    1e-3 at eta = 0, dp 1e-3 (tests/test_pair_poly.py::
    test_ext_bwd_poly_matches_blockwise_vjp)."""
    c = np.asarray(PR._mm_center(jnp.asarray(Q), jnp.asarray(MQ)))
    want = JPP.rhs_ext_bwd_poly(jnp.asarray(Q - c), jnp.asarray(P), jnp.asarray(X - c),
                                jnp.asarray(MQ), jnp.asarray(MX), jnp.asarray(GX),
                                jnp.asarray(GC), SIG, eta)
    got = PP.rhs_ext_bwd_poly(_two(Q - c), _two(P), _two(X - c), _two(MQ), _two(MX),
                              _two(GX), torch.tensor([GC, GC]), SIG, eta)
    tol = (1e-2, 1e-2) if eta else (1e-3, 2e-3)
    _close(got[0][0], want[0], *tol)
    _close(got[1][0], want[1], 1e-3, 2e-3)
    _close(got[2][0], want[2], *tol)


def _pair_sum(poly, xv, yv, sigma):
    """sum_j k(x_i - y_j) P_ij term by term in float64: the definition."""
    d2 = sum((xv[f"q{e}"][:, None] - yv[f"q{e}"][None, :]) ** 2 for e in range(D))
    k = np.exp(-d2 / (2 * sigma ** 2))
    out = np.zeros(k.shape[0])
    for (rm, cm), c in poly.t.items():
        r = np.prod([xv[n] for n in rm], axis=0) if rm else np.ones(k.shape[0])
        col = np.prod([yv[n] for n in cm], axis=0) if cm else np.ones(k.shape[1])
        out += c * r * (k @ col)
    return out


@pytest.mark.parametrize("sym", [False, True])
def test_recombination_matches_term_by_term(sym):
    """eval_polys (one kernel-sum table, the coefficient matrix, the row
    monomials) equals the polynomials summed term by term over all pairs, in
    float64 on 40 points: rtol 1e-10.  With sym, the table is built as the
    symmetric kernel-sum builds it."""
    r = np.random.default_rng(9)
    vals = {"m": (r.uniform(size=40) > 0.2).astype(np.float64), "C": np.full(40, 0.4)}
    for e in range(D):
        for name in ("q", "p", "g", "h"):
            vals[f"{name}{e}"] = r.normal(size=40)
    polys = PP._self_bwd_polys(D, SIG, ETA)
    tv = {k: torch.as_tensor(v)[None] for k, v in vals.items()}
    xq = torch.stack([tv["q0"][0], tv["q1"][0]], -1)[None]
    got = PP.eval_polys(polys, xq, xq, tv, tv, SIG, sym=sym)
    for name, poly in polys.items():
        np.testing.assert_allclose(got[name][0].numpy(), _pair_sum(poly, vals, vals, SIG),
                                   rtol=1e-10, atol=1e-10)


def _grid_case():
    """The grid path's geometry at a small size: 300 spiral points, its grid
    support at sigma = 0.05 (M = 272, R / sigma ~ 10), eta = 1/500."""
    r = np.random.default_rng(0)
    x = spiral_cloud(300, r)
    q = grid_support(x, 0.05)
    p = (0.05 * r.normal(size=q.shape)).astype(np.float32)
    gv, gg = (r.normal(size=q.shape).astype(np.float32) for _ in range(2))
    gx = r.normal(size=x.shape).astype(np.float32)
    return q, p, x, gv, gg, np.float32(0.7), gx


@pytest.mark.parametrize("gate", [32768, 1])
def test_poly_precision_no_worse_than_jax(gate, monkeypatch):
    """The ext RHS at eta = 1/500 with the generated backward (and, with the
    gates at 1, the generated forwards), against float64 dense autograd: the
    port's largest error relative to each output's largest magnitude is no
    worse than twice the JAX package's on the same inputs."""
    sig, eta = 0.05, 1.0 / 500
    monkeypatch.setattr(PR, "_MM_MODE", "highest")
    for mod in (PR, RS):
        monkeypatch.setattr(mod, "_POLY_FWD_MIN_M", gate)
    q, p, x, gv, gg, gc, gx = _grid_case()
    mq, mx = np.ones(len(q), np.float32), np.ones(len(x), np.float32)
    t64 = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (q, p, x)]
    cots = [torch.tensor(a, dtype=torch.float64) for a in (gv, gg, gc, gx)]
    out = TR.lddmm_rhs_ext(*t64, sig, eta, True, *(torch.ones(len(a), dtype=torch.float64)
                                                   for a in (q, x)))
    ref = [o.detach() for o in out] + list(torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(out, cots)), t64))

    def err(got):
        return np.array([float(np.abs(np.asarray(g, np.float64) - r.numpy()).max()
                               / np.abs(r.numpy()).max()) for g, r in zip(got, ref)])

    JB.set_backend("pallas")
    try:
        o, vjp = jax.vjp(lambda a, b, c: JB.lddmm_rhs_ext(
            a, b, c, sig, eta, True, jnp.asarray(mq), jnp.asarray(mx)),
            *(jnp.asarray(a) for a in (q, p, x)))
        jax_err = err(list(o) + list(vjp(tuple(jnp.asarray(a) for a in (gv, gg, gc, gx)))))
    finally:
        JB.set_backend(None)
    t = [torch.tensor(a, requires_grad=True) for a in (q, p, x)]
    o = RE.RHSExt.apply(*t, torch.as_tensor(mq), torch.as_tensor(mx), sig, True, eta)
    g = torch.autograd.grad(sum((a * torch.as_tensor(c)).sum()
                                for a, c in zip(o, (gv, gg, gc, gx))), t)
    port_err = err([a.detach() for a in o] + list(g))
    assert (port_err <= 2.0 * jax_err + 1e-7).all(), (port_err, jax_err)
    assert port_err.max() < 1e-2, port_err
