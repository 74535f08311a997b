"""The port's cross-set ops (difficp_torch/ops/rhs_cross.py), the bodies of the
ring rotations, against the JAX package's custom VJPs ``make_rhs_cross``,
``make_rhs_xcross`` and ``make_hamiltonian_cross``, run as
tests/test_cross_ops.py runs them (Pallas in interpret mode on the CPU, exact
float32 products): values and both sides' VJPs, eta = 0 and 0.3, logdet on
and off.  Also the two ring-only generated polynomials of ops/pair_poly.py
against the JAX ones (tables and values), the term lists behind the cross
forward's bound, the cross forward's column partition, and the eta = 0 cross
kernel's table scheme emulated on the CPU.

On the CPU the ops take the kernel's plain PyTorch version; the CUDA kernel
itself is checked against that on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import difficp_tpu.ops.pair_poly as JPP
import difficp_tpu.ops.pallas_reductions as PR
from difficp_tpu.ops.pallas_reductions import (
    _mm_center,
    make_hamiltonian_cross,
    make_rhs_cross,
    make_rhs_xcross,
)
from difficp_torch.ops import ksum as KS
from difficp_torch.ops import pair_poly as PP
from difficp_torch.ops import rhs_cross as RC
from difficp_torch.ops import rhs_self as RS

torch.set_num_threads(1)

# tests/test_cross_ops.py's geometry at a size one 128-tile holds
rng = np.random.default_rng(11)
M, N, NX, D = 120, 90, 70, 2
QR = rng.normal(size=(M, D)).astype(np.float32) + 1.5
PR_ = rng.normal(size=(M, D)).astype(np.float32) * 0.4
MR = (rng.uniform(size=M) > 0.2).astype(np.float32)
QC = rng.normal(size=(N, D)).astype(np.float32) + 1.5
PC = rng.normal(size=(N, D)).astype(np.float32) * 0.4
MC = (rng.uniform(size=N) > 0.2).astype(np.float32)
X = rng.normal(size=(NX, D)).astype(np.float32) + 1.5
MX = (rng.uniform(size=NX) > 0.2).astype(np.float32)
GV = rng.normal(size=(M, D)).astype(np.float32)
GG = rng.normal(size=(M, D)).astype(np.float32)
GX = rng.normal(size=(NX, D)).astype(np.float32)
GC = np.float32(0.7)
SIG = 0.6
TILE = 128


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close(x, ref, rtol):
    """|x - ref| <= rtol (|ref| + max|ref|): float32 sums in two orders."""
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(x, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.fixture(autouse=True)
def exact_products(monkeypatch):
    monkeypatch.setattr(PR, "_MM_MODE", "highest")


def _port_vjp(fn, args, cots):
    """Outputs of fn(*args) and the VJP for the cotangents, over the args that
    are not None in ``args`` (the masks pass through as they are)."""
    leaves = [a.clone().requires_grad_(True) if a is not None else None for a in args]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * c).sum() for o, c in zip(outs, cots))
    grads = torch.autograd.grad(loss, [a for a in leaves if a is not None])
    return [o.detach() for o in outs], grads


# forward: float32 direct sums against the interpret kernels (rtol 1e-5);
# gradients: both sides generated polynomials in float32, recombined in
# other orders (rtol 1e-4)
TOL_FWD, TOL_GRAD = 1e-5, 1e-4

_JAX = {}


def _jax_ref(kind, eta, logdet_cot):
    """The JAX op's outputs and VJP (logdet on) for ``kind`` "rhs" / "xrhs"
    at eta, for the cotangent of dcost ``logdet_cot``.  With logdet off the
    JAX ops return dcost 0 and take a zero cotangent for it, so the logdet-on
    op with a zero dcost cotangent is their reference: one op per (kind, eta)
    for this module."""
    if (kind, eta) not in _JAX:
        if kind == "rhs":
            op = make_rhs_cross(SIG, eta, True, ti=TILE, tj=TILE)
            qr, pr, mr, qc, pc, mc = _j(QR, PR_, MR, QC, PC, MC)
            _JAX[kind, eta] = jax.vjp(lambda a, b, c, e: op(a, b, mr, c, e, mc), qr, pr, qc, pc)
        else:
            op = make_rhs_xcross(SIG, eta, True, ti=TILE, tj=TILE)
            x, mx, qc, pc, mc = _j(X, MX, QC, PC, MC)
            _JAX[kind, eta] = jax.vjp(lambda a, b, c: op(a, mx, b, c, mc), x, qc, pc)
    out, vjp = _JAX[kind, eta]
    cot = (GV, GG) if kind == "rhs" else (GX,)
    return out, vjp((*_j(*cot), jnp.float32(logdet_cot)))


@pytest.mark.parametrize("eta", [0.0, 0.3])
@pytest.mark.parametrize("withlogdet", [False, True])
def test_rhs_cross_matches_jax(eta, withlogdet):
    """RHSCross (values and the VJP to both sides) against make_rhs_cross."""
    out_ref, grads_ref = _jax_ref("rhs", eta, GC if withlogdet else 0.0)
    mrt, mct = _t(MR, MC)
    out, grads = _port_vjp(
        lambda a, b, c, e: RC.rhs_cross(a, b, mrt, c, e, mct, SIG, withlogdet, eta),
        _t(QR, PR_, QC, PC), _t(GV, GG, GC))
    _close(out[0], out_ref[0], TOL_FWD)
    _close(out[1], out_ref[1], TOL_FWD)
    if withlogdet:
        np.testing.assert_allclose(float(out[2]), float(out_ref[2]), rtol=TOL_FWD, atol=1e-5)
    else:
        assert float(out[2]) == 0.0
    for got, ref in zip(grads, grads_ref):
        _close(got, ref, TOL_GRAD)


@pytest.mark.parametrize("eta", [0.0, 0.3])
@pytest.mark.parametrize("withlogdet", [False, True])
def test_rhs_xcross_matches_jax(eta, withlogdet):
    """RHSXCross (values, the VJP to the data rows and to the support
    columns) against make_rhs_xcross: the ext kernels' plain versions at eta
    = 0, the generated backward otherwise."""
    out_ref, grads_ref = _jax_ref("xrhs", eta, GC if withlogdet else 0.0)
    mxt, mct = _t(MX, MC)
    out, grads = _port_vjp(
        lambda a, b, c: RC.rhs_xcross(a, mxt, b, c, mct, SIG, withlogdet, eta),
        _t(X, QC, PC), _t(GX, GC))
    _close(out[0], out_ref[0], TOL_FWD)
    if withlogdet:
        np.testing.assert_allclose(float(out[1]), float(out_ref[1]), rtol=TOL_FWD, atol=1e-5)
    else:
        assert float(out[1]) == 0.0
    for got, ref in zip(grads, grads_ref):
        _close(got, ref, TOL_GRAD)


@pytest.mark.parametrize("eta", [0.0, 0.3])
def test_hamiltonian_cross_matches_jax(eta):
    """HamiltonianCross (the value and both sides' gradients) against
    make_hamiltonian_cross."""
    op = make_hamiltonian_cross(SIG, eta, ti=TILE, tj=TILE)
    qr, pr, mr, qc, pc, mc = _j(QR, PR_, MR, QC, PC, MC)
    h_ref, grads_ref = jax.value_and_grad(
        lambda a, b, c, e: op(a, b, mr, c, e, mc), argnums=(0, 1, 2, 3))(qr, pr, qc, pc)
    mrt, mct = _t(MR, MC)
    out, grads = _port_vjp(
        lambda a, b, c, e: RC.hamiltonian_cross(a, b, mrt, c, e, mct, SIG, eta),
        _t(QR, PR_, QC, PC), [torch.tensor(1.0)])
    np.testing.assert_allclose(float(out[0]), float(h_ref), rtol=TOL_FWD)
    for got, ref in zip(grads, grads_ref):
        _close(got, ref, TOL_GRAD)


def _width(polys):
    return len({cm for p in polys.values() for cm in p.col_monomials()})


@pytest.mark.parametrize("eta,widths", [(0.0, (18, 36, 2, 6, 6)), (0.3, (33, 88, 7, 16, 20))])
def test_cross_table_widths_match_jax(eta, widths):
    """The kernel-sum table widths (column monomials) of the cross backward's
    row and column directions, and of the cross Hamiltonian's value, row
    gradient and column gradient, equal the JAX package's at d = 2."""
    def tables(mod):
        row, col = mod._cross_bwd_polys(2, SIG, eta)
        hrow, hcol = mod._ham_cross_polys(2, SIG, eta)
        grad = {k: v for k, v in hrow.items() if k != "h"}
        return row, col, {"h": hrow["h"]}, grad, hcol

    got = tuple(_width(p) for p in tables(PP))
    assert got == tuple(_width(p) for p in tables(JPP)) == widths


@pytest.mark.parametrize("eta", [0.0, 0.3])
def test_cross_polys_match_jax(eta):
    """The generated polynomials of rhs_cross_bwd_poly and
    hamiltonian_cross_poly have the JAX package's terms and coefficients
    (the Function tests above hold their evaluation against JAX's); the
    port evaluates them on two frames (the second the first reversed) as on
    each frame alone, and the Hamiltonian's value alone as with its
    gradients."""
    for name in ("_cross_bwd_polys", "_ham_cross_polys"):
        for got, want in zip(getattr(PP, name)(2, SIG, eta), getattr(JPP, name)(2, SIG, eta)):
            assert set(got) == set(want)
            for key in got:
                assert got[key].t == pytest.approx(want[key].t, rel=1e-12)
    c = KS.mm_center(*_t(QC, MC))
    one = [torch.as_tensor(a) for a in (QR, PR_, MR, QC, PC, MC, GV, GG)]
    one[0], one[3] = one[0] - c, one[3] - c
    two = [torch.stack([a, a.flip(0)]) for a in one]
    single = PP.rhs_cross_bwd_poly(*one, torch.tensor(GC), SIG, eta)
    batched = PP.rhs_cross_bwd_poly(*two, torch.tensor([GC, GC]), SIG, eta)
    h_one = PP.hamiltonian_cross_poly(*one[:6], SIG, eta, ("row", "col"))
    h_two = PP.hamiltonian_cross_poly(*two[:6], SIG, eta, ("row", "col"))
    pairs = list(zip(batched, single)) + [(h_two[k], h_one[k]) for k in
                                          ("dq_row", "dp_row", "dq_col", "dp_col")]
    # the reversed frame sums in another order: the generated polynomials'
    # float32 error, as against the JAX package
    for b, s in pairs:
        _close(b[0], s, 1e-6)
        _close(b[1].flip(0), s, TOL_GRAD)
    np.testing.assert_allclose(h_two["h"].numpy(), [float(h_one["h"])] * 2, rtol=TOL_FWD)
    value_only = PP.hamiltonian_cross_poly(*one[:6], SIG, eta)
    assert set(value_only) == {"h"}
    np.testing.assert_allclose(float(value_only["h"]), float(h_one["h"]), rtol=1e-6)


def _cross_pair_terms(qr, pr, mr, qc, pc, mc, u, eta, withlogdet):
    """The cross forward per ordered (row, column) pair, term by term as
    rhs_cross.cross_fwd_ops_per_pair and cross_fwd_eta_ops_per_pair count
    them (per-point factors applied per point).  Float64 numpy; masks are
    0/1."""
    pt = mc[:, None] * pc                    # mc folded into pc
    m, d = qr.shape
    v, w, e, b, f = (np.zeros((m, d)) for _ in range(5))
    s0, g = np.zeros(m), np.zeros(m)
    for i in range(m):
        for j in range(qc.shape[0]):
            dd = qr[i] - qc[j]
            r2 = dd @ dd
            k = np.exp(-0.5 * u * r2)
            pp = pr[i] @ pt[j]
            v[i] += k * pt[j]
            w[i] += (k * pp) * dd
            km = k * mc[j]
            e[i] += km * dd
            if eta:
                s0[i] += km
                b[i] += km * (dd @ (pr[i] - pt[j])) * dd
                h = km * r2
                f[i] += h * dd
                g[i] += h
    dc = -u * (pr * e).sum(1)
    if eta:
        kc = pr * s0[:, None] - v            # sum_j k c_ij
        v = v + eta * u * e
        w = u * w + eta * (u * u * b - u * kc - eta * u * u * (u * f - (d + 2) * e))
        dc = dc + eta * u * (u * g - d * s0)
    else:
        w = u * w
    dc = mr * dc if withlogdet else np.zeros(m)
    return mr[:, None] * v, mr[:, None] * w, dc


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("eta", [0.0, 0.3])
def test_cross_pair_terms_match_plain_version(d, eta):
    """The term lists behind the cross forward's bound compute the same
    function as its plain version; float64, 23 rows against 17 columns."""
    r = np.random.default_rng(d)
    qr, qc = r.normal(size=(23, d)), r.normal(size=(17, d))
    pr, pc = 0.4 * r.normal(size=(23, d)), 0.4 * r.normal(size=(17, d))
    mr = (r.uniform(size=23) > 0.2).astype(np.float64)
    mc = (r.uniform(size=17) > 0.2).astype(np.float64)
    u = 1.0 / SIG ** 2
    for wl in (True, False):
        want = _cross_pair_terms(qr, pr, mr, qc, pc, mc, u, eta, wl)
        got = RC.rhs_cross_fwd_reference(*_t(qr, pr, mr, qc, pc, mc), SIG, wl, eta)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-12)
    assert (RC.cross_fwd_ops_per_pair(2), RC.cross_fwd_eta_ops_per_pair(2, True),
            RC.cross_fwd_eta_ops_per_pair(2, False)) == (22, 39, 38)


@pytest.mark.parametrize("eta", [0.0, 0.3])
def test_cross_forward_partitions_the_self_forward(eta):
    """The cross forward of a set's rows against a partition of its columns
    sums to the self forward, two frames; the CPU wrapper is the plain
    version, and a CPU tensor cannot reach the kernel."""
    r = np.random.default_rng(5)
    q = torch.as_tensor(r.normal(size=(2, 60, 3)).astype(np.float32))
    p = torch.as_tensor(0.3 * r.normal(size=(2, 60, 3)).astype(np.float32))
    m = torch.as_tensor((r.uniform(size=(2, 60)) > 0.2).astype(np.float32))
    want = RS.rhs_self_fwd_reference(q, p, m, SIG, True, eta)
    parts = [RC.rhs_cross_fwd(q, p, m, q[:, s], p[:, s], m[:, s], SIG, True, eta)
             for s in (slice(0, 25), slice(25, 60))]
    for i in range(3):
        _close(parts[0][i] + parts[1][i], want[i], 1e-5)
    whole = RC.rhs_cross_fwd(q, p, m, q, p, m, SIG, True, eta)
    for g, w in zip(whole, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="unsupported device"):
        RC.launch_fwd(q, p, m, q, p, m, SIG, True, eta, eta != 0.0)


def test_cross_functions_gradcheck_float64():
    """The three Functions' backwards against finite differences, float64,
    eta = 0.3 (the generated kernel-sums) and eta = 0 (the ext kernels' plain
    versions for RHSXCross)."""
    r = np.random.default_rng(9)

    def t(*shape, scale=1.0, grad=True):
        return torch.tensor(scale * r.normal(size=shape), requires_grad=grad)

    qr, pr, qc, pc, x = t(9, 2), t(9, 2, scale=0.3), t(7, 2), t(7, 2, scale=0.3), t(8, 2)
    mr = torch.tensor((r.uniform(size=9) > 0.2).astype(np.float64))
    mc = torch.tensor((r.uniform(size=7) > 0.2).astype(np.float64))
    mx = torch.tensor((r.uniform(size=8) > 0.2).astype(np.float64))
    for eta in (0.0, 0.3):
        assert torch.autograd.gradcheck(
            lambda a, b, c, e: RC.RHSCross.apply(a, b, mr, c, e, mc, SIG, True, eta),
            (qr, pr, qc, pc))
        assert torch.autograd.gradcheck(
            lambda a, b, c: RC.RHSXCross.apply(a, mx, b, c, mc, SIG, True, eta), (x, qc, pc))
        assert torch.autograd.gradcheck(
            lambda a, b, c, e: RC.HamiltonianCross.apply(a, b, mr, c, e, mc, SIG, eta),
            (qr, pr, qc, pc))


def test_mm_center_is_the_column_centroid():
    """The backward's shift is the column set's masked centroid, as the JAX
    ops take it."""
    c = KS.mm_center(*_t(QC, MC))
    np.testing.assert_allclose(c.numpy()[0], np.asarray(_mm_center(*_j(QC, MC))),
                               rtol=1e-6)


@pytest.mark.parametrize("sigma", [0.1, 0.05])
def test_cross_table_scheme_meets_the_forward_tolerance(sigma):
    """The eta = 0 cross kernel's float32 arithmetic, emulated
    (tests/tf32_emulation.table_scheme: the rows of one spiral cloud in
    row_order's blocks, each block's table centred on its masked centroid
    over the columns of a warped second cloud in their own order, 3xTF32 in
    truncating 32-column tiles), within TOL_FWD (1e-5, relative to the
    largest output; dcost's row sum relative to the sum of |partials|) of the
    float64 plain version, at the ring's sigma (0.1) and the grid path's
    (0.05); 2,048 rows against 1,536 columns, ~10% of each masked."""
    from difficp_torch.examples.run_large import spiral_cloud, warp
    from tf32_emulation import table_scheme

    tol = 1e-5
    rng = np.random.default_rng(5)
    qr = spiral_cloud(2048, rng)
    qc = warp(spiral_cloud(1536, rng), 2)
    pr = (0.05 * rng.normal(size=(2048, 2))).astype(np.float32)
    pc = (0.05 * rng.normal(size=(1536, 2))).astype(np.float32)
    mr = (rng.uniform(size=2048) > 0.1).astype(np.float32)
    mc = (rng.uniform(size=1536) > 0.1).astype(np.float32)
    args = _t(qr, pr, mr, qc, pc, mc)
    rv, rw, rdc = RC.rhs_cross_fwd_reference(*(t.double() for t in args), sigma, True)
    order = RS.row_order(args[0], args[2], sigma)
    v, w, dc = table_scheme(*args, sigma, order)
    for x, ref in ((v, rv), (w, rw)):
        assert float((x.double() - ref).abs().max() / ref.abs().max()) <= tol
    assert float((dc.double().sum() - rdc.sum()).abs() / rdc.abs().sum()) <= tol
