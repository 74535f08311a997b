"""The CUDA kernels of difficp_torch/csrc/ (rhs_self.cu, rhs_ext.cu,
kmin2.cu, ksum.cu) on the card, against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has a card and no JAX.  From the repository root there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets JAX up.)  Without a card
every test skips.
"""

import numpy as np
import pytest
import torch

from difficp_torch.models import lddmm
from difficp_torch.ops import backend
from difficp_torch.ops import rhs_self as RS

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

SIG = 0.1
# float32 pair sums taken in another order than the plain version, relative
# to the largest |plain| output (as chip_smoke.py)
TOL_FWD = 1e-5
TOL_BWD = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _inputs(b, m, d, seed, device):
    """Box cloud of side 1 (R / sigma = 10), ragged mask with a padded tail."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(size=(b, m, d))
    p = 0.05 * rng.normal(size=(b, m, d))
    mask = (rng.uniform(size=(b, m)) > 0.1).astype(np.float64)
    mask[:, -5:] = 0.0
    a = rng.normal(size=(b, m, d))
    gb = rng.normal(size=(b, m, d))
    c = rng.normal(size=(b,))
    return [torch.tensor(x, dtype=torch.float32, device=device)
            for x in (q, p, mask, a, gb, c)]


def _close(x, ref, tol):
    x, ref = x.double().cpu(), ref.double().cpu()
    err = float((x - ref).abs().max())
    scale = float(ref.abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("withlogdet", [True, False])
def test_kernels_match_plain(cuda, d, withlogdet):
    """Forward and backward kernels against the plain versions evaluated in
    float64 on the same float32 inputs, M = 3,001 (not a multiple of the
    block), masked."""
    q, p, m, a, b, c = _inputs(1, 3001, d, seed=d, device=cuda)
    v, w, dc = RS.rhs_self_fwd(q, p, m, SIG, withlogdet)
    dq, dp = RS.rhs_self_bwd(q, p, m, a, b, c, SIG, withlogdet)
    torch.cuda.synchronize()
    f64 = [t.double() for t in (q, p, m, a, b, c)]
    rv, rw, rdc = RS.rhs_self_fwd_reference(*f64[:3], SIG, withlogdet)
    rq, rp = RS.rhs_self_bwd_reference(*f64, SIG, withlogdet)
    _close(v, rv, TOL_FWD)
    _close(w, rw, TOL_FWD)
    # the dcost sum cancels: its error is relative to the sum of |partials|
    assert float((dc.double().sum() - rdc.sum()).abs()) <= TOL_FWD * float(
        rdc.abs().sum())
    _close(dq, rq, TOL_BWD)
    _close(dp, rp, TOL_BWD)
    assert bool((v[m == 0] == 0).all()) and bool((dq[m == 0] == 0).all())


def test_frames_are_independent(cuda):
    """A batch of three frames (one grid row each) gives what each frame
    gives alone."""
    q, p, m, a, b, c = _inputs(3, 1000, 2, seed=7, device=cuda)
    batch = RS.rhs_self_fwd(q, p, m, SIG, True) + RS.rhs_self_bwd(
        q, p, m, a, b, c, SIG, True)
    for k in range(3):
        one = RS.rhs_self_fwd(q[k:k + 1], p[k:k + 1], m[k:k + 1], SIG, True) + \
            RS.rhs_self_bwd(q[k:k + 1], p[k:k + 1], m[k:k + 1], a[k:k + 1],
                            b[k:k + 1], c[k:k + 1], SIG, True)
        for x, y in zip(batch, one):
            torch.testing.assert_close(x[k:k + 1], y, rtol=1e-6, atol=0.0)


def _spiral_inputs(b, m, d, seed, device, masked=True):
    """Spiral clouds (the main paths' geometry, rows in random order), a
    ragged mask or none, momenta and cotangents."""
    from difficp_torch.examples.run_large import spiral_cloud

    rng = np.random.default_rng(seed)
    q = np.stack([spiral_cloud(m, np.random.default_rng(seed + k), dim=d) for k in range(b)])
    mask = (rng.uniform(size=(b, m)) > 0.1).astype(np.float64) if masked else np.ones((b, m))
    p = 0.05 * rng.normal(size=(b, m, d))
    a, gb = rng.normal(size=(2, b, m, d))
    c = rng.normal(size=(b,))
    return [torch.tensor(x, dtype=torch.float32, device=device)
            for x in (q, p, mask, a, gb, c)]


@pytest.mark.parametrize("m", [37, 3001, 40001])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("withlogdet", [True, False])
def test_table_kernels_match_plain(cuda, m, masked, d, withlogdet):
    """The eta = 0 table kernels (forward and backward) against the plain
    versions in float64 on a spiral cloud, masked and unmasked: M = 37 (less
    than one warpgroup's 64 rows), 3,001 (blocks of 64 rows, the grid too
    small to take more) and 40,001 (blocks of 256 rows); none a multiple of
    the block's rows or of the 32-column tile.  TOL_FWD and TOL_BWD relative
    to the largest output."""
    q, p, mk, a, b, c = _spiral_inputs(1, m, d, seed=m + d, device=cuda, masked=masked)
    v, w, dc = RS.rhs_self_fwd(q, p, mk, SIG, withlogdet)
    dq, dp = RS.rhs_self_bwd(q, p, mk, a, b, c, SIG, withlogdet)
    torch.cuda.synchronize()
    f64 = [t.double() for t in (q, p, mk, a, b, c)]
    rv, rw, rdc = RS.rhs_self_fwd_reference(*f64[:3], SIG, withlogdet)
    rq, rp = RS.rhs_self_bwd_reference(*f64, SIG, withlogdet)
    _close(v, rv, TOL_FWD)
    _close(w, rw, TOL_FWD)
    if withlogdet:
        assert float((dc.double().sum() - rdc.sum()).abs()) <= TOL_FWD * float(
            rdc.abs().sum())
    else:
        assert bool((dc == 0).all())
    _close(dq, rq, TOL_BWD)
    _close(dp, rp, TOL_BWD)
    assert bool((v[mk == 0] == 0).all()) and bool((dp[mk == 0] == 0).all())


@pytest.mark.parametrize("d", [2, 3])
def test_rows_shuffled_against_unshuffled(cuda, d):
    """The table kernels on a frame whose rows are shuffled give, permuted
    back, the unshuffled frame's outputs within TOL_FWD (forward) and
    TOL_BWD (backward): the row order they compute puts both in the same
    blocks up to ties, and each output depends only on differences."""
    q, p, mk, a, b, c = _spiral_inputs(2, 5000, d, seed=20 + d, device=cuda)
    perm = torch.randperm(5000, generator=torch.Generator().manual_seed(d)).to(cuda)
    inv = torch.argsort(perm)
    ref = RS.rhs_self_fwd(q, p, mk, SIG, True) + RS.rhs_self_bwd(q, p, mk, a, b, c, SIG, True)
    sq, sp, sm, sa, sb = (t[:, perm].contiguous() for t in (q, p, mk, a, b))
    got = RS.rhs_self_fwd(sq, sp, sm, SIG, True) + RS.rhs_self_bwd(sq, sp, sm, sa, sb, c, SIG,
                                                                     True)
    for k, (x, y) in enumerate(zip(got, ref)):
        _close(x[:, inv], y, TOL_FWD if k < 3 else TOL_BWD)


def test_row_order_is_computed_once_per_optimisation(cuda):
    """lddmm.optimize on the kernel route computes the rows' order once (at
    q0, fixed over the call) for all its loss+grad evaluations; a shoot
    alone computes one for all its steps."""
    q0, p0, m, *_ = _spiral_inputs(1, 800, 2, seed=4, device=cuda)
    cfg = lddmm.make_config(sigma=SIG, lambd=200.0, version="hybrid", nt=4,
                            scheme="Ralston")
    y = q0 + 0.02
    try:
        backend.set_backend("kernel")
        for counts in (RS.launches, RS.orders):
            for key in counts:
                counts[key] = 0
        lddmm.optimize(cfg, lddmm.quad_dataloss(y), q0, 0.1 * p0, None, m, nmax=2, inner=3)
        evals = RS.launches["rhs_self_bwd"] / (2 * cfg.nt)
        assert evals >= 2 and RS.orders["row_order"] == 1
        lddmm.shoot(cfg, q0, p0, None, m)
        assert RS.orders["row_order"] == 2
    finally:
        backend.set_backend(None)


def test_functions_on_card_match_cpu(cuda):
    """RHSSelf and Hamiltonian with autograd on the card against the same
    Functions on the CPU (the plain versions) in float64."""
    inputs = _inputs(2, 700, 3, seed=3, device=cuda)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        q, p, m, a, b, c = (t.to(dev).clone() if dev.type == "cuda"
                            else t.to(dev).double() for t in inputs)
        q.requires_grad_(True)
        p.requires_grad_(True)
        v, w, dcost = RS.RHSSelf.apply(q, p, m, SIG, True)
        h = RS.Hamiltonian.apply(q, p, m, SIG)
        loss = (v * a).sum() + (w * b).sum() + (c * dcost).sum() + h.sum()
        out[dev.type] = (v, w, dcost, h, *torch.autograd.grad(loss, (q, p)))
    for x, ref in zip(out["cuda"], out["cpu"]):
        _close(x.detach(), ref.detach(), TOL_BWD)


def test_launch_counters(cuda):
    """One count per kernel launch: RHSSelf runs the forward and the
    backward kernel once each; the Hamiltonian's gradient needs no kernel."""
    q, p, m, *_ = _inputs(1, 256, 2, seed=1, device=cuda)
    q.requires_grad_(True)
    p.requires_grad_(True)
    for key in RS.launches:
        RS.launches[key] = 0
    v, w, dcost = RS.RHSSelf.apply(q, p, m, SIG, True)
    torch.autograd.grad(v.sum() + w.sum() + dcost.sum(), (q, p))
    assert RS.launches == {"rhs_self_fwd": 1, "rhs_self_bwd": 1, "rhs_self_fwd_eta": 0}
    torch.autograd.grad(RS.Hamiltonian.apply(q, p, m, SIG).sum(), (q, p))
    assert RS.launches == {"rhs_self_fwd": 2, "rhs_self_bwd": 1, "rhs_self_fwd_eta": 0}


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, p, m, a, b, c = _inputs(1, 64, 2, seed=2, device=cuda)
    with pytest.raises(ValueError):
        RS.rhs_self_fwd(q.double(), p.double(), m.double(), SIG, True)
    with pytest.raises(ValueError):
        RS.rhs_self_fwd(q.transpose(-1, -2).contiguous().transpose(-1, -2), p, m,
                        SIG, True)
    with pytest.raises(ValueError):
        RS.rhs_self_fwd(q, p, m[..., :-1], SIG, True)
    with pytest.raises(ValueError):
        RS.rhs_self_bwd(q, p, m, a, b, c.cpu(), SIG, True)
    q4 = torch.zeros((1, 64, 4), device=cuda)
    with pytest.raises(ValueError):
        RS.rhs_self_fwd(q4, q4, m, SIG, True)


@pytest.mark.parametrize("scheme", ["Euler", "Ralston"])
def test_shoot_kernel_route_matches_dense_on_card(cuda, scheme):
    """Geodesic shooting and its gradient on the card: the kernel route
    against the dense route, M = 500, hybrid (logdet on)."""
    q0, p0, m, *_ = _inputs(1, 500, 2, seed=5, device=cuda)
    cfg = lddmm.make_config(sigma=SIG, lambd=200.0, version="hybrid", nt=5,
                            scheme=scheme)
    res = {}
    try:
        for mode in ("kernel", "dense"):
            backend.set_backend(mode)
            p = p0.clone().requires_grad_(True)
            final, _ = lddmm.shoot(cfg, q0, p, None, m)
            loss = (lddmm.trajloss(cfg, q0, p, final.cost, m).sum()
                    + (final.q ** 2).sum())
            res[mode] = (final.q, final.p, final.cost, loss,
                         torch.autograd.grad(loss, p)[0])
    finally:
        backend.set_backend(None)
    for x, ref in zip(res["kernel"], res["dense"]):
        _close(x.detach(), ref.detach(), TOL_BWD)


# ---------------------------------------------------------------------------
# external-point RHS (csrc/rhs_ext.cu) and kmin2 (csrc/kmin2.cu)
# ---------------------------------------------------------------------------

def _ext_inputs(b, n, m, d, seed, device):
    """Data in a unit box with a ragged mask, support on a grid-like set of
    m points (some masked), random momenta and cotangents."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(b, n, d))
    mx = (rng.uniform(size=(b, n)) > 0.1).astype(np.float64)
    mx[:, -3:] = 0.0
    q = rng.uniform(-0.05, 1.05, size=(b, m, d))
    p = 0.05 * rng.normal(size=(b, m, d))
    mq = (rng.uniform(size=(b, m)) > 0.05).astype(np.float64)
    gx = rng.normal(size=(b, n, d))
    gc = rng.normal(size=(b,))
    return [torch.tensor(t, dtype=torch.float32, device=device)
            for t in (x, mx, q, p, mq, gx, gc)]


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("withlogdet", [True, False])
def test_ext_kernels_match_plain(cuda, d, withlogdet):
    """The three ext kernels against their plain versions in float64 on the
    same float32 inputs: N = 5,003 data points (several dq/dp chunks, not a
    multiple of the block), M = 301 support points, two frames."""
    from difficp_torch.ops import rhs_ext as RE

    x, mx, q, p, mq, gx, gc = _ext_inputs(2, 5003, 301, d, seed=d, device=cuda)
    vx, dc = RE.rhs_ext_fwd(x, mx, q, p, mq, SIG, withlogdet)
    dx = RE.rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc, SIG, withlogdet)
    dq, dp = RE.rhs_ext_bwd_dqdp(x, mx, gx, q, p, mq, gc, SIG, withlogdet)
    torch.cuda.synchronize()
    x8, mx8, q8, p8, mq8, gx8, gc8 = (t.double() for t in (x, mx, q, p, mq, gx, gc))
    rvx, rdc = RE.rhs_ext_fwd_reference(x8, mx8, q8, p8, mq8, SIG, withlogdet)
    rdx = RE.rhs_ext_bwd_dx_reference(x8, mx8, gx8, q8, p8, mq8, gc8, SIG, withlogdet)
    rdq, rdp = RE.rhs_ext_bwd_dqdp_reference(x8, mx8, gx8, q8, p8, mq8, gc8, SIG,
                                             withlogdet)
    _close(vx, rvx, TOL_FWD)
    assert float((dc.double().sum(-1) - rdc.sum(-1)).abs().max()) <= TOL_FWD * float(
        rdc.abs().sum(-1).max()) + 1e-30
    _close(dx, rdx, TOL_BWD)
    _close(dq, rdq, TOL_BWD)
    _close(dp, rdp, TOL_BWD)
    assert bool((vx[mx == 0] == 0).all()) and bool((dq[mq == 0] == 0).all())


def test_ext_frames_are_independent(cuda):
    from difficp_torch.ops import rhs_ext as RE

    x, mx, q, p, mq, gx, gc = _ext_inputs(3, 2100, 90, 2, seed=4, device=cuda)

    def run(sl):
        a = [t[sl] for t in (x, mx, gx, q, p, mq, gc)]
        return (RE.rhs_ext_fwd(a[0], a[1], a[3], a[4], a[5], SIG, True)
                + (RE.rhs_ext_bwd_dx(*a, SIG, True),)
                + RE.rhs_ext_bwd_dqdp(*a, SIG, True))

    batch = run(slice(0, 3))
    for k in range(3):
        for got, one in zip(batch, run(slice(k, k + 1))):
            torch.testing.assert_close(got[k:k + 1], one, rtol=1e-6, atol=0.0)


def _ext_spiral_inputs(b, n, d, support, seed, device, sigma=0.05):
    """Ragged spiral frames (the grid paths' geometry, rows in random order)
    of n data points, ~10% masked with a padded tail, with the grid support
    at sigma (the grid paths' 0.05 by default) or a masked custom support of
    500 points; random momenta and cotangents."""
    from difficp_torch.examples.run_large import spiral_cloud
    from difficp_torch.utils.point_sets import grid_support

    rng = np.random.default_rng(seed)
    x = np.stack([spiral_cloud(n, np.random.default_rng(seed + k), dim=d) for k in range(b)])
    mx = (rng.uniform(size=(b, n)) > 0.1).astype(np.float64)
    mx[:, -7:] = 0.0
    if support == "grid":
        qg = grid_support(x.reshape(-1, d), sigma)
        q = np.broadcast_to(qg, (b, *qg.shape)).copy()
        mq = np.ones(q.shape[:-1])
    else:
        q = rng.uniform(x.min((0, 1)), x.max((0, 1)), size=(b, 500, d))
        mq = (rng.uniform(size=(b, 500)) > 0.2).astype(np.float64)
    p = 0.05 * rng.normal(size=q.shape) * mq[..., None]
    gx = rng.normal(size=x.shape)
    gc = rng.normal(size=(b,))
    return [torch.tensor(t, dtype=torch.float32, device=device)
            for t in (x, mx, q, p, mq, gx, gc)]


def _table_kernels_match_plain(cuda, d, support, shuffled, sig):
    from difficp_torch.ops import rhs_ext as RE

    x, mx, q, p, mq, gx, gc = _ext_spiral_inputs(2, 5003, d, support, seed=d, device=cuda,
                                                 sigma=sig)
    if shuffled:
        g = torch.Generator().manual_seed(d)
        px, pq = (torch.randperm(n, generator=g).to(cuda) for n in (x.shape[1], q.shape[1]))
        x, mx, gx = (t[:, px].contiguous() for t in (x, mx, gx))
        q, p, mq = (t[:, pq].contiguous() for t in (q, p, mq))
    for wl in (True, False):
        dx = RE.rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc, sig, wl)
        dq, dp = RE.rhs_ext_bwd_dqdp(x, mx, gx, q, p, mq, gc, sig, wl)
        torch.cuda.synchronize()
        x8, mx8, q8, p8, mq8, gx8, gc8 = (t.double() for t in (x, mx, q, p, mq, gx, gc))
        rdx = RE.rhs_ext_bwd_dx_reference(x8, mx8, gx8, q8, p8, mq8, gc8, sig, wl)
        rdq, rdp = RE.rhs_ext_bwd_dqdp_reference(x8, mx8, gx8, q8, p8, mq8, gc8, sig, wl)
        _close(dx, rdx, TOL_BWD)
        _close(dq, rdq, TOL_BWD)
        _close(dp, rdp, TOL_BWD)
        assert bool((dx[mx == 0] == 0).all()) and bool((dq[mq == 0] == 0).all())


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("support", ["grid", "custom"])
@pytest.mark.parametrize("d", [2, 3])
def test_ext_table_kernels_match_plain(cuda, d, support, shuffled):
    """The dx and dq/dp table kernels against their float64 plain versions
    on two ragged, masked spiral frames of 5,003 points (dq/dp in several
    chunks) at sigma = 0.05, grid and masked custom support, logdet on and
    off; with the data and support rows also shuffled (the outputs permuted
    back; the kernels take the rows in their orders either way).  TOL_BWD
    relative to the largest output; masked rows exactly 0."""
    _table_kernels_match_plain(cuda, d, support, shuffled, 0.05)


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("support", ["grid", "custom"])
@pytest.mark.parametrize("d", [2, 3])
def test_ext_table_kernels_match_plain_at_half_sigma(cuda, d, support, shuffled):
    """As test_ext_table_kernels_match_plain at sigma = 0.025 (a cloud twice
    as wide against the Gaussian; at d = 3 a sparse one, which needs the
    data order's cuts: rhs_ext.DATA_ORDER_PAD_BUDGET)."""
    _table_kernels_match_plain(cuda, d, support, shuffled, 0.025)


def test_ext_table_kernels_are_bit_for_bit_reproducible(cuda):
    """Two calls of each VJP kernel on the same inputs give the same bits
    (dq/dp's chunk partials are summed in chunk order, no float atomics),
    each call counts one launch, and dq/dp leaves its tickets at 0."""
    from difficp_torch.ops import rhs_ext as RE

    x, mx, q, p, mq, gx, gc = _ext_spiral_inputs(3, 20000, 2, "grid", seed=5, device=cuda)
    for key in RE.launches:
        RE.launches[key] = 0
    runs = [(RE.rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc, 0.05, True),
             *RE.rhs_ext_bwd_dqdp(x, mx, gx, q, p, mq, gc, 0.05, True)) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert RE.launches["rhs_ext_bwd_dx"] == 2 and RE.launches["rhs_ext_bwd_dqdp"] == 2
    assert not bool(RE._workspace[x.device][1].any())


@pytest.mark.parametrize("exclude_self", [False, True])
def test_kmin2_matches_plain(cuda, exclude_self):
    """kmin2 against its plain version on duplicated points (ties), a masked
    y and 4 x 3 leading frames; relative 1e-6 (one rounding of a square)."""
    from difficp_torch.ops import kmin2 as K2

    rng = np.random.default_rng(9)
    n = 3001
    y = rng.uniform(size=(4, 3, n, 2))
    y[..., 100:200, :] = y[..., :100, :]  # exact duplicates
    x = y if exclude_self else rng.uniform(size=(4, 3, 777, 2))
    my = (rng.uniform(size=(4, 3, n)) > 0.1).astype(np.float64)
    x, y, my = (torch.tensor(t, dtype=torch.float32, device=cuda) for t in (x, y, my))
    m1, m2 = K2.kmin2(x, y, my, exclude_self)
    r1, r2 = K2.kmin2_reference(x.double(), y.double(), my.double(), exclude_self)
    for got, ref in ((m1, r1), (m2, r2)):
        torch.testing.assert_close(got.double(), ref, rtol=1e-6, atol=1e-12)
    assert bool((m2 >= m1).all())


def _kmin2_ragged(frames, n, m, d, seed, device):
    """Frames of y with a different count of valid columns each (all, all
    but 3, one, none, half, two, ...), the padding at the end on a point of
    its own where three rows of x sit, exact duplicates among the valid
    columns; x spiral-like uniform points."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(size=(frames, m, d))
    my = np.zeros((frames, m))
    for f in range(frames):
        valid = [m, m - 3, 1, 0, m // 2, 2][f % 6]
        my[f, :valid] = 1.0
        y[f, valid:] = -1.0
        y[f, valid // 2: valid // 2 + valid // 8] = y[f, :valid // 8]
    x = rng.uniform(size=(frames, n, d))
    x[:, :3] = -1.0
    return (torch.tensor(t, dtype=torch.float32, device=device) for t in (x, y, my))


def _kmin2_hold(K2, x, y, my, exclude_self):
    """kmin2 against its float64 plain version: +inf where it has +inf, each
    finite distance within one rounding of a square (relative 1e-6); two
    calls agree bit for bit."""
    m1, m2 = K2.kmin2(x, y, my, exclude_self)
    again = K2.kmin2(x, y, my, exclude_self)
    r1, r2 = K2.kmin2_reference(x.double(), y.double(), my.double(), exclude_self)
    for got, ref in ((m1, r1), (m2, r2)):
        assert torch.equal(torch.isinf(got), torch.isinf(ref))
        fin = torch.isfinite(ref)
        torch.testing.assert_close(got.double()[fin], ref[fin], rtol=1e-6, atol=0)
    assert torch.equal(m1, again[0]) and torch.equal(m2, again[1])
    return m1, m2


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("d", [2, 3])
def test_kmin2_ragged_masks(cuda, d, exclude_self):
    """Frames with ragged masks (the padding at the end, as decim support
    gives), fewer than two valid columns, ties, rows on the padding's place;
    12 frames of 3,001 x 1,500 (several tiles of columns) and one frame of
    65,536 points with exclude_self and a masked tail."""
    from difficp_torch.ops import kmin2 as K2

    x, y, my = _kmin2_ragged(12, 3001, 1500, d, seed=d, device=cuda)
    if exclude_self:
        x = y
    m1, m2 = _kmin2_hold(K2, x, y, my, exclude_self)
    assert bool(torch.isinf(m2[3]).all()) and bool(torch.isinf(m1[3]).all())  # none valid
    assert bool(torch.isinf(m2[2]).all())  # one valid
    assert bool((m1 == m2).any())
    if not exclude_self:
        assert bool((m1[:, :3][my[:, -1] == 0] > 0).all())  # the padding never wins
        return
    rng = np.random.default_rng(11 + d)
    one = torch.tensor(rng.uniform(size=(1, 65536, d)), dtype=torch.float32, device=cuda)
    one[0, 1000:1100] = one[0, :100]  # duplicates: distance 0 to another point
    mask = torch.ones((1, 65536), device=cuda)
    mask[0, -777:] = 0.0
    n1, _ = _kmin2_hold(K2, one, one, mask, True)
    assert bool((n1[0, :100] == 0).all())


def test_ext_launch_counters(cuda):
    """One loss+grad of an Euler shoot with external points on the kernel
    route (nt = 4): per step one self and one ext forward, one self
    backward, one dx and one dq/dp launch; the Hamiltonian adds one self
    forward; one coverage check is one kmin2 launch for every step and
    frame."""
    from difficp_torch.ops import kmin2 as K2
    from difficp_torch.ops import rhs_ext as RE

    x, mx, q, p0, mq, *_ = _ext_inputs(2, 900, 40, 2, seed=6, device=cuda)
    cfg = lddmm.make_config(sigma=SIG, lambd=200.0, version="hybrid", nt=4,
                            scheme="Euler")
    for counts in (RS.launches, RE.launches, K2.launches):
        for key in counts:
            counts[key] = 0
    backend.set_backend("kernel")
    try:
        p = p0.clone().requires_grad_(True)
        final, _ = lddmm.shoot(cfg, q, p, x, mq, mx)
        loss = lddmm.trajloss(cfg, q, p, final.cost, mq).sum() + (final.x ** 2).sum()
        torch.autograd.grad(loss, p)
        _, traj = lddmm.shoot(cfg, q, p.detach(), x, mq, mx, save_traj=True)
        backend.check_coverage(traj.x, traj.q, SIG, 2.0, mx, mq)
    finally:
        backend.set_backend(None)
    assert RS.launches == {"rhs_self_fwd": 4 + 1 + 4, "rhs_self_bwd": 4,
                           "rhs_self_fwd_eta": 0}
    assert RE.launches == {"rhs_ext_fwd": 8, "rhs_ext_bwd_dx": 4, "rhs_ext_bwd_dqdp": 4,
                           "rhs_ext_fwd_eta": 0}
    assert K2.launches == {"kmin2": 1}


def test_ext_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from difficp_torch.ops import kmin2 as K2
    from difficp_torch.ops import rhs_ext as RE

    x, mx, q, p, mq, gx, gc = _ext_inputs(1, 64, 16, 2, seed=2, device=cuda)
    with pytest.raises(ValueError):
        RE.rhs_ext_fwd(x.double(), mx, q, p, mq, SIG, True)
    with pytest.raises(ValueError):
        RE.rhs_ext_fwd(x, mx[..., :-1], q, p, mq, SIG, True)
    with pytest.raises(ValueError):
        RE.rhs_ext_fwd(x[None], mx[None], q, p, mq, SIG, True)  # frames differ
    with pytest.raises(ValueError):
        RE.rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc.cpu(), SIG, True)
    with pytest.raises(ValueError):
        RE.rhs_ext_bwd_dqdp(x, mx, gx.transpose(-1, -2).contiguous().transpose(-1, -2),
                            q, p, mq, gc, SIG, True)
    order = RS.row_order(q, mq, SIG)
    with pytest.raises(ValueError):  # the support's order as int64
        RE.rhs_ext_bwd_dqdp(x, mx, gx, q, p, mq, gc, SIG, True, order.long())
    with pytest.raises(ValueError):  # an order shorter than the support
        RE.rhs_ext_bwd_dqdp(x, mx, gx, q, p, mq, gc, SIG, True, order[..., :8].contiguous())
    xorder = RS.row_order(x, mx, SIG)
    with pytest.raises(ValueError):  # the data rows' order as int64
        RE.rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc, SIG, True, xorder.long())
    with pytest.raises(ValueError):  # an order shorter than the data
        RE.rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc, SIG, True, xorder[..., :8].contiguous())
    with pytest.raises(ValueError):
        K2.kmin2(x, q, mq[..., :-1])
    with pytest.raises(ValueError):
        K2.kmin2(x, q, mq, exclude_self=True)
    x4 = torch.zeros((1, 64, 4), device=cuda)
    with pytest.raises(ValueError):
        K2.kmin2(x4, x4)


@pytest.mark.parametrize("scheme", ["Euler", "Ralston"])
def test_ext_shoot_kernel_route_matches_dense_on_card(cuda, scheme):
    """Shooting with external points and its gradient on the card: the
    kernel route against the dense route, N = 700, M = 60, hybrid."""
    x, mx, q, p0, mq, *_ = _ext_inputs(2, 700, 60, 2, seed=5, device=cuda)
    cfg = lddmm.make_config(sigma=SIG, lambd=200.0, version="hybrid", nt=5,
                            scheme=scheme)
    res = {}
    try:
        for mode in ("kernel", "dense"):
            backend.set_backend(mode)
            p = p0.clone().requires_grad_(True)
            final, _ = lddmm.shoot(cfg, q, p, x, mq, mx)
            loss = (lddmm.trajloss(cfg, q, p, final.cost, mq).sum()
                    + (final.x ** 2).sum())
            res[mode] = (final.q, final.p, final.x, final.cost, loss,
                         torch.autograd.grad(loss, p)[0])
    finally:
        backend.set_backend(None)
    for got, ref in zip(res["kernel"], res["dense"]):
        _close(got.detach(), ref.detach(), TOL_BWD)


# ---------------------------------------------------------------------------
# the gradcomponent (eta != 0) slice: the generic kernel-sum and the ETA
# instances of the forward kernels
# ---------------------------------------------------------------------------

ETA = 0.07


def _ksum_inputs(b, nx, ny, d, ncols, seed, device, shared=False):
    """Rows and columns in a unit box, a ragged column mask, a table of
    ncols payload columns (per frame, or shared with shared=True)."""
    rng = np.random.default_rng(seed)
    yb = () if shared else (b,)
    x = rng.uniform(size=(b, nx, d))
    y = rng.uniform(size=(*yb, ny, d))
    my = (rng.uniform(size=(*yb, ny)) > 0.1).astype(np.float64)
    t = rng.normal(size=(*yb, ncols, ny))
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in (x, y, my, t)]


@pytest.mark.parametrize("d,ncols", [(2, 3), (2, 6), (2, 9), (2, 20), (2, 121), (3, 333)])
def test_ksum_matches_plain(cuda, d, ncols):
    """The generic kernel-sum against its plain version in float64 on the
    same float32 inputs: two frames of 1,001 rows against 1,503 masked
    columns, at every table width the eta model sends (several column
    chunks from 40 columns on), relative to the largest |plain| output."""
    from difficp_torch.ops import ksum as KS

    x, y, my, t = _ksum_inputs(2, 1001, 1503, d, ncols, seed=ncols, device=cuda)
    got = KS.ksum(x, y, t, my, SIG)
    torch.cuda.synchronize()
    ref = KS.ksum_reference(x.double(), y.double(), t.double(), my.double(), SIG)
    assert got.shape == (2, ncols, 1001)
    _close(got, ref, TOL_FWD)


@pytest.mark.parametrize("shared", [False, True])
def test_ksum_split_and_shared_y(cuda, shared):
    """A short x side against a long y side splits the y axis over the grid
    (partials summed in the wrapper); a y without a frame axis serves every
    frame; no mask means all ones."""
    from difficp_torch.ops import ksum as KS

    x, y, _, t = _ksum_inputs(3, 300, 20000, 2, 20, seed=4, device=cuda, shared=shared)
    assert KS.splitting(3, 300, 20000, 20) < 20000
    got = KS.ksum(x, y, t, None, SIG)
    torch.cuda.synchronize()
    ref = KS.ksum_reference(x.double(), y.double(), t.double(), None, SIG)
    _close(got, ref, TOL_FWD)


@pytest.mark.parametrize("ncols", [1, 8, 9, 36, 128, 129, 333])
@pytest.mark.parametrize("nx", [15, 16, 17, 1001])
def test_ksum_tile_edges(cuda, nx, ncols):
    """The tensor-core kernel at the edges of its tiles: tables of 1, 8, 9,
    36, 128, 129 and 333 columns (steps of 8, chunks of at most 128) and
    x sides of 15, 16, 17 (a warp's 16 rows) and 1,001 rows, against a y
    side of 1,003 masked columns (not a multiple of the 64-column tile); d =
    3 from 129 columns on.  Float64 plain version, TOL_FWD."""
    from difficp_torch.ops import ksum as KS

    d = 3 if ncols > 128 else 2
    x, y, my, t = _ksum_inputs(2, nx, 1003, d, ncols, seed=nx + ncols, device=cuda)
    got = KS.ksum(x, y, t, my, SIG)
    torch.cuda.synchronize()
    ref = KS.ksum_reference(x.double(), y.double(), t.double(), my.double(), SIG)
    assert got.shape == (2, ncols, nx)
    _close(got, ref, TOL_FWD)


@pytest.mark.parametrize("case", ["shared", "self", "split"])
def test_ksum_cases_bit_for_bit(cuda, case):
    """A y shared by every frame, the self case (x = y, with holes in the
    mask) and a split y axis, each against the float64 plain version within
    TOL_FWD; and two calls give the same bits (no atomics, the splits
    summed in a fixed order)."""
    from difficp_torch.ops import ksum as KS

    if case == "shared":
        x, y, my, t = _ksum_inputs(3, 777, 2049, 2, 36, seed=7, device=cuda, shared=True)
    elif case == "self":
        x, _, my, t = _ksum_inputs(2, 1500, 1500, 3, 121, seed=8, device=cuda)
        y = x
    else:
        x, y, my, t = _ksum_inputs(10, 380, 40001, 2, 18, seed=9, device=cuda)
        assert -(-40001 // KS.splitting(10, 380, 40001, 18)) > 1
    got = KS.ksum(x, y, t, my, SIG)
    again = KS.ksum(x, y, t, my, SIG)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = KS.ksum_reference(x.double(), y.double(), t.double(), my.double(), SIG)
    _close(got, ref, TOL_FWD)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("withlogdet", [True, False])
def test_eta_forward_kernels_match_plain(cuda, d, withlogdet):
    """The ETA instances of the self and ext forward kernels against their
    plain versions in float64 (M = 3,001; N = 5,003 on M = 301, two
    frames)."""
    from difficp_torch.ops import rhs_ext as RE

    q, p, m, *_ = _inputs(2, 3001, d, seed=d, device=cuda)
    v, w, dc = RS.rhs_self_fwd(q, p, m, SIG, withlogdet, ETA)
    x, mx, qs, ps, mq, *_ = _ext_inputs(2, 5003, 301, d, seed=d, device=cuda)
    vx, dcx = RE.rhs_ext_fwd(x, mx, qs, ps, mq, SIG, withlogdet, ETA)
    torch.cuda.synchronize()
    rv, rw, rdc = RS.rhs_self_fwd_reference(q.double(), p.double(), m.double(), SIG,
                                            withlogdet, ETA)
    rvx, rdcx = RE.rhs_ext_fwd_reference(*(t.double() for t in (x, mx, qs, ps, mq)), SIG,
                                         withlogdet, ETA)
    for got, ref in ((v, rv), (w, rw), (vx, rvx)):
        _close(got, ref, TOL_FWD)
    for got, ref in ((dc, rdc), (dcx, rdcx)):
        assert float((got.double().sum(-1) - ref.sum(-1)).abs().max()) <= TOL_FWD * float(
            ref.abs().sum(-1).max())


def test_eta_instances_at_eta_zero_are_bit_identical(cuda):
    """The ETA instance at eta = 0 against the eta = 0 kernel: for the self
    forward (the table kernel on the tensor cores, which sums in another
    order) within TOL_FWD of its largest output; for the ext forward (the
    ETA instance adds the gradcomponent sums apart and combines them at the
    end) bit for bit."""
    from difficp_torch.ops import rhs_ext as RE

    q, p, m, *_ = _inputs(2, 2000, 2, seed=9, device=cuda)
    x, mx, qs, ps, mq, *_ = _ext_inputs(2, 3000, 200, 2, seed=9, device=cuda)
    for wl in (True, False):
        a = RS.launch_fwd(q, p, m, SIG, wl, 0.0, False)
        b = RS.launch_fwd(q, p, m, SIG, wl, 0.0, True)
        for u, v in zip(a[:2], b[:2]):
            _close(v, u, TOL_FWD)
        assert float((a[2].double().sum(-1) - b[2].double().sum(-1)).abs().max()) <= \
            TOL_FWD * float(b[2].double().abs().sum(-1).max())
        c = RE.launch_fwd(x, mx, qs, ps, mq, SIG, wl, 0.0, False)
        e = RE.launch_fwd(x, mx, qs, ps, mq, SIG, wl, 0.0, True)
        for u, v in zip(c, e):
            assert torch.equal(u, v)


def test_eta_shoot_on_card_matches_dense_and_counts_launches(cuda):
    """Shooting with external points at eta != 0 and its gradient on the
    card: the kernel route (the ETA forward kernels, the generated backward
    on ksum) against the dense route, N = 700, M = 60, nt = 4, logdet at
    lambda = 200 (eta = 1/200); and
    one count per launch: per step one ETA self and one ETA ext forward and
    three kernel-sums (self backward, dx, dq/dp); the Hamiltonian adds one
    kernel-sum (its value) and one ETA self forward (its gradient)."""
    from difficp_torch.ops import ksum as KS
    from difficp_torch.ops import rhs_ext as RE

    x, mx, q, p0, mq, *_ = _ext_inputs(2, 700, 60, 2, seed=5, device=cuda)
    cfg = lddmm.make_config(sigma=SIG, lambd=200.0, version="logdet", nt=4,
                            scheme="Euler")
    res = {}
    try:
        for mode in ("kernel", "dense"):
            backend.set_backend(mode)
            for counts in (RS.launches, RE.launches, KS.launches):
                for key in counts:
                    counts[key] = 0
            p = p0.clone().requires_grad_(True)
            final, _ = lddmm.shoot(cfg, q, p, x, mq, mx)
            loss = (lddmm.trajloss(cfg, q, p, final.cost, mq).sum()
                    + (final.x ** 2).sum())
            res[mode] = (final.q, final.p, final.x, final.cost, loss,
                         torch.autograd.grad(loss, p)[0])
            if mode == "kernel":
                launches = {**RS.launches, **RE.launches, **KS.launches}
    finally:
        backend.set_backend(None)
    for got, ref in zip(res["kernel"][:5], res["dense"][:5]):
        _close(got.detach(), ref.detach(), TOL_BWD)
    # the generated backward expands delta powers into raw monomials: the
    # JAX package's bound for it (tests/test_pair_poly.py), 1e-2
    _close(res["kernel"][5], res["dense"][5], 1e-2)
    assert launches == {"rhs_self_fwd": 0, "rhs_self_bwd": 0, "rhs_self_fwd_eta": 4 + 1,
                        "rhs_ext_fwd": 0, "rhs_ext_bwd_dx": 0, "rhs_ext_bwd_dqdp": 0,
                        "rhs_ext_fwd_eta": 4, "ksum": 3 * 4 + 1}



def _cross_inputs(b, m, n, d, seed, device):
    """Rows and columns from two different box clouds, each with a ragged
    mask and a padded tail."""
    q, p, mq, *_ = _inputs(b, m, d, seed, device)
    qc, pc, mc, *_ = _inputs(b, n, d, seed + 100, device)
    return q, p, mq, qc + 0.1, pc, mc


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("withlogdet", [True, False])
@pytest.mark.parametrize("eta", [0.0, ETA])
def test_cross_kernel_matches_plain(cuda, d, withlogdet, eta):
    """The cross forward kernel (rows against a different column set; its
    ETA instance at eta != 0) against its plain version in float64, 3,001
    rows against 2,003 columns, two frames."""
    from difficp_torch.ops import rhs_cross as RC

    args = _cross_inputs(2, 3001, 2003, d, seed=d, device=cuda)
    v, w, dc = RC.rhs_cross_fwd(*args, SIG, withlogdet, eta)
    torch.cuda.synchronize()
    rv, rw, rdc = RC.rhs_cross_fwd_reference(*(t.double() for t in args), SIG, withlogdet, eta)
    _close(v, rv, TOL_FWD)
    _close(w, rw, TOL_FWD)
    assert float((dc.double().sum(-1) - rdc.sum(-1)).abs().max()) <= TOL_FWD * float(
        rdc.abs().sum(-1).max())
    assert bool((v[args[2] == 0] == 0).all())


def test_cross_entry_keeps_the_self_outputs(cuda):
    """The cross entry with a set as its own columns gives the self entry's
    outputs bit for bit, at eta = 0 and at eta != 0; the ETA instance at eta
    = 0 gives the eta = 0 kernel's within TOL_FWD (the table kernel sums in
    another order); one count per launch, by instance."""
    from difficp_torch.ops import rhs_cross as RC

    q, p, m, qc, pc, mc = _cross_inputs(2, 2000, 1500, 2, seed=4, device=cuda)
    for counts in (RS.launches, RC.launches):
        for key in counts:
            counts[key] = 0
    for wl in (True, False):
        for eta, use_eta in ((0.0, False), (ETA, True)):
            a = RS.launch_fwd(q, p, m, SIG, wl, eta, use_eta)
            b = RC.launch_fwd(q, p, m, q, p, m, SIG, wl, eta, use_eta)
            for x, y in zip(a, b):
                assert torch.equal(x, y)
        c = RC.launch_fwd(q, p, m, qc, pc, mc, SIG, wl, 0.0, False)
        e = RC.launch_fwd(q, p, m, qc, pc, mc, SIG, wl, 0.0, True)
        for x, y in zip(c[:2], e[:2]):
            _close(y, x, TOL_FWD)
    assert RC.launches == {"rhs_cross_fwd": 4, "rhs_cross_fwd_eta": 4}
    assert RS.launches == {"rhs_self_fwd": 2, "rhs_self_bwd": 0, "rhs_self_fwd_eta": 2}


def test_cross_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from difficp_torch.ops import rhs_cross as RC

    q, p, m, qc, pc, mc = _cross_inputs(1, 64, 48, 2, seed=2, device=cuda)
    with pytest.raises(ValueError):
        RC.rhs_cross_fwd(q, p, m, qc.double(), pc, mc, SIG, True)
    with pytest.raises(ValueError):
        RC.rhs_cross_fwd(q, p, m, qc, pc, mc[..., :-1], SIG, True)
    with pytest.raises(ValueError):
        RC.rhs_cross_fwd(q, p, m, qc.cpu(), pc.cpu(), mc.cpu(), SIG, True)
    with pytest.raises(ValueError):
        RC.rhs_cross_fwd(q, p, m, qc[..., :1].contiguous(), pc[..., :1].contiguous(), mc,
                         SIG, True)


@pytest.mark.parametrize("eta", [0.0, ETA])
def test_ring_loss_on_card_matches_cpu_and_counts_launches(cuda, eta):
    """The sharded registration loss and its gradient at a world of one over
    NCCL on the card against the same loss on the CPU (the plain versions)
    in float64, 600 points, nt = 3; per loss+grad nt cross forwards and
    2 nt + 3 kernel-sums (the generated backward's two directions per step,
    the Hamiltonian's value and its two gradient directions)."""
    import torch.distributed as dist

    from difficp_torch.ops import ksum as KS
    from difficp_torch.ops import rhs_cross as RC
    from difficp_torch.parallel import init_distributed, make_sharded_reg_loss

    q0, a0, mask, y, *_ = _inputs(1, 600, 2, seed=6, device=cuda)
    q0, a0, mask, y = q0[0], 0.05 * a0[0] * mask[0, :, None], mask[0], q0[0] + 0.05 * y[0]
    w = torch.linspace(0.2, 1.0, 600, device=cuda)
    cfg = lddmm.make_config(sigma=SIG, lambd=200.0, version="logdet" if eta else "hybrid",
                            nt=3, scheme="Euler")
    group, size, _ = init_distributed("cuda")
    try:
        assert size == 1 and dist.get_backend(group) == "nccl"
        res = {}
        for dev, grp in ((cuda, group), (torch.device("cpu"), None)):
            args = [t.to(dev) if dev.type == "cuda" else t.cpu().double()
                    for t in (a0, q0, y, w, mask)]
            a = args[0].clone().requires_grad_(True)
            for counts in (RC.launches, KS.launches):
                for key in counts:
                    counts[key] = 0
            loss = make_sharded_reg_loss(cfg, grp)(a, *args[1:], 0.01)
            res[dev.type] = (loss.detach(), torch.autograd.grad(loss, a)[0])
            if dev.type == "cuda":
                launches = {**RC.launches, **KS.launches}
    finally:
        dist.destroy_process_group()
    _close(res["cuda"][0], res["cpu"][0], TOL_BWD)
    _close(res["cuda"][1], res["cpu"][1], 1e-3)
    name = "rhs_cross_fwd_eta" if eta else "rhs_cross_fwd"
    assert launches == {"rhs_cross_fwd": 0, "rhs_cross_fwd_eta": 0, name: 3, "ksum": 2 * 3 + 3}


# ---------------------------------------------------------------------------
# the direct forward kernels (csrc/direct.cuh): the any-eta self/cross
# forward and the ext forward, their column axis cut into chunks
# ---------------------------------------------------------------------------

DIRECT_CASES = [
    # kernel, frames, rows, columns, d, eta, sigma: what the shape covers
    ("self", 1, 3001, 3001, 2, ETA, SIG),        # rows not a multiple of the block's 64
    ("self", 2, 8193, 8193, 3, ETA, SIG),        # chunks, the last ragged; d = 3
    ("cross", 2, 1000, 70001, 3, ETA, SIG),      # columns not a multiple of a chunk
    ("cross", 3, 1, 5003, 2, ETA, SIG),          # one-row frames, an all-masked frame
    ("ext", 2, 3001, 301, 2, 0.0, SIG),          # rows not a multiple of the block's 128
    ("ext", 3, 700, 40001, 3, 0.0, SIG),         # chunks, ragged columns
    ("ext_eta", 3, 1, 5003, 3, ETA, SIG),        # one-row frames, an all-masked frame
    ("ext_eta", 10, 380, 65536, 2, 1 / 500, 0.05),  # v_field's shape, in chunks
]


def _direct_case(kernel, b, m, n, d, eta, sig, device):
    """Inputs of one direct forward case (a box cloud of rows against
    another of columns, ragged masks; with three frames or more, frame 1's
    columns all masked and frame 2's rows), and (call, reference, counter)."""
    from difficp_torch.ops import rhs_cross as RC
    from difficp_torch.ops import rhs_ext as RE

    rng = np.random.default_rng(m + n + d)
    q = rng.uniform(size=(b, m, d))
    p = 0.05 * rng.normal(size=(b, m, d))
    mr = (rng.uniform(size=(b, m)) > 0.1).astype(np.float64)
    qc = rng.uniform(-0.05, 1.05, size=(b, n, d))
    pc = 0.05 * rng.normal(size=(b, n, d))
    mc = (rng.uniform(size=(b, n)) > 0.1).astype(np.float64)
    if kernel == "ext_eta" and n == 65536:
        mr[:] = 1.0  # v_field's all-ones data mask
    if b >= 3:
        mc[1] = 0.0
        mr[2] = 0.0
    if m == 1:
        mr[0] = 1.0
    t = [torch.tensor(a, dtype=torch.float32, device=device) for a in (q, p, mr, qc, pc, mc)]
    q, p, mr, qc, pc, mc = t
    wl = not (kernel == "ext_eta" and n == 65536)  # v_field: logdet off
    if kernel == "self":
        return (lambda: RS.rhs_self_fwd(q, p, mr, sig, wl, eta),
                lambda: RS.rhs_self_fwd_reference(q.double(), p.double(), mr.double(), sig,
                                                  wl, eta),
                (RS.launches, "rhs_self_fwd_eta"))
    if kernel == "cross":
        return (lambda: RC.rhs_cross_fwd(q, p, mr, qc, pc, mc, sig, wl, eta),
                lambda: RC.rhs_cross_fwd_reference(*(a.double() for a in t), sig, wl, eta),
                (RC.launches, "rhs_cross_fwd_eta"))
    # ext: the rows are data points (x = q, mx = mr), the columns the support
    return (lambda: RE.rhs_ext_fwd(q, mr, qc, pc, mc, sig, wl, eta),
            lambda: RE.rhs_ext_fwd_reference(q.double(), mr.double(), qc.double(),
                                             pc.double(), mc.double(), sig, wl, eta),
            (RE.launches, "rhs_ext_fwd_eta" if eta else "rhs_ext_fwd"))


@pytest.mark.parametrize("case", DIRECT_CASES, ids=lambda c: "-".join(map(str, c[:5])))
def test_direct_forwards_match_plain_at_ragged_shapes(cuda, case):
    """The redesigned direct forwards (the any-eta self and cross forward,
    the ext forward of either kind) against their plain versions in float64
    on the same float32 inputs: each output within TOL_FWD of its largest
    plain value, each frame's dcost within TOL_FWD of the sum of its terms'
    magnitudes; a frame of masked rows, and one of masked columns, zero; a
    second call equal bit for bit; the kernel's launch counter one up a
    call."""
    call, reference, (counts, name) = _direct_case(*case, cuda)
    before = counts[name]
    got = call()
    again = call()
    torch.cuda.synchronize()
    assert counts[name] == before + 2
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    ref = reference()
    for x, r in zip(got[:-1], ref[:-1]):
        _close(x, r, TOL_FWD)
    dc, rdc = got[-1].double(), ref[-1]
    assert float((dc.sum(-1) - rdc.sum(-1)).abs().max()) <= TOL_FWD * float(
        rdc.abs().sum(-1).max()) + 1e-30
    if got[0].shape[0] >= 3:
        # frame 1's columns all masked, frame 2's rows
        assert bool((got[0][1] == 0).all()) and bool((got[0][2] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("version", ["rigid", "similarity", "general_affine", "translation"])
@pytest.mark.parametrize("withlogdet", [False, True])
def test_affine_fits_on_card_match_cpu(cuda, version, withlogdet, dtype):
    """The closed-form affine fits of 10 frames of 65,536 points in one
    batched call on the card (cuBLAS sums, cuSOLVER d x d factorizations)
    against the same call on the CPU.  In float64 M and t within 1e-5; in
    float32 M within 1e-4 of its largest |entry| and t = ym - M xm, a
    difference of coordinates, within 1e-4 of the largest |coordinate|,
    against the CPU's float32 fit and its float64 fit.  On the CPU the
    float32 fits of these frames stay within 1e-5 of those scales of the
    float64 fit and of the fit of the points in another order
    (tests/test_torch_affine.py::test_float32_fits_of_large_frames); on an
    H100 the float32 fits were ~2e-5 from the CPU's, above a 1e-5 bound
    (cuBLAS's float32 sums over 65,536 points, ~sqrt(N) 2^-24 = 1.5e-5
    relative each).  The logdet term -sum(w) log|det M| within that bound
    times sum(w)."""
    from difficp_torch.models import affine

    g = torch.Generator().manual_seed(0)
    x = torch.rand((10, 65536, 2), generator=g, dtype=torch.float64)
    th = 0.3 * torch.rand((10,), generator=g, dtype=torch.float64)
    rot = torch.stack([torch.stack([th.cos(), -th.sin()], -1),
                       torch.stack([th.sin(), th.cos()], -1)], -2)
    y = 1.1 * x @ rot.transpose(-1, -2) + 0.01 * torch.randn(x.shape, generator=g,
                                                              dtype=torch.float64)
    z = torch.rand((10, 65536), generator=g, dtype=torch.float64)
    mask = (torch.rand((10, 65536), generator=g, dtype=torch.float64) > 0.1).to(torch.float64)
    x, y, z, mask = (t.to(dtype) for t in (x, y, z, mask))
    cfg = affine.AffineConfig(version=version, withlogdet=withlogdet)
    cpu = affine.optimize(cfg, x, y, z, z, mask)
    card = affine.optimize(cfg, *(t.to(cuda) for t in (x, y, z, z, mask)))
    tol = 1e-5 if dtype == torch.float64 else 1e-4
    scales = (1.0, 1.0) if dtype == torch.float64 else (float(cpu.m.abs().max()),
                                                         float(y.abs().max()))
    for a, b, scale in ((card.m, cpu.m, scales[0]), (card.t, cpu.t, scales[1])):
        assert float((a.cpu() - b).abs().max()) <= tol * scale
    if dtype == torch.float32:
        exact = affine.optimize(cfg, *(t.double() for t in (x, y, z, z, mask)))
        for a, b, scale in ((card.m, exact.m, scales[0]), (card.t, exact.t, scales[1])):
            assert float((a.cpu().double() - b).abs().max()) <= tol * scale
    assert float((card.regl.cpu() - cpu.regl).abs().max()) <= tol * float((z * mask).sum(-1).max())


def test_gmm_fit_on_card_matches_cpu(cuda):
    """gmm.fit on the card from the same start indices as on the CPU (30
    float32 EM steps over 65,536 points): centroids and sigma within 1e-4
    relative; a start drawn from a CUDA generator."""
    from difficp_torch.models import gmm

    x = torch.rand((65536, 2), generator=torch.Generator().manual_seed(1))
    idx = torch.arange(0, 65536, 3277)
    cpu, _ = gmm.fit(x, 20, idx=idx, optimize_w=True, max_iterations=30, tol=0.0)
    card, _ = gmm.fit(x.to(cuda), 20, idx=idx, optimize_w=True, max_iterations=30, tol=0.0)
    assert torch.allclose(card.mu.cpu(), cpu.mu, rtol=1e-4, atol=2e-5)
    assert torch.allclose(card.sigma.cpu(), cpu.sigma, rtol=1e-4)
    drawn, _ = gmm.fit(x.to(cuda), 20, torch.Generator(device=cuda).manual_seed(0))
    assert drawn.mu.is_cuda and bool(torch.isfinite(drawn.mu).all())


def test_random_p_rff_cg_above_the_pair_limit(cuda):
    """random_p "ridge" at 8,192 masked points (67M pairs) re-routes to
    rff_cg: its CG matvec is the self forward kernel; the momenta solve
    (K + alpha I) p sqrt(lambda) = u within the CG tolerance, masked rows
    zero."""
    from difficp_torch.ops import solvers

    m = 8192
    q = torch.rand((1, m, 2), generator=torch.Generator().manual_seed(2)).to(cuda)
    mask = torch.ones((1, m), device=cuda)
    mask[:, -100:] = 0.0
    cfg = lddmm.make_config(sigma=0.1, lambd=100.0, version="classic", nt=10)
    rhs = {}
    solve = solvers.kridge_solve_cg

    def recording(q_, u, *a, **k):
        rhs["u"] = u
        return solve(q_, u, *a, **k)

    before = RS.launches["rhs_self_fwd"]
    lddmm.kridge_solve_cg = recording
    try:
        with pytest.warns(UserWarning, match="rff_cg"):
            p = lddmm.random_p(cfg, q, torch.Generator(device=cuda).manual_seed(3),
                               version="ridge", alpha=10.0, qmask=mask)
    finally:
        lddmm.kridge_solve_cg = solve
    assert RS.launches["rhs_self_fwd"] > before
    assert bool(torch.isfinite(p).all()) and bool((p[:, -100:] == 0).all())
    b = p * cfg.lambd ** 0.5
    kb = backend.kred(q, q, b, cfg.sigma, mask) * mask[..., None] + 10.0 * b
    u = rhs["u"]
    assert float((kb - u).norm() / u.norm()) <= 1e-5


@pytest.mark.parametrize("case", ["two_sets", "masked", "self", "scalar_weights"])
def test_kred_matches_plain(cuda, case):
    """KRed (ops/ksum.py: one ksum forward, one a direction backward) on the
    card against the same Function with ksum's plain version in float64 on
    the same float32 inputs: two frames, values within TOL_FWD, the gradients
    in x, y and b within TOL_BWD of their largest entry; for x is y the one
    tensor's dx + dy (the standard algorithm's <fy, fy>), and a scalar
    payload whose gradient is the template weights' (kred_scal)."""
    from difficp_torch.ops import ksum as KS

    rng = np.random.default_rng(41)
    x = rng.uniform(size=(2, 1001, 2))
    y = x if case in ("self", "scalar_weights") else rng.uniform(size=(2, 1503, 2))
    ncols = 1 if case == "scalar_weights" else 3
    b = rng.uniform(0.5, 1.5, size=(2, y.shape[1], ncols))
    my = (rng.uniform(size=(2, y.shape[1])) > 0.2).astype(np.float64) if case == "masked" else None
    cot = rng.normal(size=(2, 1001, ncols))

    def run(dtype, device):
        t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
        xs = t(x).requires_grad_(True)
        ys = xs if y is x else t(y).requires_grad_(True)
        bs = t(b).requires_grad_(True)
        out = KS.kred(xs, ys, bs, SIG, None if my is None else t(my))
        wrt = [xs, bs] if y is x else [xs, ys, bs]
        return [out.detach(), *torch.autograd.grad((out * t(cot)).sum(), wrt)]

    got = run(torch.float32, cuda)
    torch.cuda.synchronize()
    kernel = KS.ksum
    KS.ksum = KS.ksum_reference
    try:
        ref = run(torch.float64, cuda)
    finally:
        KS.ksum = kernel
    _close(got[0], ref[0], TOL_FWD)
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r, TOL_BWD)


@pytest.mark.parametrize("eta", [0.0, 0.4])
def test_blockwise_on_card_matches_cpu(cuda, eta):
    """The blockwise functions (ops/blockwise.py) on the card against the same
    functions on the CPU, two frames of 1,500 x 700 points in tiles of 256:
    the ext RHS's values within TOL_FWD and its gradients within TOL_BWD of
    their largest entry; the minima bit for bit."""
    from difficp_torch.ops import blockwise as BW

    rng = np.random.default_rng(51)
    q, p = rng.uniform(size=(2, 1500, 2)), 0.05 * rng.normal(size=(2, 1500, 2))
    x = rng.uniform(size=(2, 700, 2))
    mq = (rng.uniform(size=(2, 1500)) > 0.1).astype(np.float64)
    cot = [rng.normal(size=s) for s in ((2, 1500, 2), (2, 1500, 2), (2,), (2, 700, 2))]

    def run(device):
        t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
        qs, ps, xs = (t(a).requires_grad_(True) for a in (q, p, x))
        outs = BW.lddmm_rhs_ext(qs, ps, xs, SIG, eta, True, t(mq), None, tile=256)
        loss = sum((o * t(c)).sum() for o, c in zip(outs, cot))
        grads = torch.autograd.grad(loss, (qs, ps, xs))
        mins = [BW.min_sqdist(xs.detach(), qs.detach(), t(mq), tile=256),
                BW.second_min_sqdist(qs.detach(), t(mq), tile=256)]
        return [o.detach() for o in outs], list(grads), mins

    got, ref = run(cuda), run("cpu")
    for a, b in zip(got[0], ref[0]):
        _close(a, b, TOL_FWD)
    for a, b in zip(got[1], ref[1]):
        _close(a, b, TOL_BWD)
    for a, b in zip(got[2], ref[2]):
        _close(a, b, 1e-6)


def test_offload_two_chunks_on_card(cuda):
    """HostOffloadAtlas on the card with its frames in pinned host memory, 4
    spiral frames of 3,000 points in two chunks of 2 on a grid: the free
    energy monotone and within 5e-3 of the same atlas on the CPU; the
    kernels launched; bytes counted both ways."""
    from difficp_torch.models import gmm
    from difficp_torch.models.offload import HostOffloadAtlas
    from difficp_torch.examples.run_large import spiral_cloud

    frames = [spiral_cloud(3000, np.random.default_rng(k)) for k in range(4)]
    mu0 = frames[0][np.random.default_rng(0).integers(0, 3000, 20)]
    lcfg = lddmm.make_config(sigma=0.05, lambd=500.0, version="hybrid", nt=5, scheme="Euler")
    fes = {}
    for device in ("cpu", cuda):
        if device != "cpu":
            backend.set_backend("kernel")
        try:
            for c in RS.launches:
                RS.launches[c] = 0
            state, cfg = gmm.create(mu0, device=device)
            atlas = HostOffloadAtlas(frames, state, cfg, lcfg, chunk_frames=2, device=device)
            atlas.set_support_scheme("grid", rho=1.0)
            fes[str(device)] = atlas.run(2, max_em=5, reg_nmax=2, reg_inner=5, reg_ls=8)
            assert atlas.fe_increase_events == 0
            assert atlas.bytes_h2d > 0 and atlas.bytes_d2h > 0
        finally:
            backend.set_backend(None)
    assert atlas.x0.is_pinned() and RS.launches["rhs_self_bwd"] > 0
    np.testing.assert_allclose(fes["cuda"], fes["cpu"], rtol=5e-3)


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A grid-support DiffPSR on the card saved and loaded into a fresh one:
    every tensor lands on the card, bit for bit, the FE is the saved one,
    and the loaded PSR continues without a free-energy increase."""
    from difficp_torch.models import gmm
    from difficp_torch.models.psr import DiffPSR
    from difficp_torch.examples.run_large import spiral_cloud
    from difficp_torch.utils.checkpoint import load_psr, save_psr

    frames = [spiral_cloud(2000, np.random.default_rng(k)) for k in range(3)]
    mu0 = frames[0][np.random.default_rng(0).integers(0, 2000, 20)]
    lcfg = lddmm.make_config(sigma=0.1, lambd=500.0, version="hybrid", nt=5, scheme="Euler")

    def fresh():
        state, cfg = gmm.create(mu0, device=cuda)
        psr = DiffPSR(frames, state, cfg, lcfg, device=cuda)
        psr.printstuff = False
        psr.set_support_scheme("grid", rho=1.0)
        return psr

    psr = fresh()
    psr.GMM_opt(max_iterations=5)
    psr.Reg_opt(nmax=1, inner=5, ls_steps=8)
    save_psr(str(tmp_path / "ckpt"), psr)
    back = load_psr(str(tmp_path / "ckpt"), fresh())
    assert back.FE == psr.FE
    for name in ("x1", "y", "ptw", "regloss", "quadloss", "a0", "q0", "qmask"):
        got = getattr(back, name)
        assert got.device.type == "cuda" and torch.equal(got, getattr(psr, name)), name
    for g, h in zip(back.gmm, psr.gmm):
        assert all(a.device.type == "cuda" and torch.equal(a, b) for a, b in zip(g, h))
    back.GMM_opt(max_iterations=5)
    back.Reg_opt(nmax=1, inner=5, ls_steps=8)
    assert back.fe_increase_events == 0 and back.FE <= psr.FE
