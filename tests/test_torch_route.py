"""The route rule of ``difficp_torch/ops/backend.py``: a call takes the dense
route at or under ``DENSE_PAIR_LIMIT`` pairs of the whole call (its leading
frame or state dimensions times one frame's pairs) and the kernel route
above.  A call of one frame routes as the per-frame rule routed it; the
orders agree with the RHS they feed; and a grid-support ``DiffPSR`` whose
frames together pass the limit, one frame staying under it, gives the dense
route's loss, gradient, warped points and uncovered counts.  On the CPU,
where the kernel route runs the kernels' plain versions."""

import numpy as np
import pytest
import torch

from difficp_torch.models import gmm as gmm_mod
from difficp_torch.models import lddmm
from difficp_torch.models.psr import DiffPSR
from difficp_torch.ops import backend

torch.set_num_threads(1)

SIG = 0.3
LIMIT = 600


def _pts(lead, n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((*lead, n, 2), generator=g)


# function -> (call on a leading shape and sizes (a, b), one frame's pairs at
# (a, b) as the function counted them before the rule took the frames in)
CALLS = {
    "row_order": (lambda lead, a, b: backend.row_order(_pts(lead, a, 1), SIG, x=_pts(lead, b, 2)),
                  lambda a, b: a * (a + b)),
    "data_order": (lambda lead, a, b: backend.data_order(_pts(lead, b, 2), _pts(lead, a, 1), SIG),
                   lambda a, b: a * (a + b)),
    "lddmm_rhs_self": (lambda lead, a, b: backend.lddmm_rhs_self(
        _pts(lead, a, 1), 0.01 * _pts(lead, a, 3), SIG, 0.0, True),
        lambda a, b: a * a),
    "lddmm_rhs_ext": (lambda lead, a, b: backend.lddmm_rhs_ext(
        _pts(lead, a, 1), 0.01 * _pts(lead, a, 3), _pts(lead, b, 2), SIG, 0.0, True),
        lambda a, b: a * (a + b)),
    "hamiltonian": (lambda lead, a, b: backend.hamiltonian(
        _pts(lead, a, 1), 0.01 * _pts(lead, a, 3), SIG, 0.0),
        lambda a, b: a * a),
    "v_field": (lambda lead, a, b: backend.v_field(
        _pts(lead, b, 2), _pts(lead, a, 1), 0.01 * _pts(lead, a, 3), SIG, 0.0),
        lambda a, b: b * a),
    "grad_kred": (lambda lead, a, b: backend.grad_kred(_pts(lead, a, 1), _pts(lead, b, 2), SIG),
                  lambda a, b: a * b),
    "kred": (lambda lead, a, b: backend.kred(_pts(lead, a, 1), _pts(lead, b, 2),
                                             _pts(lead, b, 3), SIG),
             lambda a, b: a * b),
    "kred_scal": (lambda lead, a, b: backend.kred_scal(_pts(lead, a, 1), _pts(lead, b, 2),
                                                       _pts(lead, b, 3)[..., 0], SIG),
                  lambda a, b: a * b),
    "mdivsum": (lambda lead, a, b: backend.mdivsum(
        _pts(lead, b, 2), _pts(lead, a, 1), 0.01 * _pts(lead, a, 3), SIG, 0.0),
        lambda a, b: a * b),
    "min_sqdist": (lambda lead, a, b: backend.min_sqdist(_pts(lead, a, 1), _pts(lead, b, 2)),
                   lambda a, b: a * b),
    "second_min_sqdist": (lambda lead, a, b: backend.second_min_sqdist(_pts(lead, a, 1)),
                          lambda a, b: a * a),
    # through min_sqdist, which counts it
    "check_coverage": (lambda lead, a, b: backend.check_coverage(
        _pts(lead, a, 1), _pts(lead, b, 2), SIG, 2.0),
        lambda a, b: a * b),
}
COUNTED_AS = {"check_coverage": "min_sqdist"}


def _routes(fn, lead, a, b):
    backend.routes.clear()
    CALLS[fn][0](lead, a, b)
    got = {route for (f, route), n in backend.routes.items()
           if f == COUNTED_AS.get(fn, fn) and n}
    assert len(got) == 1, (fn, dict(backend.routes))
    return got.pop()


@pytest.fixture
def limit(monkeypatch):
    monkeypatch.setattr(backend, "DENSE_PAIR_LIMIT", LIMIT)
    backend.set_backend(None)
    yield LIMIT
    backend.routes.clear()


@pytest.mark.parametrize("lead", [(), (1,)], ids=["no_frame_axis", "one_frame"])
@pytest.mark.parametrize("fn", sorted(CALLS))
def test_one_frame_routes_as_the_per_frame_rule(limit, fn, lead):
    """Sizes on both sides of the limit, and at it: dense exactly where one
    frame's pairs are at most the limit."""
    seen = set()
    for a, b in ((4, 6), (12, 20), (20, 10), (24, 25), (40, 30), (10, 60)):
        want = "dense" if CALLS[fn][1](a, b) <= limit else "kernel"
        assert _routes(fn, lead, a, b) == want, (fn, a, b)
        seen.add(want)
    assert seen == {"dense", "kernel"}


@pytest.mark.parametrize("fn", sorted(CALLS))
def test_frames_together_over_the_limit_take_the_kernel_route(limit, fn):
    """One frame under the limit: three frames (or 2 states x 3 frames) whose
    pairs together pass it take the kernel route, and three whose pairs stay
    under it the dense route."""
    small, big = (4, 6), (16, 14)
    for a, b in (small, big):
        assert CALLS[fn][1](a, b) <= limit
    for lead in ((3,), (2, 3)):
        frames = int(np.prod(lead))
        assert frames * CALLS[fn][1](*small) <= limit < frames * CALLS[fn][1](*big)
        assert _routes(fn, lead, *small) == "dense"
        assert _routes(fn, lead, *big) == "kernel"


@pytest.mark.parametrize("lead", [(1,), (3,), (5,)])
def test_orders_agree_with_the_rhs_they_feed(limit, lead):
    """row_order (with and without external points) and data_order give an
    order exactly where the RHS at the same points takes the kernel route."""
    for a, b in ((4, 6), (8, 10), (12, 20), (20, 10), (30, 5)):
        q, x = _pts(lead, a, 1), _pts(lead, b, 2)
        p = 0.01 * _pts(lead, a, 3)
        backend.routes.clear()
        backend.lddmm_rhs_ext(q, p, x, SIG, 0.0, True)
        ext = backend.routes[("lddmm_rhs_ext", "kernel")] == 1
        assert (backend.row_order(q, SIG, x=x) is not None) == ext
        assert (backend.data_order(x, q, SIG) is not None) == ext
        backend.routes.clear()
        backend.lddmm_rhs_self(q, p, SIG, 0.0, True)
        self_ = backend.routes[("lddmm_rhs_self", "kernel")] == 1
        assert (backend.row_order(q, SIG) is not None) == self_


def test_forced_routes_are_counted(limit):
    try:
        for mode in ("dense", "kernel", "blockwise"):
            backend.set_backend(mode)
            assert _routes("lddmm_rhs_ext", (3,), 4, 6) == mode
    finally:
        backend.set_backend(None)


# ---------------------------------------------------------------------------
# a grid-support DiffPSR at 3 frames x 500 points, sigma_LDDMM 0.2
# ---------------------------------------------------------------------------

FRAMES, POINTS = 3, 500


def _frames():
    from difficp_torch.examples.run_large import spiral_cloud, warp

    rng = np.random.default_rng([0])
    frames = []
    for i in range(FRAMES):
        x = spiral_cloud(POINTS, rng)
        frames.append(warp(x, 2) if i % 2 else x)
    return frames, frames[0][rng.integers(0, POINTS, 20)]


def _run_psr():
    """GMM_opt, then Reg_opt (2 steps of 3) from the start: the free energy,
    the gradient at the new momenta, the warped points, the uncovered
    counts, and the routes taken."""
    frames, mu0 = _frames()
    state, _ = gmm_mod.create(mu0, sigma=None, device="cpu")
    lcfg = lddmm.make_config(sigma=0.2, lambd=500.0, version="hybrid", nt=10, scheme="Euler")
    backend.routes.clear()
    psr = DiffPSR(frames, state, gmm_mod.GMMConfig(), lcfg, device="cpu")
    psr.printstuff = False
    psr.set_support_scheme("grid", rho=1.0)
    psr.GMM_opt(max_iterations=5, tol=1e-3)
    psr.Reg_opt(tol=1e-3, nmax=2, inner=3, ls_steps=8)
    return {"support": psr.q0.shape[-2], "fe": psr.FE, "grad": psr._reg_vg[0],
            "x1": psr.x1, "uncovered": psr.last_reg_stats["uncovered"],
            "routes": dict(backend.routes)}


@pytest.fixture(scope="module")
def psr_routes():
    mp = pytest.MonkeyPatch()
    backend.set_backend(None)
    try:
        dense = _run_psr()
        m = dense["support"]
        one_frame = m * (m + POINTS)
        # between one frame's RHS pairs and three frames'
        mp.setattr(backend, "DENSE_PAIR_LIMIT", 2 * one_frame)
        kernel = _run_psr()
    finally:
        mp.undo()
        backend.routes.clear()
    return dense, kernel


def test_the_grid_case_routes_on_the_frames_together(psr_routes):
    dense, kernel = psr_routes
    assert dense["support"] == 36
    assert all(route == "dense" for _, route in dense["routes"])
    for fn in ("lddmm_rhs_ext", "row_order", "data_order", "min_sqdist", "v_field"):
        assert kernel["routes"].get((fn, "kernel"), 0) > 0, fn
        assert kernel["routes"].get((fn, "dense"), 0) == 0, fn
    # the support's own Hamiltonian, 3 x 36^2 pairs, stays dense
    assert kernel["routes"].get(("hamiltonian", "kernel"), 0) == 0
    assert kernel["routes"][("hamiltonian", "dense")] > 0


def test_the_grid_case_agrees_with_the_dense_route(psr_routes):
    """float32 sums in another order: the free energy to 1e-5 relative, the
    gradient to 1e-3 of its largest entry, the warped points to 1e-5 of the
    data's extent (1), the uncovered counts exactly."""
    dense, kernel = psr_routes
    assert kernel["fe"] == pytest.approx(dense["fe"], rel=1e-5)
    g, gd = kernel["grad"], dense["grad"]
    assert float((g - gd).abs().max()) <= 1e-3 * float(gd.abs().max())
    assert float((kernel["x1"] - dense["x1"]).abs().max()) <= 1e-5
    assert torch.equal(kernel["uncovered"], dense["uncovered"])
