"""A run of each cell on the CPU at a small size with the timed path broken
underneath (the harness's look for a card skipped): ``correct`` comes out
false for each fault the cell can have, and where a fault names the number
it breaks, that number is over its limit.  A window of 0 s runs one whole
registration, and the check samples one of its outer iterations.  (The
exchange between chips is not a fault of these one-chip cells.)"""

import sys
import time

import pytest
import torch

from conftest import SEEDS, TINY
from perfbench.harness import manifest as man

sys.path.insert(0, str(man.BENCH))
import run  # noqa: E402

pytestmark = pytest.mark.usefixtures("pending_cells")


def _state_unchanged_em(mp):
    """GMM_opt's EM returns the GMM it was given."""
    from difficp_torch.models import gmm

    orig = gmm.em_optimization

    def em(state, x, mask, cfg, max_iterations=100, tol=1e-5, group=None):
        out = orig(state, x, mask, cfg, max_iterations=max_iterations, tol=tol, group=group)
        return out._replace(state=state)

    mp.setattr(gmm, "em_optimization", em)


def _state_unchanged_euler(mp):
    """Each Euler step returns the state it was given."""
    from difficp_torch.utils import integrators

    def step_free(ode_fn, state0, nt=10, scheme="Euler", deltat=1.0, save_traj=False):
        if save_traj:
            return state0, integrators.tree_map(
                lambda a: torch.stack([a] * (nt + 1), 0), state0)
        return state0, None

    mp.setattr("difficp_torch.models.lddmm.integrate", step_free)


def _half_the_points_in_em(mp):
    """The EM's M step sums over the first half of the points only: the
    means are taken over the rest."""
    from difficp_torch.models import gmm

    orig = gmm._m_stats

    def half(e, x, mask):
        keep = mask.clone()
        keep[keep.shape[0] // 2:] = 0
        return orig(e, x, keep)

    mp.setattr(gmm, "_m_stats", half)


def _registration_unchanged(mp):
    """The L-BFGS makes its evaluations and returns the momenta it was given,
    with their loss, gradient and arrival state: the registration's state
    stays unchanged and every number it reports agrees with it."""
    from difficp_torch.models import lddmm
    from difficp_torch.utils import lbfgs

    orig = lddmm.lbfgs_optimize

    def frozen(lossfn, p0, **kw):
        res = orig(lossfn, p0, **kw)
        if kw.get("value0") is not None:
            f0, aux0, g0 = kw["value0"], kw["aux0"], kw["grad0"]
        else:
            f0, aux0, g0 = lbfgs._value_and_grad(lossfn, p0.shape, True)(
                p0.reshape(p0.shape[0], -1))
        return res._replace(params=p0.detach(), loss=f0, aux=aux0, grad=g0.reshape(p0.shape))

    mp.setattr(lddmm, "lbfgs_optimize", frozen)


def _warped_points_altered(mp):
    """The shoot's arrival points are moved by 0.05, some 5% of the data's
    extent."""
    from difficp_torch.models import lddmm

    orig = lddmm.shoot

    def altered(*a, **kw):
        final, traj = orig(*a, **kw)
        moved = final._replace(q=final.q + 5e-2)
        if final.x is not None:
            moved = moved._replace(x=final.x + 5e-2)
        return moved, traj

    mp.setattr(lddmm, "shoot", altered)


def _gradient_altered(mp):
    """The gradient the registration returns is doubled."""
    from difficp_torch.models import lddmm

    orig = lddmm.optimize

    def altered(*a, **kw):
        res = orig(*a, **kw)
        return res._replace(grad=2.0 * res.grad)

    mp.setattr(lddmm, "optimize", altered)


def _support_shifted(mp):
    """Grid support one grid step off in x from the grid the data give."""
    from difficp_torch.models import psr

    orig = psr.grid_support

    def shifted(points, rcover, **kw):
        g = orig(points, rcover, **kw)
        g[:, 0] += rcover
        return g

    mp.setattr(psr, "grid_support", shifted)


# a grid of step 5 sigma_LDDMM leaves points farther than the coverage
# radius, 2 sigma, from every support point (a grid over the data's bounding
# box covers every frame wherever it lies, at a step under 2 sqrt(2) sigma)
COARSE_GRID = {"support": {"scheme": "grid", "rho": 5.0}}


def _coverage_zeros(mp):
    """The coverage pass reports no uncovered point, on a grid that leaves
    points uncovered."""
    from difficp_torch.ops import backend

    def none_uncovered(x, y, sigma, r_threshold, mask_x=None, mask_y=None):
        return torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)

    mp.setattr(backend, "check_coverage", none_uncovered)
    return COARSE_GRID


# the number each fault has to fail where one is named
TRIPS = {_support_shifted: "q0_diff", _coverage_zeros: "cover_diff",
         _registration_unchanged: "reg_stall"}
FAULTS = {
    "twoset_dense.n131k": [_state_unchanged_em, _state_unchanged_euler,
                           _registration_unchanged, _half_the_points_in_em,
                           _warped_points_altered, _gradient_altered],
    "atlas_grid.k40": [_state_unchanged_em, _state_unchanged_euler,
                       _registration_unchanged, _half_the_points_in_em,
                       _warped_points_altered, _gradient_altered,
                       _support_shifted, _coverage_zeros],
}
CASES = [(w, f) for w, fs in sorted(FAULTS.items()) for f in fs]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__.strip('_')}" for w, f in CASES])
def test_a_broken_path_is_not_correct(monkeypatch, workload, fault):
    config = dict(TINY[workload].get("config", {}), **(fault(monkeypatch) or {}))
    res = run.run(workload, SEEDS[workload], 0.0, False, "cpu", time.perf_counter(),
                  dict(TINY[workload], config=config))
    assert res["correct"] is False, res["checks"]
    if fault in TRIPS:
        c = res["checks"][TRIPS[fault]]
        assert not c["value"] <= c["limit"], res["checks"]


def test_the_coarse_grid_leaves_points_uncovered(monkeypatch):
    """The sound program on the coarse grid: points are uncovered, the counts
    agree with the reference's and the run is correct, so that the fault
    above is what fails."""
    from difficp_torch.ops import backend

    counts = []
    orig = backend.check_coverage

    def counted(*a, **kw):
        out = orig(*a, **kw)
        counts.append(int(out.sum()))
        return out

    monkeypatch.setattr(backend, "check_coverage", counted)
    w = "atlas_grid.k40"
    config = dict(TINY[w]["config"], **COARSE_GRID)
    res = run.run(w, SEEDS[w], 0.0, False, "cpu", time.perf_counter(),
                  dict(TINY[w], config=config))
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["cover_diff"]["value"] == 0 and min(counts) > 0
