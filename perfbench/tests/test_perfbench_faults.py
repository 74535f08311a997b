"""A run of each cell on the CPU at a small size with the timed path broken
underneath (the harness's look for a card skipped): ``correct`` comes out
false for each fault the cell can have.  A window of 0 s runs one whole
registration, and the check samples one of its outer iterations.  (The
exchange between chips is not a fault of these one-chip cells.)"""

import sys
import time

import pytest
import torch

from conftest import SEED, TINY
from perfbench.harness import manifest as man

sys.path.insert(0, str(man.BENCH))
import run  # noqa: E402


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


FAULTS = {
    "twoset_dense.n131k": [_state_unchanged_em, _state_unchanged_euler,
                           _registration_unchanged, _half_the_points_in_em,
                           _warped_points_altered, _gradient_altered],
}
CASES = [(w, f) for w, fs in sorted(FAULTS.items()) for f in fs]


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__.strip('_')}" for w, f in CASES])
def test_a_broken_path_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    res = run.run(workload, SEED, 0.0, False, "cpu", time.perf_counter(), TINY[workload])
    assert res["correct"] is False, res["checks"]
