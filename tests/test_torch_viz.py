"""The port's visualization layer against the JAX package's (mirrors
tests/test_viz.py on the Agg backend): the grid deformations and the GMM
responsibilities agree with the JAX package on the same inputs, every plot
function renders, and run_basic draws its figure."""

import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from difficp_tpu.models import gmm as jg  # noqa: E402
from difficp_tpu.models import lddmm as jl  # noqa: E402
from difficp_tpu.models.registration import LDDMMRegistration as JReg  # noqa: E402
from difficp_tpu.viz.grid import Gridlines as JGridlines  # noqa: E402
from difficp_torch.models import gmm as tg  # noqa: E402
from difficp_torch.models import lddmm as tl  # noqa: E402
from difficp_torch.models.psr import DiffPSR  # noqa: E402
from difficp_torch.models.registration import LDDMMRegistration as TReg  # noqa: E402
from difficp_torch.viz.grid import Gridlines  # noqa: E402
from difficp_torch.viz.visu import (  # noqa: E402
    get_bounds, my_scatter, plot_gmm, plot_gmm_clusters, plot_trajectories,
)

torch.set_num_threads(1)

rng = np.random.default_rng(0)
PTS = rng.normal(size=(60, 2)).astype(np.float32) * 0.4
P0 = (0.05 * rng.normal(size=(20, 2))).astype(np.float32)
LCFG = dict(sigma=0.3, lambd=100.0, version="classic", nt=4, scheme="Euler")


@pytest.fixture()
def gmm_state():
    state, _ = tg.create(PTS[:5], device="cpu")
    return state


def _handles():
    qmask = np.ones(20, np.float32)
    qmask[-3:] = 0.0
    treg = TReg(cfg=tl.make_config(**LCFG), q0=torch.as_tensor(PTS[:20]),
                a0=torch.as_tensor(P0), qmask=torch.as_tensor(qmask))
    jreg = JReg(cfg=jl.make_config(**LCFG), q0=jnp.asarray(PTS[:20]), a0=jnp.asarray(P0),
                qmask=jnp.asarray(qmask))
    return treg, jreg


def test_get_bounds_and_scatter():
    xmin, xmax, ymin, ymax = get_bounds(torch.as_tensor(PTS), relmargin=0.1)
    assert xmin < PTS[:, 0].min() and xmax > PTS[:, 0].max()
    assert ymin < PTS[:, 1].min() and ymax > PTS[:, 1].max()
    fig = plt.figure()
    my_scatter(torch.as_tensor(PTS), PTS[:10])
    plt.close(fig)
    fig = plt.figure().add_subplot(projection="3d").figure
    my_scatter(np.concatenate([PTS, PTS[:, :1]], axis=1))
    plt.close(fig)
    with pytest.raises(ValueError):
        my_scatter(np.zeros((3, 4)))


@pytest.mark.parametrize("backward", [False, True])
def test_gridlines_register_matches_jax(backward):
    treg, jreg = _handles()
    grid = Gridlines(np.linspace(-1, 1, 5), np.linspace(-1, 1, 5), points_per_line=10)
    jgrid = JGridlines(np.linspace(-1, 1, 5), np.linspace(-1, 1, 5), points_per_line=10)
    pts0 = grid.get_points()
    np.testing.assert_array_equal(pts0, jgrid.get_points())
    warped = grid.register(treg, backward=backward)
    pts1 = warped.get_points()
    assert pts1.shape == pts0.shape and len(warped.lines) == 10
    assert np.abs(pts1 - pts0).max() > 1e-4
    np.testing.assert_allclose(pts1, jgrid.register(jreg, backward=backward).get_points(),
                               atol=1e-5)
    ref = treg.backward(pts0) if backward else treg.apply(pts0)
    np.testing.assert_allclose(pts1, ref.numpy(), atol=1e-6)
    fig = plt.figure()
    warped.plot(color="k")
    plt.close(fig)


def test_gridlines_shoot_with_speeds_matches_jax():
    treg, jreg = _handles()
    grid = Gridlines(np.linspace(-1, 1, 4), np.linspace(-0.8, 0.8, 3), points_per_line=8)
    jgrid = JGridlines(np.linspace(-1, 1, 4), np.linspace(-0.8, 0.8, 3), points_per_line=8)
    grids, inters, speeds = grid.shoot(treg, require_v=True)
    jgrids, jinters, jspeeds = jgrid.shoot(jreg, require_v=True)
    assert len(grids) == len(inters) == len(speeds) == LCFG["nt"] + 1
    for a, b in zip(grids, jgrids):
        np.testing.assert_allclose(a.get_points(), b.get_points(), atol=1e-5)
    for a, b in zip(inters, jinters):
        assert a.shape == (12, 2)
        np.testing.assert_allclose(a, b, atol=1e-5)
    for a, b in zip(speeds, jspeeds):
        np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_allclose(grids[-1].get_points(), grid.register(treg).get_points(),
                               atol=1e-6)
    assert isinstance(grid.shoot(treg), list)


def test_log_responsibilities_matches_jax():
    state, _ = tg.create(PTS[:5], sigma=0.3, device="cpu")
    state = state._replace(w=torch.as_tensor(rng.normal(size=5).astype(np.float32)))
    jstate = jg.GMMState(*(jnp.asarray(f.numpy()) for f in state))
    got = tg.log_responsibilities(state, torch.as_tensor(PTS)).numpy()
    ref = np.asarray(jg.log_responsibilities(jstate, jnp.asarray(PTS)))
    assert got.shape == (60, 5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.exp(got).sum(1), 1.0, rtol=1e-5)


def test_plot_gmm_variants(gmm_state):
    treg, _ = _handles()
    for kw in (dict(heatmap=True), dict(heatmap=False),
               dict(registration=treg, heatmap_amplification=-0.5, res=40)):
        fig = plt.figure()
        plot_gmm(gmm_state, torch.as_tensor(PTS), **kw)
        plt.close(fig)
    fig = plt.figure()
    plot_gmm(gmm_state)
    plot_gmm_clusters(gmm_state, torch.as_tensor(PTS), PTS[:7])
    plt.close(fig)


def test_plot_trajectories_smoke():
    state, _ = tg.create(PTS[:5], device="cpu")
    gcfg = tg.GMMConfig(optimize_eta0=False)
    psr = DiffPSR([PTS[:30], PTS[30:]], state, gcfg, tl.make_config(**dict(LCFG, nt=3)),
                  device="cpu")
    psr.printstuff = False
    psr.GMM_opt(max_iterations=3)
    psr.Reg_opt(nmax=1, inner=3, ls_steps=6)
    for support in (False, True):
        fig = plt.figure()
        plot_trajectories(psr, k=1, support=support)
        # one line a point of the frame's padded width (dense support)
        assert len(plt.gca().lines) == psr.trajectories(k=1, support=support).shape[1] == 32
        plt.close(fig)


def test_run_basic_plot(tmp_path, monkeypatch):
    from difficp_torch.examples import run_basic

    monkeypatch.chdir(tmp_path)
    psr = run_basic.main(n_iter=2, plot=True, device="cpu")
    assert psr.fe_increase_events == 0
    out = tmp_path / "run_basic.png"
    assert out.exists() and out.stat().st_size > 10_000
    plt.close("all")
