"""The grid-support reference (``reference/ext.py``) against the port's plain
route, and the dense reference's numbers held to those it gave before grid
support came in.  On the CPU, at 3 frames of 500 points, sigma_LDDMM 0.2."""

import json

import numpy as np
import pytest
import torch

from perfbench.harness import manifest as man
from perfbench.harness import traffic
from perfbench.reference import check as rc
from perfbench.reference import ext as rext

ATLAS = json.loads((man.BENCH / "configs" / "atlas_grid.json").read_text())
MIX = dict(json.loads((man.BENCH / "traffic" / "k40.json").read_text()), frames=3, points=500)


@pytest.fixture(scope="module")
def case():
    """Frames, their grid support, momenta that move the data by some 5% of
    their extent, GMM targets and weights, all from fixed seeds."""
    frames, _, _ = traffic.draw(MIX, "frame0", 20)
    x0 = np.stack(frames)
    q0, qm = rext.support(ATLAS, x0)
    rng = np.random.default_rng(31)
    p0 = (0.02 * rng.normal(size=q0.shape)).astype(np.float32)
    y = x0 + 0.01 * rng.normal(size=x0.shape)
    wts = rng.uniform(0.5, 1.0, size=x0.shape[:2])
    return {"x0": x0, "q0": q0, "qm": qm, "p0": p0, "y": y, "wts": wts,
            "xm": np.ones(x0.shape[:2], np.float32), "sig2": 0.01}


def _port(case, dtype):
    """The port's loss, gradient, warped data and trajectory (its dense
    route at this size) in ``dtype``."""
    from difficp_torch.models import lddmm

    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    lc = ATLAS["lddmm"]
    cfg = lddmm.make_config(sigma=lc["sigma"], lambd=lc["lambd"], version=lc["version"],
                            nt=lc["nt"], scheme=lc["scheme"])
    q0, qm, x0, xm = t(case["q0"]), t(case["qm"]), t(case["x0"]), t(case["xm"])
    p = t(case["p0"]).requires_grad_(True)
    final, _ = lddmm.shoot(cfg, q0, p, x0, qm, xm)
    trajl = lddmm.trajloss(cfg, q0, p, final.cost, qm)
    datal = (t(case["wts"])[..., None] * (final.x - t(case["y"])) ** 2).sum((1, 2)) \
        / (2.0 * case["sig2"])
    (g,) = torch.autograd.grad((trajl + datal).sum(), p)
    with torch.no_grad():
        _, traj = lddmm.shoot(cfg, q0, p, x0, qm, xm, save_traj=True)
    return trajl + datal, g, final.x, traj


def _reference(case, keep=False):
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
    p = t(case["p0"]).requires_grad_(True)
    trajl, datal, x1, states = rext.loss(ATLAS["lddmm"], t(case["q0"]), p, t(case["qm"]),
                                         t(case["x0"]), t(case["xm"]), t(case["y"]),
                                         t(case["wts"]), case["sig2"], "float64", keep)
    (g,) = torch.autograd.grad((trajl + datal).sum(), p)
    return trajl + datal, g, x1, states


def test_the_grid_is_the_ports():
    from difficp_torch.utils.point_sets import grid_support

    frames, _, _ = traffic.draw(MIX, "frame0", 20)
    x0 = np.stack(frames)
    rc_ = float(ATLAS["support"]["rho"]) * float(ATLAS["lddmm"]["sigma"])
    want = grid_support(x0.reshape(-1, 2), rc_)
    q0, qm = rext.support(ATLAS, x0)
    assert q0.dtype == np.float32 and q0.shape == (3,) + want.shape
    assert all(np.array_equal(q, want) for q in q0) and qm.min() == 1
    assert want.shape[0] == 36


def test_the_reference_is_the_ports_plain_route_in_float64(case):
    f_p, g_p, x1_p, traj = _port(case, torch.float64)
    f_r, g_r, x1_r, states = _reference(case, keep=True)
    torch.testing.assert_close(f_r, f_p.detach(), rtol=1e-10, atol=0)
    torch.testing.assert_close(g_r, g_p, rtol=1e-10, atol=1e-14 * float(g_p.abs().max()))
    torch.testing.assert_close(x1_r.detach(), x1_p.detach(), rtol=1e-10, atol=0)
    # the coverage pass's distances over the whole trajectory
    from difficp_torch.ops import reductions

    d2_p = reductions.min_sqdist(traj.x, traj.q, torch.as_tensor(case["qm"], dtype=torch.float64))
    d2_r = rext.min_sqdist(states, torch.as_tensor(case["qm"], dtype=torch.float64))
    torch.testing.assert_close(d2_r, d2_p, rtol=1e-10, atol=0)
    assert float((x1_r.detach() - torch.as_tensor(case["x0"])).abs().max()) > 0.01


def test_the_ports_float32_distances_lie_inside_the_band(case):
    """The program's coverage distances (float32 states and sums) against
    the float64 trajectory's, relative to the threshold or to the distance
    where that is larger: inside a quarter of the band that ``cover_band``
    derives from the reference's float32 witness."""
    from difficp_torch.ops import reductions

    qm = torch.as_tensor(case["qm"], dtype=torch.float64)
    _, _, _, traj = _port(case, torch.float32)
    _, _, _, states = _reference(case, keep=True)
    d2_32 = reductions.min_sqdist(traj.x, traj.q, qm.float()).double()
    d2_64 = rext.min_sqdist(states, qm)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    *_, witness = rext.shoot(ATLAS["lddmm"], f32(case["q0"]), f32(case["p0"]), f32(case["qm"]),
                             f32(case["x0"]), f32(case["xm"]), "float32", keep=True)
    band = rext.cover_band(ATLAS["lddmm"], d2_64, rext.min_sqdist(witness, qm.float()))
    thr = rext.cover_threshold(ATLAS["lddmm"])
    assert 1e-7 < band < 1e-4
    assert float(((d2_32 - d2_64).abs() / d2_64.clamp_min(thr)).max()) < band / 4


def test_the_counts_allow_the_band_and_nothing_more():
    cfg = ATLAS["lddmm"]
    thr = rext.cover_threshold(cfg)
    d2 = torch.tensor([[[thr * (1 - 2e-5), thr * (1 + 2e-5), thr * 0.5, thr * 2.0]]],
                      dtype=torch.float64)
    xm = torch.ones(1, 4, dtype=torch.float64)
    sure, maybe = rext.cover_counts(cfg, d2, xm, 1e-4)
    assert sure.tolist() == [[1]] and maybe.tolist() == [[3]]
    ref = {"cover": (sure, maybe)}
    assert [rc.cover_diff(np.array([[c]]), ref) for c in range(5)] == [1, 0, 0, 0, 1]
    assert rc.cover_diff(None, ref) == float("inf")
    assert rc.cover_diff(np.zeros((2, 1)), ref) == float("inf")


# the dense reference's numbers on ``_dense_snapshot`` as the reference gave
# them before it took grid support (the same code path, bit for bit)
DENSE_PROGRAM = {"em_err": 1.9030192243693287, "fe_err": 0.5930114696446824,
                 "x1_err": 0.030951975004809392, "grad_err": 0.9999133093828393,
                 "reg_stall": 792.8733993658461, "q0_diff": 0.0}
DENSE_CONTROL = {"em_err": 0.0007291291725256332, "fe_err": 0.0185898952826609,
                 "x1_err": 3.382353556024098e-06, "grad_err": 0.004763663502160761,
                 "reg_stall": 792.8733993658461, "q0_diff": 0.0}


def _dense_snapshot():
    """A sampled iteration of the two-set at 300 points, made from a fixed
    seed without the program, so that the reference's numbers on it depend
    only on the reference's code."""
    config = json.loads((man.BENCH / "configs" / "twoset_dense.json").read_text())
    mix = dict(json.loads((man.BENCH / "traffic" / "n131k.json").read_text()), points=300)
    rng = np.random.default_rng(20260418)
    drawn = traffic.draw(mix, config["gmm"]["init_from"], config["gmm"]["C"])
    frames, _, mu0 = traffic.permute(drawn, 2 ** 31 + 7, 1)
    x0 = np.stack(frames)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    gmm = lambda s: {"mu": f32(mu0 + s * rng.normal(size=mu0.shape)),  # noqa: E731
                     "w": f32(s * rng.normal(size=mu0.shape[0])), "sigma": 0.05 + s}
    a0b = f32(1e-3 * rng.normal(size=x0.shape))
    snap = {"inputs": {"cohort": 1, "frames": frames, "x0": x0,
                       "xmask": np.ones(x0.shape[:2], np.float32), "mu0": mu0},
            "it": 1, "em": True, "gmm_before": gmm(1e-3), "gmm_after": gmm(2e-3),
            "x1_before": f32(x0 + 1e-3 * rng.normal(size=x0.shape)), "a0_before": a0b,
            "a0_after": f32(a0b + 1e-3 * rng.normal(size=x0.shape)), "fe_mid": -1234.5,
            "fe": -1240.25, "x1_after": f32(x0 + 2e-3 * rng.normal(size=x0.shape)),
            "grad": f32(rng.normal(size=x0.shape)), "q0": x0}
    lo, hi = x0.reshape(-1, 2).min(0), x0.reshape(-1, 2).max(0)
    prob = {"config": config, "drawn": drawn, "seed": 2 ** 31 + 7,
            "extent": float((hi - lo).max())}
    return prob, dict(snap, extent=prob["extent"])


def test_the_dense_numbers_are_as_before():
    prob, snap = _dense_snapshot()
    ref = rc.outputs(prob, snap, "float64", "cpu")
    assert rc.numbers(rc.program_outputs(snap), ref, prob["extent"]) == DENSE_PROGRAM
    ctl = rc.outputs(prob, snap, "tf32", "cpu")
    assert rc.numbers(rc.control_outputs(ctl), ref, prob["extent"]) == DENSE_CONTROL
