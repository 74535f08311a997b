"""Affine registration in the port against the JAX package: the closed-form
fits (all 8 version x logdet cases, also against the torch-reference goldens
of tests/goldens/affine.npz), masking, apply / backward / shoot, AffinePSR's
fused run against its steps, and the affine branches of both APIs.

Tolerances: a fit is a few float32 sums and a d x d SVD or solve, so M and t
within 1e-5 of JAX's (absolute, entries of order 1) and the losses within
1e-5 relative (1e-4 absolute for the logdet term, which is ~0 for a
rotation); the goldens with the JAX test's own bounds (tests/test_affine.py).
Free-energy sequences of whole registrations within 5e-3 relative, the bound
the JAX package uses between two of its own orderings
(tests/test_psr_basic.py:104).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difficp_tpu.api.icp_atlas import icp_atlas as j_icp_atlas
from difficp_tpu.api.icp_two_set import icp_two_set as j_icp_two_set
from difficp_tpu.models import affine as ja
from difficp_tpu.models import gmm as jg
from difficp_tpu.models.psr import AffinePSR as JAffinePSR
from difficp_torch.api.icp_atlas import icp_atlas as t_icp_atlas
from difficp_torch.api.icp_two_set import icp_two_set as t_icp_two_set
from difficp_torch.models import affine as ta
from difficp_torch.models import gmm as tg
from difficp_torch.models.psr import AffinePSR as TAffinePSR
from difficp_torch.utils.convert import load_psr_state, psr_state_to_numpy

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
G = np.load(os.path.join(HERE, "goldens", "affine.npz"))
SPIRAL = np.load(os.path.join(HERE, "goldens", "spiral.npz"))
CHUI = np.load(os.path.join(HERE, "goldens", "chui_run.npz"))
VERSIONS = ["rigid", "similarity", "general_affine", "translation"]
FE_RTOL = 5e-3


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a, np.float32)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(np.asarray(a, np.float32)) for a in arrays]


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("withlogdet", [False, True])
def test_optimize_matches_golden_and_jax(version, withlogdet):
    fit = ta.optimize(ta.AffineConfig(version=version, withlogdet=withlogdet),
                      *_t(G["x"], G["y"], G["z"], G["w"]))
    tag = f"{version}_{'ld' if withlogdet else 'nold'}"
    np.testing.assert_allclose(fit.m.numpy(), G[f"{tag}_M"], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(fit.t.numpy(), G[f"{tag}_t"], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(float(fit.datal), float(G[f"{tag}_datal"]), rtol=2e-3)
    np.testing.assert_allclose(float(fit.regl), float(G[f"{tag}_regl"]), rtol=2e-3, atol=2e-4)
    jfit = ja.optimize(ja.AffineConfig(version=version, withlogdet=withlogdet),
                       *_j(G["x"], G["y"], G["z"], G["w"]))
    np.testing.assert_allclose(fit.m.numpy(), np.asarray(jfit.m), atol=1e-5)
    np.testing.assert_allclose(fit.t.numpy(), np.asarray(jfit.t), atol=1e-5)
    np.testing.assert_allclose(fit.tx.numpy(), np.asarray(jfit.tx), atol=1e-5)
    np.testing.assert_allclose(float(fit.datal), float(jfit.datal), rtol=1e-5)
    np.testing.assert_allclose(float(fit.regl), float(jfit.regl), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("version", VERSIONS)
def test_frames_batch_like_single_fits(version):
    """K frames in one call (the JAX package vmaps _reg_opt_affine) equal K
    single fits, with a padding mask."""
    rng = np.random.default_rng(0)
    x = np.stack([G["x"] + 0.1 * rng.normal(size=G["x"].shape) for _ in range(3)])
    y, z, w = (np.stack([G[k]] * 3) for k in "yzw")
    mask = (rng.uniform(size=z.shape) > 0.2).astype(np.float32)
    cfg = ta.AffineConfig(version=version)
    batch = ta.optimize(cfg, *_t(x, y, z, w, mask))
    for k in range(3):
        one = ta.optimize(cfg, *_t(x[k], y[k], z[k], w[k], mask[k]))
        np.testing.assert_allclose(batch.m[k].numpy(), one.m.numpy(), atol=1e-6)
        np.testing.assert_allclose(batch.t[k].numpy(), one.t.numpy(), atol=1e-6)
        np.testing.assert_allclose(float(batch.regl[k]), float(one.regl), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("version", ["similarity", "general_affine"])
def test_masked_fit_equals_subset(version):
    """Mirror of tests/test_affine.py::test_masked_fit_equals_subset."""
    mask = (np.random.default_rng(0).uniform(size=G["x"].shape[0]) > 0.3).astype(np.float32)
    idx = np.nonzero(mask)[0]
    cfg = ta.AffineConfig(version=version, withlogdet=True)
    fit_m = ta.optimize(cfg, *_t(G["x"], G["y"], G["z"], G["w"], mask))
    fit_s = ta.optimize(cfg, *_t(G["x"][idx], G["y"][idx], G["z"][idx], G["w"][idx]))
    np.testing.assert_allclose(fit_m.m.numpy(), fit_s.m.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(fit_m.t.numpy(), fit_s.t.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(fit_m.datal), float(fit_s.datal), rtol=1e-4)


def large_frames(dtype):
    """The frames of tests/test_torch_cuda.py::test_affine_fits_on_card_match_cpu:
    10 frames of 65,536 points, each a scaled rotation of the other plus
    noise, weights and a mask."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand((10, 65536, 2), generator=g, dtype=torch.float64)
    th = 0.3 * torch.rand((10,), generator=g, dtype=torch.float64)
    rot = torch.stack([torch.stack([th.cos(), -th.sin()], -1),
                       torch.stack([th.sin(), th.cos()], -1)], -2)
    y = 1.1 * x @ rot.transpose(-1, -2) + 0.01 * torch.randn(x.shape, generator=g,
                                                              dtype=torch.float64)
    z = torch.rand((10, 65536), generator=g, dtype=torch.float64)
    mask = (torch.rand((10, 65536), generator=g, dtype=torch.float64) > 0.1).to(torch.float64)
    return [t.to(dtype) for t in (x, y, z, mask)]


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("withlogdet", [False, True])
def test_float32_fits_of_large_frames(version, withlogdet):
    """The float32 fits of the card test's frames on the CPU: against the
    float64 fit and against the float32 fit of the same points in another
    order (the sums taken in another order), M within 1e-5 of its largest
    |entry| and t within 1e-5 of the largest |coordinate| (1.1e-6 at most
    when written).  The card test holds the card's float32 fits to the
    CPU's at 1e-4 of the same scales, since cuBLAS's long float32 sums
    move M further."""
    cfg = ta.AffineConfig(version=version, withlogdet=withlogdet)
    x, y, z, mask = large_frames(torch.float32)
    fit = ta.optimize(cfg, x, y, z, z, mask)
    exact = ta.optimize(cfg, *large_frames(torch.float64)[:3], z.double(), mask.double())
    perm = torch.randperm(x.shape[1], generator=torch.Generator().manual_seed(1))
    moved = ta.optimize(cfg, *(t[:, perm] for t in (x, y, z, z, mask)))
    scales = float(fit.m.abs().max()), float(y.abs().max())
    for other in (exact, moved):
        for a, b, scale in ((other.m, fit.m, scales[0]), (other.t, fit.t, scales[1])):
            assert float((a.double() - b.double()).abs().max()) <= 1e-5 * scale


def test_not_positive_definite_frame_fails_as_jax():
    """A frame whose points all coincide has A = 0: JAX's Cholesky and solve
    give NaN there; the port gives NaN in that frame only."""
    x = np.stack([G["x"], np.zeros_like(G["x"])])
    y, z, w = (np.stack([G[k]] * 2) for k in "yzw")
    for version in ("general_affine", "similarity"):
        fit = ta.optimize(ta.AffineConfig(version=version), *_t(x, y, z, w))
        jbad = ja.optimize(ja.AffineConfig(version=version), *_j(x[1], y[1], z[1], w[1]))
        assert np.isnan(np.asarray(jbad.m)).all() and torch.isnan(fit.m[1]).all()
        assert torch.isfinite(fit.m[0]).all()


def test_backward_inverts_apply_and_shoot_matches_jax():
    fit = ta.optimize(ta.AffineConfig(version="general_affine", withlogdet=False),
                      *_t(G["x"], G["y"], G["z"]))
    np.testing.assert_allclose(ta.backward(fit.m, fit.t, fit.tx).numpy(), G["x"],
                               rtol=1e-3, atol=1e-4)
    cfg = ta.AffineConfig(version="rigid", withlogdet=True, nt=5)
    got = np.stack(ta.shoot(cfg, *_t(G["shoot_M"], G["shoot_t"], G["x"][:10])))
    np.testing.assert_allclose(got, G["shoot_traj"], rtol=1e-3, atol=1e-4)
    want = np.stack(ja.shoot(ja.AffineConfig(version="rigid", nt=5),
                             *_j(G["shoot_M"], G["shoot_t"], G["x"][:10])))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_rigid_recovers_rotation():
    """Mirror of tests/test_affine.py::test_rigid_recovers_rotation."""
    th = 0.3
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    y = G["x"] @ rot.T + np.array([1.0, 2.0], np.float32)
    fit = ta.optimize(ta.AffineConfig(version="rigid", withlogdet=False),
                      *_t(G["x"], y, np.ones(G["x"].shape[0])))
    np.testing.assert_allclose(fit.m.numpy(), rot, atol=1e-5)
    np.testing.assert_allclose(fit.t.numpy(), [1.0, 2.0], atol=1e-5)
    assert float(fit.datal) < 1e-6


def _fe_trace():
    fes = []

    def callback(psr, after_gmm):
        if not after_gmm:
            fes.append(psr.FE)
    return fes, callback


@pytest.mark.parametrize("reg_type", ["rigid", "similarity", "general_affine"])
def test_icp_atlas_matches_jax(reg_type):
    frames = [SPIRAL[f"x{k}"] for k in range(3)]
    kw = dict(GMM_parameters={"init_components": ("set", 0), "optimize_weights": True},
              registration_parameters={"type": reg_type},
              optim_options={"max_iterations": 6, "convergence_tolerance": 1e-5,
                             "max_repeat_GMM": 10},
              printstuff=False)
    jfes, jcb = _fe_trace()
    jpsr, jevol = j_icp_atlas(frames, callback_function=jcb, **kw)
    tfes, tcb = _fe_trace()
    tpsr, tevol = t_icp_atlas(frames, callback_function=tcb, device="cpu", **kw)
    assert tpsr.fe_increase_events == 0 and jpsr.fe_increase_events == 0
    assert len(tfes) == len(jfes) and len(tevol["M"]) == len(jevol["M"])
    np.testing.assert_allclose(tfes, jfes, rtol=FE_RTOL)
    np.testing.assert_allclose(tpsr.M.numpy(), np.asarray(jpsr.M), atol=2e-3)
    assert tevol["t"][0].shape == (3, 2)


def test_icp_atlas_fitted_gmm_init_matches_jax_from_the_same_fit():
    """{"set": 0, "C": 10}: the port fits one GMM per structure from a
    generator seeded by ``seed``; the JAX package started from those fits (a
    list init, which it treats as the fitted init) gives the same run."""
    frames = [SPIRAL[f"x{k}"] for k in range(3)]
    reg = {"type": "similarity"}
    opts = {"max_iterations": 4, "convergence_tolerance": 1e-5, "max_repeat_GMM": 10}
    tpsr, _ = t_icp_atlas(frames, {"init_components": {"set": 0, "C": 10}}, reg,
                          optim_options=opts, printstuff=False, seed=7, device="cpu")
    st, cfg = tg.fit(torch.as_tensor(frames[0]), 10, torch.Generator().manual_seed(7))
    jinit = [(jg.GMMState(*(jnp.asarray(f.numpy()) for f in st)), jg.GMMConfig(*cfg))]
    jpsr, _ = j_icp_atlas(frames, {"init_components": jinit}, reg, optim_options=opts,
                          printstuff=False)
    assert tpsr.fe_increase_events == 0 and jpsr.fe_increase_events == 0
    assert tpsr.gmm[0].mu.shape == (10, 2)
    np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=FE_RTOL)


def _rotated(x, th, shift, noise, seed):
    c, s = np.cos(th), np.sin(th)
    rot = np.eye(x.shape[1], dtype=np.float32)
    rot[:2, :2] = [[c, -s], [s, c]]
    rng = np.random.default_rng(seed)
    return (x @ rot.T + np.asarray(shift, np.float32)
            + noise * rng.standard_normal(x.shape).astype(np.float32)), rot


def test_two_set_rigid_matches_jax():
    """Mirror of tests/test_api.py::test_two_set_affine, against JAX's run."""
    xa, rot = _rotated(SPIRAL["x0"], 0.35, [0.4, -0.1], 0.02, 1)
    kw = dict(GMM_parameters={"sigma": 0.1, "optimize_sigma": True, "outlier_weight": None},
              registration_parameters={"type": "rigid"},
              optim_options={"max_iterations": 20, "convergence_tolerance": 1e-5,
                             "max_repeat_GMM": 20},
              printstuff=False)
    tpsr, evol = t_icp_two_set(xa, SPIRAL["x0"], device="cpu", **kw)
    jpsr, _ = j_icp_two_set(xa, SPIRAL["x0"], **kw)
    np.testing.assert_allclose(tpsr.M[0].numpy() @ rot, np.eye(2), atol=0.15)
    assert tpsr.fe_increase_events == 0
    np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=FE_RTOL)
    np.testing.assert_allclose(tpsr.M.numpy(), np.asarray(jpsr.M), atol=2e-3)
    assert set(evol) == {"M", "t", "GMMi"}


def test_two_set_3d_rigid():
    """Mirror of tests/test_3d.py::test_two_set_3d_rigid (the same helix
    clouds)."""
    rng = np.random.default_rng(0)
    t = rng.uniform(0, 4 * np.pi, size=(3, 60)).astype(np.float32)
    cloud = (np.stack([np.cos(t[0]), np.sin(t[0]), t[0] / (4 * np.pi)], axis=1)
             + 0.03 * rng.normal(size=(60, 3)).astype(np.float32)).astype(np.float32)
    xa, rot = _rotated(cloud, 0.3, [0.2, -0.1, 0.3], 0.0, 0)
    psr, _ = t_icp_two_set(
        xa, cloud,
        GMM_parameters={"sigma": 0.2, "optimize_sigma": True, "outlier_weight": None},
        registration_parameters={"type": "rigid"},
        optim_options={"max_iterations": 15, "convergence_tolerance": 1e-5,
                       "max_repeat_GMM": 15},
        printstuff=False, device="cpu")
    np.testing.assert_allclose(psr.M[0].numpy() @ rot, np.eye(3), atol=0.2)


def _affine_psrs():
    frames = [SPIRAL[f"x{k}"] for k in range(3)]
    jstate, jcfg = jg.create(jnp.asarray(SPIRAL["mu0"]), sigma=0.1)
    jcfg = jcfg._replace(optimize_mu=True, optimize_w=True)
    jpsr = JAffinePSR(frames, jstate, jcfg, ja.AffineConfig(version="similarity"))
    tstate, tcfg = tg.create(SPIRAL["mu0"], sigma=0.1)
    tcfg = tcfg._replace(optimize_mu=True, optimize_w=True)
    tpsr = TAffinePSR(frames, tstate, tcfg, ta.AffineConfig(version="similarity"),
                      device="cpu")
    for psr in (jpsr, tpsr):
        psr.printstuff = False
    return jpsr, tpsr


def test_affine_fused_run_matches_stepwise_and_jax():
    """Mirror of tests/test_api.py::test_affine_fused_run_matches_stepwise,
    and the port's run against the JAX package's fused run."""
    _, a = _affine_psrs()
    for _ in range(4):
        a.GMM_opt(max_iterations=10, tol=1e-3)
        a.Reg_opt()
    jb, b = _affine_psrs()
    fes = b.run(4, max_em=10, em_tol=1e-3)
    jfes = jb.run(4, max_em=10, em_tol=1e-3)
    assert len(fes) == 4 and b.fe_increase_events == 0
    assert abs(b.FE - a.FE) < 5e-3 * abs(a.FE), (b.FE, a.FE)
    np.testing.assert_allclose(b.M.numpy(), a.M.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(fes, jfes, rtol=FE_RTOL)
    reg = b.Registration(1)
    np.testing.assert_allclose(reg.backward(reg.apply(SPIRAL["x1"])).numpy(), SPIRAL["x1"],
                               atol=1e-5)
    assert b.trajectories(1).shape == (10,) + b.x0[1].shape


def test_affine_state_continues_from_jax():
    """A JAX AffinePSR state after two iterations, loaded into the port
    (utils/convert.load_psr_state: the GMMs, M, t and the points), continues
    as the JAX run does."""
    jpsr, tpsr = _affine_psrs()
    jpsr.run(2, max_em=10, em_tol=1e-3)
    arrays = {"gmm": [{f: np.asarray(getattr(g, f)) for f in jg.GMMState._fields}
                      for g in jpsr.gmm],
              **{k: np.asarray(getattr(jpsr, k)) for k in ("M", "t", "x1", "y", "ptw")},
              "Cfe": [np.asarray(c) for c in jpsr.Cfe], "FE": jpsr.FE}
    tpsr = load_psr_state(tpsr, arrays)
    np.testing.assert_allclose(tpsr.M.numpy(), arrays["M"])
    for psr in (jpsr, tpsr):
        psr.GMM_opt(max_iterations=10, tol=1e-3)
        psr.Reg_opt()
    np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=1e-4)
    assert tpsr.fe_increase_events == 0
    back = psr_state_to_numpy(tpsr)
    np.testing.assert_array_equal(back["M"], tpsr.M.numpy())
    assert back["a0"] is None and back["support_scheme"] is None


def test_chui_similarity_matches_reference_and_jax():
    """Mirror of tests/test_chui.py::test_chui_similarity_matches_reference on
    chui_run.npz, and against the JAX package's run."""
    kw = dict(GMM_parameters={"sigma": 0.1, "optimize_sigma": True, "outlier_weight": None},
              registration_parameters={"type": "similarity"},
              optim_options={"max_iterations": 30, "convergence_tolerance": 1e-4,
                             "max_repeat_GMM": 25},
              printstuff=False)
    psr, _ = t_icp_two_set(CHUI["xa"], CHUI["xb"], device="cpu", **kw)
    fe_ref = float(CHUI["sim_FE"])
    assert abs(psr.FE - fe_ref) < 0.03 * abs(fe_ref), (psr.FE, fe_ref)
    np.testing.assert_allclose(float(psr.gmm[0].sigma), float(CHUI["sim_sigma"]), rtol=0.1)
    assert psr.fe_increase_events == 0
    jpsr, _ = j_icp_two_set(CHUI["xa"], CHUI["xb"], **kw)
    np.testing.assert_allclose(psr.FE, jpsr.FE, rtol=FE_RTOL)
