"""lambda_LDDMM="auto" in the port: ``calibration.calibrate_lambda_lddmm``
against the JAX package's on two spiral sets, and the "auto" branches of
both APIs (two-set: one calibration of xA onto xB's points; atlas: the
harmonic mean over min(K - 1, 10) consecutive pairs, failed pairs skipped,
RuntimeError when none is left).

Tolerances: the affine ICP's reference loss is float32 EM and closed-form
fits, within 1e-3 relative of JAX's; lambda comes out of an L-BFGS
minimization of an exponential loss over 400-odd float32 evaluations, within
5e-2 relative (the bound chip_smoke.py holds the kernels to against their
plain versions).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difficp_tpu.api.icp_atlas import icp_atlas as j_icp_atlas
from difficp_tpu.api.icp_two_set import icp_two_set as j_icp_two_set
from difficp_tpu.models import calibration as jcal
from difficp_torch.api.icp_atlas import icp_atlas as t_icp_atlas
from difficp_torch.api.icp_two_set import icp_two_set as t_icp_two_set
from difficp_torch.models import calibration as tcal

torch.set_num_threads(1)

SPIRAL = np.load(os.path.join(os.path.dirname(__file__), "goldens", "spiral.npz"))
XA, XB = SPIRAL["x0"], SPIRAL["x1"]
DIFFEO = {"type": "diffeomorphic", "sigma_LDDMM": 0.2, "lambda_LDDMM": "auto"}


@pytest.fixture(scope="module")
def jax_lambda():
    return jcal.calibrate_lambda_lddmm(XA, XB, 0.2)


def test_affine_reference_matches_jax():
    """The calibration's first half, the general-affine ICP of xA onto xB,
    against the JAX package's icp_two_set with the same settings."""
    ref = tcal.affine_reference(XA, XB, device="cpu")
    jpsr, _ = j_icp_two_set(
        XA, XB, {"sigma": None, "optimize_sigma": True, "outlier_weight": None},
        {"type": "general_affine"},
        optim_options={"max_iterations": 30, "convergence_tolerance": 1e-4,
                       "max_repeat_GMM": 25}, printstuff=False)
    n = XA.shape[0]
    y, x1 = np.asarray(jpsr.y[0, :n]), np.asarray(jpsr.x1[0, :n])
    sig = float(jpsr.gmm[0].sigma)
    np.testing.assert_allclose(ref.sigref, sig, rtol=1e-3)
    np.testing.assert_allclose(ref.l_ref, ((x1 - y) ** 2).sum() / (2 * sig**2), rtol=1e-3)
    np.testing.assert_allclose(ref.y.numpy(), y, atol=1e-4)


def test_two_set_auto_matches_jax_calibration(jax_lambda):
    """icp_two_set with lambda "auto" calibrates xA onto xB's points (the
    GMM's centroids), then registers with that lambda."""
    psr, _ = t_icp_two_set(XA, XB, {"sigma": 0.1, "optimize_sigma": True}, DIFFEO,
                           {"support_LDDMM": {"scheme": "dense"}, "integration_nt_LDDMM": 5},
                           {"max_iterations": 1}, printstuff=False, device="cpu")
    assert np.isfinite(psr.lcfg.lambd) and psr.lcfg.lambd > 0
    np.testing.assert_allclose(psr.lcfg.lambd, jax_lambda, rtol=5e-2)
    assert psr.fe_increase_events == 0


def test_above_the_pair_limit_follows_jax(monkeypatch):
    """Above the dense pair limit (forced to 2,000 pairs here) v2p drops its
    rcond = 1e-2 for the CG ridge solve at alpha = 1e-4, in both packages:
    the start momenta and their energy H0_ref are far larger, the L-BFGS on
    the exponential loss takes no step (H(p0) = H0_ref), and lambda falls
    from ~486 to ~7.7 on these sets.  A fault of the JAX package that the
    port keeps (ROADMAP section 3); held here so that a change of either is
    seen."""
    from difficp_tpu.ops import backend as jbackend
    from difficp_torch.ops import backend as tbackend

    monkeypatch.setattr(jbackend, "DENSE_PAIR_LIMIT", 2000)
    monkeypatch.setattr(tbackend, "DENSE_PAIR_LIMIT", 2000)
    want = jcal.calibrate_lambda_lddmm(XA, XB, 0.2)
    got = tcal.lambda_from_reference(tcal.affine_reference(XA, XB, device="cpu"), 0.2)
    np.testing.assert_allclose(got.lam, want, rtol=5e-2)
    assert got.deformation == got.h0_ref and got.lam < 20.0


def _stub(values, calls):
    """A calibration that returns values[i] for the i-th pair (raising where
    the value is an exception), recording its arguments."""
    def calibrate(x, x2, sigma, **_):
        calls.append((np.asarray(x).copy(), np.asarray(x2).copy(), sigma))
        v = values[len(calls) - 1]
        if isinstance(v, Exception):
            raise v
        return v
    return calibrate


def test_atlas_auto_is_the_harmonic_mean_of_the_pairs(monkeypatch):
    """Four frames: three pairs (i, i + 1) of the first structure; a pair
    that raises and one that is NaN are skipped; lambda is the harmonic mean
    of the rest, as in the JAX package."""
    frames = [SPIRAL[f"x{k}"][:40] for k in range(4)]
    values = [100.0, ValueError("no fit"), 300.0]
    lams = {}
    for name, mod, atlas in (("torch", tcal, t_icp_atlas), ("jax", jcal, j_icp_atlas)):
        calls = []
        monkeypatch.setattr(mod, "calibrate_lambda_lddmm", _stub(values, calls))
        kw = {"device": "cpu"} if name == "torch" else {}
        psr, _ = atlas(frames, {"init_components": ("set", 0)}, DIFFEO,
                       {"support_LDDMM": {"scheme": "dense"}, "integration_nt_LDDMM": 3},
                       {"max_iterations": 1}, printstuff=False, **kw)
        assert len(calls) == 3
        for i, (x, x2, sigma) in enumerate(calls):
            np.testing.assert_array_equal(x, frames[i])
            np.testing.assert_array_equal(x2, frames[i + 1])
            assert sigma == 0.2
        lams[name] = psr.lcfg.lambd
    assert lams["torch"] == pytest.approx(150.0) and lams["jax"] == pytest.approx(150.0)


def test_icp_atlas_calibration_all_fail(monkeypatch):
    """Mirror of tests/test_round2_fixes.py::test_icp_atlas_calibration_all_fail."""
    monkeypatch.setattr(tcal, "calibrate_lambda_lddmm", lambda *a, **k: float("nan"))
    with pytest.raises(RuntimeError, match="calibration failed"):
        t_icp_atlas([SPIRAL[f"x{k}"] for k in range(3)],
                    GMM_parameters={"init_components": ("set", 0)},
                    registration_parameters=DIFFEO,
                    optim_options={"max_iterations": 1}, printstuff=False, device="cpu")


@pytest.mark.parametrize("fault", ["launch", "oom"])
def test_atlas_auto_raises_device_faults(monkeypatch, fault):
    """A kernel launch failure or running out of device memory in a pair's
    calibration is raised, not skipped as a numerical failure would be."""
    from difficp_torch.ops.rhs_self import KernelLaunchError

    err = (KernelLaunchError("rhs_self_fwd kernel launch failed: CUDA error 700")
           if fault == "launch" else torch.cuda.OutOfMemoryError("out of memory"))
    calls = []
    monkeypatch.setattr(tcal, "calibrate_lambda_lddmm", _stub([100.0, err, 300.0], calls))
    with pytest.raises(type(err)):
        t_icp_atlas([SPIRAL[f"x{k}"][:40] for k in range(4)],
                    GMM_parameters={"init_components": ("set", 0)},
                    registration_parameters=DIFFEO,
                    optim_options={"max_iterations": 1}, printstuff=False, device="cpu")
    assert len(calls) == 2


def test_calibration_takes_points_on_the_device():
    """xB given as a tensor (the API passes the GMM's centroids) gives the
    same reference as xB given as numpy."""
    a = tcal.affine_reference(XA, XB, device="cpu")
    b = tcal.affine_reference(XA, torch.as_tensor(XB), device="cpu")
    assert a.l_ref == b.l_ref and a.sigref == b.sigref
    assert jnp.asarray(a.y.numpy()).shape == (XA.shape[0], 2)
