"""The standard algorithm's entry points in the port: the golden run of
tests/test_standard_golden.py, the standard cases of tests/test_api.py:
135-260, noise_std="auto", and calibrate_noise_std against the JAX
package's.

Tolerances: the golden and API cases with the JAX tests' own bounds;
calibrate_noise_std within 5e-3 relative, the bound the JAX package uses
between two of its own orderings (tests/test_psr_basic.py:104).
"""

import os

import numpy as np
import pytest
import torch

from difficp_tpu.models.calibration import calibrate_noise_std as j_calibrate_noise_std
from difficp_torch.api.standard_atlas import standard_atlas
from difficp_torch.api.standard_two_set import standard_two_set
from difficp_torch.models.calibration import calibrate_noise_std
from difficp_torch.models.psr_standard import data_distance

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
SPIRAL = np.load(os.path.join(HERE, "goldens", "spiral.npz"))
GOLD = np.load(os.path.join(HERE, "goldens", "standard_run.npz"))
X0 = SPIRAL["x0"]  # ~106 2D points
X1 = SPIRAL["x1"]  # ~118 2D points
E_RTOL = 5e-3
DIFF = {"type": "diffeomorphic", "sigma_data": 0.1, "noise_std": 0.2, "sigma_LDDMM": 0.2}


def _rot(th):
    return np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)


def test_golden_data_distance():
    got = float(data_distance(torch.tensor(GOLD["xb"]), torch.tensor(GOLD["xa"]), 0.1))
    np.testing.assert_allclose(got, float(GOLD["data_distance_0.1"]), rtol=1e-4)


def test_golden_standard_two_set():
    """tests/test_standard_golden.py's run: the energy within 1.3 of the
    torch reference's, no increase."""
    psr, _ = standard_two_set(
        GOLD["xa"], GOLD["xb"], dict(DIFF),
        optim_options={"max_iterations": 6, "convergence_tolerance": 1e-4,
                       "nmax_per_iter": 4},
        printstuff=False, device="cpu")
    assert psr.E < 1.3 * float(GOLD["E"]) + 1e-6, (psr.E, float(GOLD["E"]))
    assert psr.e_increase_events == 0


# ---------------------------------------------------------------------------
# tests/test_api.py:135-260, the standard cases
# ---------------------------------------------------------------------------

def test_standard_two_set_diff():
    psr, _ = standard_two_set(
        X0, X1, dict(DIFF),
        optim_options={"max_iterations": 4, "convergence_tolerance": 1e-4, "nmax_per_iter": 4},
        printstuff=False, device="cpu")
    assert psr.e_increase_events == 0
    start = float(data_distance(torch.tensor(X1), torch.tensor(X0), 0.1)) / 0.2**2 + 1.0
    assert psr.E < start


def test_standard_two_set_affine():
    rot = _rot(0.3)
    xa = X0 @ rot.T + np.array([0.3, 0.1], np.float32)
    psr, _ = standard_two_set(
        xa, X0, {"type": "rigid", "sigma_data": 0.1},
        optim_options={"max_iterations": 6, "convergence_tolerance": 1e-5, "nmax_per_iter": 6},
        printstuff=False, device="cpu")
    np.testing.assert_allclose(psr.M[0].numpy() @ rot, np.eye(2), atol=0.2)


def test_standard_two_set_similarity_expm():
    rot = _rot(0.25)
    xa = 1.2 * (X0 @ rot.T) + np.array([0.2, 0.1], np.float32)
    psr, _ = standard_two_set(
        xa, X0, {"type": "similarity", "sigma_data": 0.1},
        optim_options={"max_iterations": 6, "convergence_tolerance": 1e-5, "nmax_per_iter": 6},
        printstuff=False, device="cpu")
    scale = np.sqrt(np.abs(np.linalg.det(psr.M[0].numpy())))
    assert 0.6 < scale < 1.05


def test_standard_two_set_grid_support():
    psr, _ = standard_two_set(
        X0, X1, dict(DIFF), {"support_LDDMM": {"scheme": "grid", "rho": 1.2}},
        optim_options={"max_iterations": 3, "convergence_tolerance": 1e-4, "nmax_per_iter": 3},
        printstuff=False, device="cpu")
    assert psr.support_scheme == "grid"
    assert psr.e_increase_events == 0


def test_standard_atlas_small():
    x = [SPIRAL[f"x{k}"] for k in range(3)]
    psr, evol = standard_atlas(
        x, initial_template=0, model_parameters=dict(DIFF),
        optim_options={"max_iterations": 3, "convergence_tolerance": 1e-4},
        printstuff=False, device="cpu")
    assert psr.e_increase_events <= 1  # template re-projection may wobble once
    assert len(evol["y0"]) == 3


def test_standard_atlas_template_weights():
    x = [SPIRAL[f"x{k}"][:40] for k in range(3)]
    psr, evol = standard_atlas(
        x, initial_template=0,
        model_parameters={"sigma_data": 0.12, "noise_std": 0.3, "sigma_LDDMM": 0.25,
                          "use_template_weights": True},
        optim_options={"max_iterations": 2, "convergence_tolerance": 1e-4},
        printstuff=False, device="cpu")
    assert "w0" in evol and len(evol["w0"]) == 2
    w = psr.w0[0].numpy()
    assert np.isfinite(w).all()
    assert abs(float(w.sum()) - 1.0) < 0.5


def test_standard_atlas_auto_noise_and_sigma_data():
    """noise_std="auto" (the harmonic mean of the calibrations of frame pairs)
    and sigma_data=None (the sets' mean intrinsic scale)."""
    x = [SPIRAL[f"x{k}"][:20] for k in range(2)]
    psr, _ = standard_atlas(
        x, initial_template=0,
        model_parameters={"sigma_data": None, "noise_std": "auto", "sigma_LDDMM": 0.25},
        optim_options={"max_iterations": 1}, printstuff=False, device="cpu")
    assert np.isfinite(psr.noise_std[0]) and psr.noise_std[0] > 0
    assert 0 < psr.data_sigma < 1 and np.isfinite(psr.E)


def test_standard_entry_points_validate():
    with pytest.raises(ValueError):
        standard_two_set(X0, X1, {"type": "diffeomorphic", "sigma_data": 0.1}, device="cpu")
    with pytest.raises(ValueError):
        standard_atlas([X0, X1], 0, {"sigma_data": 0.1}, device="cpu")


def test_calibrate_noise_std_matches_jax():
    """calibrate_noise_std of 30 spiral points onto 30 of another frame
    within E_RTOL of the JAX package's."""
    xa, xb = SPIRAL["x0"][:30], SPIRAL["x1"][:30]
    want = j_calibrate_noise_std(xa, xb, 0.25)
    got = calibrate_noise_std(xa, xb, 0.25, device="cpu")
    np.testing.assert_allclose(got, want, rtol=E_RTOL)
