"""Two-set diffeomorphic registration on the Chui-Rangarajan benchmark, the
port against the reference golden run (mirror of
tests/test_chui.py::test_chui_diffeomorphic_matches_reference, its bars:
the FE within 5%, the warped cloud's mean nearest-neighbour distance to the
reference's under 0.05, no free-energy increase)."""

import os

import numpy as np
import torch

from difficp_torch.api.icp_two_set import icp_two_set

torch.set_num_threads(1)

G = np.load(os.path.join(os.path.dirname(__file__), "goldens", "chui_run.npz"))


def test_chui_diffeomorphic_matches_reference():
    psr, _ = icp_two_set(
        G["xa"], G["xb"],
        GMM_parameters={"sigma": 0.1, "optimize_sigma": True, "outlier_weight": None},
        registration_parameters={"type": "diffeomorphic", "lambda_LDDMM": 200.0,
                                 "sigma_LDDMM": 0.2},
        optim_options={"max_iterations": 30, "convergence_tolerance": 1e-4,
                       "max_repeat_GMM": 25},
        printstuff=False, device="cpu")
    fe_ref = float(G["diff_FE"])
    assert abs(psr.FE - fe_ref) < 0.05 * abs(fe_ref), (psr.FE, fe_ref)
    ours = psr.get_warped_data_points(0)
    ref = G["diff_x1"]
    d2 = ((ours[:, None, :] - ref[None, :, :]) ** 2).sum(-1)
    assert np.sqrt(d2.min(1)).mean() < 0.05
    assert psr.fe_increase_events == 0
