"""Multi-structure atlases (the diffICP_full shape) in the port: S = 2
structures a frame, one registration a frame spanning both, a GMM a
structure, on frames made by the JAX package's generator; mirrors of
tests/test_multistructure.py against the JAX package's runs.  For time, the
mirrors run on 3 frames (the JAX tests' 4) at integration_nt_LDDMM = 5 on
both sides (their 10), and the grid one over 2 outer iterations (its 4).

Tolerances: free energies within 5e-3 relative, the bound the JAX package
uses between two of its own orderings (tests/test_psr_basic.py:104); the
GMM sigmas within 1e-2 (sigma^2 is the mean of the quadratic term, which
moves more than the free energy it sits in).
"""

import jax
import numpy as np
import pytest
import torch

from difficp_tpu.api import icp_atlas as j_icp_atlas
from difficp_tpu.examples.run_full import generate_multi_structure_frames as j_frames
from difficp_torch.api.icp_atlas import icp_atlas as t_icp_atlas

torch.set_num_threads(1)

FE_RTOL = 5e-3


@pytest.fixture(scope="module")
def frames():
    f = j_frames(jax.random.PRNGKey(0), k=3, n_bounds=(25, 33))
    # 2 structures, as the JAX test keeps
    return [[np.asarray(s) for s in fr[:2]] for fr in f]


def _fe_trace():
    fes = []

    def callback(psr, after_gmm):
        if not after_gmm:
            fes.append(psr.FE)
    return fes, callback


def _both(frames, gmm, reg, numerical, optim):
    out = {}
    for name, atlas, kw in (("jax", j_icp_atlas, {}), ("torch", t_icp_atlas, {"device": "cpu"})):
        fes, cb = _fe_trace()
        psr, _ = atlas(frames, GMM_parameters=gmm, registration_parameters=reg,
                       numerical_options=numerical, optim_options=optim,
                       callback_function=cb, printstuff=False, **kw)
        out[name] = (psr, fes)
    return out


def test_multi_structure_atlas(frames):
    """Mirror of tests/test_multistructure.py::test_multi_structure_atlas,
    against the JAX package's run."""
    runs = _both(frames, {"init_components": ("set", 0), "optimize_weights": True,
                          "outlier_weight": None},
                 {"type": "diffeomorphic", "lambda_LDDMM": 2e2, "sigma_LDDMM": 0.2},
                 {"support_LDDMM": {"scheme": "grid", "rho": 1.2}, "integration_nt_LDDMM": 5},
                 {"max_iterations": 2, "convergence_tolerance": 1e-4, "max_repeat_GMM": 10})
    psr, fes = runs["torch"]
    assert psr.S == 2 and psr.K == 3
    assert psr.fe_increase_events == 0
    np.testing.assert_allclose(fes, runs["jax"][1], rtol=FE_RTOL)
    for s in range(2):
        np.testing.assert_allclose(float(psr.gmm[s].sigma), float(runs["jax"][0].gmm[s].sigma),
                                   rtol=1e-2)
    assert psr.gmm[0].mu.shape[0] != psr.gmm[1].mu.shape[0] or not np.allclose(
        psr.gmm[0].mu[: psr.gmm[1].mu.shape[0]].numpy(), psr.gmm[1].mu.numpy())
    # warped structures retrievable per (k, s) with their true ragged sizes
    for k in range(psr.K):
        for s in range(psr.S):
            pts = psr.get_warped_data_points(k, s)
            assert pts.shape[0] == int(psr.structs[s].n[k]) == frames[k][s].shape[0]
            assert np.isfinite(pts).all()


def test_multi_structure_decim_support(frames):
    """Mirror of tests/test_multistructure.py::test_multi_structure_decim_support,
    against the JAX package's run."""
    runs = _both(frames, {"init_components": 10},
                 {"type": "diffeomorphic", "lambda_LDDMM": 2e2, "sigma_LDDMM": 0.25},
                 {"support_LDDMM": {"scheme": "decim", "rho": 0.7}, "integration_nt_LDDMM": 5},
                 {"max_iterations": 2, "convergence_tolerance": 1e-4, "max_repeat_GMM": 5})
    psr, fes = runs["torch"]
    assert psr.qmask.shape[0] == psr.K
    assert float(psr.qmask.sum(1).min()) > 0
    np.testing.assert_array_equal(psr.qmask.numpy(), np.asarray(runs["jax"][0].qmask))
    assert psr.fe_increase_events == 0
    np.testing.assert_allclose(fes, runs["jax"][1], rtol=FE_RTOL)
