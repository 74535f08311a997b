"""End to end with grid support: the port's DiffPSR on the diffICP_basic
workload (one spiral point set onto a fixed spiral GMM, sigma optimized, grid
support with rho = sqrt 2) against the torch-reference golden run, at the
bounds of tests/test_psr_basic.py; and its run() against its stepwise loop.
"""

import os

import numpy as np
import torch

from difficp_torch.models import gmm, lddmm
from difficp_torch.models.psr import DiffPSR

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
SPIRAL = np.load(os.path.join(HERE, "goldens", "spiral.npz"))
REF = np.load(os.path.join(HERE, "goldens", "basic_run.npz"))


def _build_psr():
    mu = SPIRAL["mu0"]
    state = gmm.GMMState(mu=torch.as_tensor(mu), w=torch.zeros(mu.shape[0]),
                         sigma=torch.tensor(0.1), eta0=torch.tensor(0.0),
                         vol0=torch.tensor(0.0))
    cfg = gmm.GMMConfig(use_outliers=False, optimize_mu=False, optimize_sigma=True,
                        optimize_w=False, optimize_eta0=False)
    lcfg = lddmm.make_config(sigma=0.2, lambd=5e2, version="classic", nt=10,
                             scheme="Euler")
    psr = DiffPSR(SPIRAL["x0"], state, cfg, lcfg, device="cpu")
    psr.printstuff = False
    psr.set_support_scheme("grid", rho=float(np.sqrt(2.0)))
    return psr


def _warped(psr):
    return psr.x1[0, : int(psr.structs[0].n[0])].numpy()


def test_basic_run_matches_reference():
    """20 outer iterations: final FE within 1% and sigma within 2e-3 of the
    golden (tests/test_psr_basic.py's bounds, there traced to the
    reference's own spread), mean residual of the warped points under 0.02,
    FE monotone."""
    psr = _build_psr()
    fes = []
    for _ in range(20):
        psr.GMM_opt(tol=1e-5)
        psr.Reg_opt(tol=1e-5, nmax=10)
        fes.append(psr.FE)
    fe_ref = float(REF["FE_seq"][-1])
    assert abs(psr.FE - fe_ref) < 0.01 * abs(fe_ref), (psr.FE, fe_ref)
    np.testing.assert_allclose(float(psr.gmm[0].sigma), float(REF["final_sigma"]),
                               rtol=2e-3)
    resid = np.sqrt(((_warped(psr) - REF["final_x1"]) ** 2).sum(-1))
    assert resid.mean() < 0.02, resid.mean()
    fes = np.asarray(fes)
    assert np.all(np.diff(fes) <= 1e-3 * np.abs(fes[:-1]) + 1e-4)
    assert psr.fe_increase_events == 0


def test_run_matches_stepwise():
    """run(5) tracks five stepwise GMM_opt + Reg_opt iterations: final FE
    within 5e-3, warped points within 0.01 on average (the bounds of
    tests/test_psr_basic.py::test_fused_run_matches_stepwise)."""
    psr_a, psr_b = _build_psr(), _build_psr()
    for _ in range(5):
        psr_a.GMM_opt(max_iterations=25, tol=1e-3)
        psr_a.Reg_opt(tol=1e-3, nmax=10)
    fes = psr_b.run(5, max_em=25, em_tol=1e-3, reg_nmax=10, reg_tol=1e-3)
    assert len(fes) == 5 and psr_b.fe_increase_events == 0
    assert abs(psr_b.FE - psr_a.FE) < 5e-3 * abs(psr_a.FE), (psr_b.FE, psr_a.FE)
    assert np.sqrt(((_warped(psr_a) - _warped(psr_b)) ** 2).sum(-1)).mean() < 0.01
