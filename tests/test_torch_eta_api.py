"""The gradcomponent (eta != 0) model at the port's API against the JAX
package: icp_two_set and icp_atlas (grid support, the default) with
gradcomponent_LDDMM=True.  The bound on free energies is the one the JAX package uses
between two of its own L-BFGS orderings (tests/test_psr_basic.py:104):
relative 5e-3.
"""

import os

import numpy as np
import pytest
import torch

from difficp_tpu.api.icp_atlas import icp_atlas as j_icp_atlas
from difficp_tpu.api.icp_two_set import icp_two_set as j_icp_two_set
from difficp_torch.api.icp_atlas import icp_atlas as t_icp_atlas
from difficp_torch.api.icp_two_set import icp_two_set as t_icp_two_set
from difficp_torch.ops import backend as TB
from test_torch_eta_psr import patch_jax_start

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
SPIRAL = np.load(os.path.join(HERE, "goldens", "spiral.npz"))
FRAMES = [SPIRAL[f"x{k}"] for k in range(3)]
MU = SPIRAL["mu0"]
FE_RTOL = 5e-3


def test_icp_entries_with_gradcomponent_match_jax(monkeypatch):
    """icp_two_set and icp_atlas with default support (grid) and
    gradcomponent_LDDMM=True: the option reaches the model (eta = 1 /
    lambda), the run is monotone and ends at the JAX package's free energy
    and GMM sigma within 5e-3, the JAX package given the port's start free
    energy (test_torch_eta_psr.patch_jax_start)."""
    patch_jax_start(monkeypatch)
    reg = {"type": "diffeomorphic", "sigma_LDDMM": 0.3, "lambda_LDDMM": 200.0}
    num = {"gradcomponent_LDDMM": True, "integration_nt_LDDMM": 5}
    cases = (
        (j_icp_two_set, t_icp_two_set, (SPIRAL["x1"], SPIRAL["x0"]),
         dict(GMM_parameters={"sigma": 0.2, "optimize_sigma": True},
              numerical_options=num)),
        (j_icp_atlas, t_icp_atlas, (FRAMES[:2],),
         dict(GMM_parameters={"init_components": ("set", 0)}, numerical_options=num)),
    )
    for j_fn, t_fn, args, kw in cases:
        kw = dict(kw, registration_parameters=reg, optim_options={"max_iterations": 2},
                  printstuff=False)
        jpsr, _ = j_fn(*args, **kw)
        try:
            tpsr, _ = t_fn(*args, device="cpu", **kw)
        finally:
            TB.set_backend(None)
        assert tpsr.lcfg.eta == pytest.approx(1.0 / 200.0) and tpsr.lcfg.withlogdet
        assert tpsr.fe_increase_events == 0 and jpsr.fe_increase_events == 0
        np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=FE_RTOL)
        np.testing.assert_allclose(float(tpsr.gmm[0].sigma), float(jpsr.gmm[0].sigma),
                                   rtol=FE_RTOL)
