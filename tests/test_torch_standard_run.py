"""The standard algorithm against the JAX package end to end: the fused run
of DiffPSRStd and the affine fits of AffinePSRStd.

Tolerances: energies within 5e-3 relative of the JAX package's (the bound
it uses between two of its own orderings, tests/test_psr_basic.py:104); an
affine fit's energy is a float32 cancellation near 0 at its optimum, so it
is held within 5e-3 of the start energy, and M and t within 1e-5, as
torch.linalg.matrix_exp against jax.scipy's expm.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difficp_tpu.api import standard_two_set as j_standard_two_set
from difficp_torch.api.standard_two_set import standard_two_set
from difficp_torch.models.psr_standard import data_distance

from test_torch_standard import build

torch.set_num_threads(1)

SPIRAL = np.load(os.path.join(os.path.dirname(__file__), "goldens", "spiral.npz"))
E_RTOL = 5e-3


def _rot(th):
    return np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)


@pytest.mark.parametrize("support,weights", [(None, False), ("grid", True)])
def test_fused_run_matches_jax(support, weights):
    """DiffPSRStd.run(1) from the start (tests/test_standard_scale.py's
    problem): the energies after each phase within E_RTOL of the JAX
    package's fused loop, no increase."""
    want = build(True, support, weights).run(1, reg_nmax=2, tmpl_nmax=2)
    psr = build(False, support, weights)
    got = psr.run(1, reg_nmax=2, tmpl_nmax=2)
    assert got.shape == want.shape == (1, 2)
    np.testing.assert_allclose(got, want, rtol=E_RTOL)
    assert psr.e_increase_events == 0


@pytest.mark.parametrize("reg_type,scale", [("rigid", 1.0), ("similarity", 1.2),
                                            ("general_affine", 1.1)])
def test_affine_two_set_matches_jax(reg_type, scale):
    """standard_two_set with an affine type (AffinePSRStd: L-BFGS over M and
    t, through matrix_exp for rigid and similarity) on a rotated, scaled and
    shifted copy of 60 spiral points: M and t within 1e-5 of the JAX
    package's, the energy within E_RTOL of the start energy."""
    x0 = SPIRAL["x0"][:60]
    xa = (scale * (x0 @ _rot(0.3).T) + np.array([0.3, 0.1], np.float32)).astype(np.float32)
    mp = {"type": reg_type, "sigma_data": 0.1}
    oo = {"max_iterations": 4, "convergence_tolerance": 1e-5, "nmax_per_iter": 6}
    jpsr, _ = j_standard_two_set(xa, x0, mp, optim_options=oo, printstuff=False)
    psr, _ = standard_two_set(xa, x0, mp, optim_options=oo, printstuff=False, device="cpu")
    np.testing.assert_allclose(psr.M.numpy(), np.asarray(jpsr.M), atol=1e-5)
    np.testing.assert_allclose(psr.t.numpy(), np.asarray(jpsr.t), atol=1e-5)
    e_start = float(data_distance(torch.tensor(x0)[None], torch.tensor(xa)[None], 0.1)[0])
    assert abs(psr.E - jpsr.E) <= E_RTOL * e_start
    assert psr.e_increase_events == jpsr.e_increase_events == 0


def test_matrix_exp_matches_expm():
    rng = np.random.default_rng(0)
    for d in (2, 3):
        a = rng.normal(size=(4, d, d)).astype(np.float32)
        skew = (a - a.transpose(0, 2, 1)) / 2
        got = torch.linalg.matrix_exp(torch.tensor(skew)).numpy()
        for k in range(4):
            want = np.asarray(jax.scipy.linalg.expm(jnp.asarray(skew[k])))
            np.testing.assert_allclose(got[k], want, atol=1e-5)
