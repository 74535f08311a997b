"""The dense-support slice: the port's DiffPSR with dense support and its
icp_two_set entry against the JAX package on the same data.

The bound on the free-energy sequence is the one the JAX package uses between
two of its own L-BFGS orderings (tests/test_psr_basic.py:104): relative 5e-3.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from difficp_tpu.api.icp_two_set import icp_two_set as j_icp_two_set
from difficp_tpu.models import gmm as jg
from difficp_tpu.models import lddmm as jl
from difficp_tpu.models.psr import DiffPSR as JDiffPSR
from difficp_torch.api.icp_atlas import icp_atlas as t_icp_atlas
from difficp_torch.api.icp_two_set import icp_two_set as t_icp_two_set
from difficp_torch.models import gmm as tg
from difficp_torch.models import lddmm as tl
from difficp_torch.models.psr import DiffPSR as TDiffPSR
from difficp_torch.ops import backend as TB
from difficp_torch.utils.convert import load_psr_state, psr_state_to_numpy

torch.set_num_threads(1)

SPIRAL = np.load(os.path.join(os.path.dirname(__file__), "goldens", "spiral.npz"))
X = SPIRAL["x1"]      # 118 points
MU = SPIRAL["mu0"]    # 20 centroids
FE_RTOL = 5e-3


def _lcfg(mod):
    return mod.make_config(sigma=0.2, lambd=500.0, version="hybrid", nt=5, scheme="Euler")


def _gcfg(mod):
    return mod.GMMConfig(optimize_mu=True, optimize_sigma=True, optimize_w=True,
                         optimize_eta0=False)


def _jax_psr():
    state, _ = jg.create(jnp.asarray(MU), sigma=0.05)
    psr = JDiffPSR(X, state, _gcfg(jg), _lcfg(jl))
    psr.printstuff = False
    return psr


def _torch_psr():
    state, _ = tg.create(MU, sigma=0.05)
    psr = TDiffPSR(X, state, _gcfg(tg), _lcfg(tl), device="cpu")
    psr.printstuff = False
    return psr


def _iterate(psr, n_iter):
    """GMM_opt + 2 x Reg_opt(carry_memory, carry_value) per outer iteration,
    the schedule of examples/run_large.py."""
    fes = []
    for _ in range(n_iter):
        psr.GMM_opt(max_iterations=10, tol=1e-3)
        fes.append(psr.FE)
        for _ in range(2):
            psr.Reg_opt(tol=1e-3, nmax=1, inner=2, ls_steps=25, carry_memory=True,
                        carry_value=True)
            fes.append(psr.FE)
    return np.asarray(fes)


@pytest.fixture(scope="module")
def jax_fes():
    psr = _jax_psr()
    fes = _iterate(psr, 3)
    assert psr.fe_increase_events == 0
    return fes


@pytest.mark.parametrize("route", [None, "kernel"])
def test_diffpsr_fe_sequence_matches_jax(jax_fes, route):
    """Three outer iterations on the dense route and on the kernel route
    (the kernels' plain versions on the CPU): the same FE sequence, monotone."""
    TB.set_backend(route)
    try:
        psr = _torch_psr()
        fes = _iterate(psr, 3)
    finally:
        TB.set_backend(None)
    assert psr.fe_increase_events == 0
    np.testing.assert_allclose(fes, jax_fes, rtol=FE_RTOL)
    assert np.all(np.diff(fes) <= 1e-4 * np.abs(fes[:-1]) + 1e-6)
    x1 = psr.get_warped_data_points()
    assert x1.shape == X.shape and np.isfinite(x1).all()


def test_continue_from_jax_state():
    """Load the JAX state after one outer iteration into the port
    (utils/convert.load_psr_state); one Reg_opt on each side then gives the
    same momenta and free energy."""
    jpsr = _jax_psr()
    _iterate(jpsr, 1)
    mem = jpsr._reg_memory
    arrays = {
        "gmm": [{f: np.asarray(getattr(g, f)) for f in jg.GMMState._fields}
                for g in jpsr.gmm],
        **{k: np.asarray(getattr(jpsr, k))
           for k in ("a0", "q0", "qmask", "x0", "xmask", "x1", "y", "ptw")},
        "Cfe": [np.asarray(c) for c in jpsr.Cfe], "FE": jpsr.FE,
        "_reg_alpha": np.asarray(jpsr._reg_alpha),
        "_reg_alpha_qn": np.asarray(jpsr._reg_alpha_qn),
        "_reg_memory": {f: np.asarray(getattr(mem, f)) for f in mem._fields},
        "_reg_stall": np.asarray(jpsr._reg_stall),
    }
    tpsr = load_psr_state(_torch_psr(), arrays)
    # the loaded targets give the same GMM energy terms
    np.testing.assert_allclose(float(sum(tpsr.Cfe) + tpsr.quadloss.sum()),
                               float(sum(jpsr.Cfe) + jnp.sum(jpsr.quadloss)), rtol=1e-5)

    for psr in (jpsr, tpsr):
        psr.Reg_opt(tol=1e-3, nmax=1, inner=2, ls_steps=25, carry_memory=True)
    np.testing.assert_allclose(tpsr.a0.numpy(), np.asarray(jpsr.a0), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=1e-5)
    assert int(tpsr.last_reg_evals[0]) == int(jpsr.last_reg_evals[0])
    back = psr_state_to_numpy(tpsr)
    np.testing.assert_array_equal(back["a0"], tpsr.a0.numpy())
    assert back["_reg_memory"]["S"].shape == np.asarray(jpsr._reg_memory.S).shape


def test_reg_opt_frame_chunk_matches_unchunked():
    """Six frames in lockstep: Reg_opt(frame_chunk=2) slices every threaded
    per-frame state and reproduces the unchunked call (lanes are
    independent), as tests/test_round5_fixes.py holds the JAX package."""
    x = [SPIRAL[f"x{k}"] for k in range(6)]
    lcfg = tl.make_config(sigma=0.2, lambd=500.0, version="hybrid", nt=3,
                          scheme="Euler")

    def build():
        state = tg.GMMState(mu=torch.as_tensor(MU) + 0.01, w=torch.zeros(20),
                            sigma=torch.tensor(0.1), eta0=torch.tensor(0.0),
                            vol0=torch.tensor(0.0))
        psr = TDiffPSR(x, state, tg.GMMConfig(), lcfg, device="cpu")
        psr.printstuff = False
        psr.GMM_opt(max_iterations=3, tol=0.0)
        return psr

    a, b = build(), build()
    for _ in range(2):
        a.Reg_opt(tol=1e-3, nmax=1, inner=4, ls_steps=8, carry_memory=True,
                  carry_value=True)
        b.Reg_opt(tol=1e-3, nmax=1, inner=4, ls_steps=8, carry_memory=True,
                  carry_value=True, frame_chunk=2)
    np.testing.assert_allclose(a.a0.numpy(), b.a0.numpy(), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(a.FE, b.FE, rtol=1e-6)
    np.testing.assert_array_equal(a._reg_stall.numpy(), b._reg_stall.numpy())
    assert a.fe_increase_events == 0


def test_icp_two_set_matches_jax():
    """The api entry with dense support: same FE after two iterations.  Each
    Reg_opt here runs 10 x 20 L-BFGS iterations, so the configuration is a
    well-regularized one (lambda 2000): at lambda 500 the JAX package's own
    final FE moves by ~1% under a 1e-7 jitter of its input (float32 line
    searches take other branches), which no port can match more closely."""
    kw = dict(
        GMM_parameters={"sigma": 0.2, "optimize_sigma": True},
        registration_parameters={"type": "diffeomorphic", "sigma_LDDMM": 0.3,
                                 "lambda_LDDMM": 2000.0},
        numerical_options={"support_LDDMM": {"scheme": "dense"},
                           "integration_nt_LDDMM": 5},
        optim_options={"max_iterations": 2},
        printstuff=False,
    )
    jpsr, _ = j_icp_two_set(X, SPIRAL["x0"], **kw)
    try:
        tpsr, evol = t_icp_two_set(X, SPIRAL["x0"], device="cpu", **kw)
    finally:
        TB.set_backend(None)
    assert tpsr.fe_increase_events == 0 and jpsr.fe_increase_events == 0
    np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=FE_RTOL)
    assert len(evol["a0"]) == 2
    np.testing.assert_allclose(float(tpsr.gmm[0].sigma), float(jpsr.gmm[0].sigma),
                               rtol=FE_RTOL)


def test_backward_precision_raises():
    """backward_precision takes "fast" (the backward kernels, the default) and
    "accurate" (the blockwise VJP), which set the kernel route's backward,
    and raises ValueError on any other value."""
    from difficp_torch.api.common import default_numerical_options
    from difficp_torch.ops import rhs_self as RS

    base = dict(GMM_parameters={"sigma": 0.1, "optimize_sigma": True}, printstuff=False,
                device="cpu")
    diffeo = {"type": "diffeomorphic", "sigma_LDDMM": 0.2, "lambda_LDDMM": 500.0}
    try:
        for mode in ("accurate", "fast"):
            opts = default_numerical_options({"backward_precision": mode})
            assert opts["backward_precision"] == mode == RS._BWD_PRECISION["mode"]
        assert default_numerical_options(None)["backward_precision"] == "fast"
        with pytest.raises(ValueError, match="backward precision"):
            t_icp_two_set(X, SPIRAL["x0"], registration_parameters=diffeo,
                          numerical_options={"support_LDDMM": {"scheme": "dense"},
                                             "backward_precision": "exact"}, **base)
    finally:
        TB.set_backend(None)
        TB.set_bwd_precision("fast")


def test_entry_points_need_cuda_unless_cpu_asked():
    """Without CUDA, DiffPSR, icp_two_set and icp_atlas with no device raise
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    state, _ = tg.create(MU, sigma=0.05)
    with pytest.raises(RuntimeError, match="CUDA"):
        TDiffPSR(X, state, _gcfg(tg), _lcfg(tl))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_icp_two_set(X, SPIRAL["x0"], {"sigma": 0.1, "optimize_sigma": True},
                      {"type": "diffeomorphic", "sigma_LDDMM": 0.2, "lambda_LDDMM": 500.0},
                      {"support_LDDMM": {"scheme": "dense"}}, printstuff=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_icp_atlas([X, SPIRAL["x0"]], {"init_components": 10},
                    {"type": "diffeomorphic", "sigma_LDDMM": 0.2, "lambda_LDDMM": 500.0},
                    printstuff=False)
