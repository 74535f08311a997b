"""Decim support, the JAX package's default support scheme, in the port:
``utils/point_sets.decimate`` (the port's own copy of the native greedy
decimation, built with g++) and its plain numpy version,
``DiffPSR.set_support_scheme("decim")`` (a support of each frame's own,
padded with masks), the decim ``DiffPSR`` through both routes, the
``icp_atlas`` / ``icp_two_set`` entries with ``{"scheme": "decim"}``, and a
JAX decim state continued in the port (``utils/convert.py``), each against
the JAX package on the same data.

The bound on free energies is the one the JAX package uses between two of its
own L-BFGS orderings (tests/test_psr_basic.py:104): relative 5e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difficp_tpu.native as jnative
from difficp_tpu.api.icp_atlas import icp_atlas as j_icp_atlas
from difficp_tpu.api.icp_two_set import icp_two_set as j_icp_two_set
from difficp_tpu.examples.run_full import generate_multi_structure_frames
from difficp_tpu.models import gmm as jg
from difficp_tpu.models import lddmm as jl
from difficp_tpu.models.psr import DiffPSR as JDiffPSR
from difficp_tpu.utils import point_sets as jps
from difficp_torch.api.icp_atlas import icp_atlas as t_icp_atlas
from difficp_torch.api.icp_two_set import icp_two_set as t_icp_two_set
from difficp_torch.models import gmm as tg
from difficp_torch.models import lddmm as tl
from difficp_torch.models.psr import DiffPSR as TDiffPSR
from difficp_torch.ops import _build
from difficp_torch.ops import backend as TB
from difficp_torch.utils import point_sets as tps
from difficp_torch.utils.convert import load_psr_state, psr_state_to_numpy

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
SPIRAL = np.load(os.path.join(HERE, "goldens", "spiral.npz"))
FE_RTOL = 5e-3
MU = SPIRAL["mu0"]
# K = 3 frames of one structure, or of two (a second spiral beside each)
FRAMES = {1: [SPIRAL[f"x{k}"] for k in range(3)],
          2: [[SPIRAL[f"x{k}"], SPIRAL[f"x{k + 3}"] + np.float32(0.9)] for k in range(3)]}
RHO = 0.5  # cover radius rho * sigma = 0.1: 11-12 support points a spiral


def _lcfg(mod):
    return mod.make_config(sigma=0.2, lambd=500.0, version="hybrid", nt=5, scheme="Euler")


def _gcfg(mod):
    return mod.GMMConfig(optimize_mu=True, optimize_sigma=True, optimize_w=True,
                         optimize_eta0=False)


def _jax_psr(s=1):
    states = [jg.create(jnp.asarray(MU), sigma=0.05)[0]] * s
    psr = JDiffPSR(FRAMES[s], states, [_gcfg(jg)] * s, _lcfg(jl))
    psr.printstuff = False
    psr.set_support_scheme("decim", rho=RHO)
    return psr


def _torch_psr(s=1):
    states = [tg.create(MU, sigma=0.05)[0]] * s
    psr = TDiffPSR(FRAMES[s], states, [_gcfg(tg)] * s, _lcfg(tl), device="cpu")
    psr.printstuff = False
    psr.set_support_scheme("decim", rho=RHO)
    return psr


def _iterate(psr, n_iter):
    """GMM_opt + Reg_opt(carry_memory) per outer iteration; FE after each
    partial step."""
    fes = []
    for _ in range(n_iter):
        psr.GMM_opt(max_iterations=10, tol=1e-3)
        fes.append(psr.FE)
        psr.Reg_opt(tol=1e-3, nmax=2, inner=5, ls_steps=12, carry_memory=True)
        fes.append(psr.FE)
    return np.asarray(fes)


def _covered(x, kept, r):
    d2 = ((x[:, None, :] - x[None, kept, :]) ** 2).sum(-1)
    return bool((d2.min(axis=1) <= np.float32(r) ** 2 * (1 + 1e-6)).all())


# ---------------------------------------------------------------------------
# decimate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r", [0.05, 0.2, 0.6])
@pytest.mark.parametrize("d", [2, 3])
def test_decimate_matches_jax(d, r):
    """The port's native decimation keeps the JAX package's indices, in the
    order picked, at d = 2 and 3 over several radii (600 normal points and a
    2,000-point spiral cloud with duplicates); every point lies within r of a
    kept one; kept and rejected split the indices."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(600, d)).astype(np.float32)
    x[500:520] = x[:20]  # duplicates: ties in the uncovered degrees
    for pts in (x, (np.concatenate([SPIRAL[f"x{k}"] for k in range(10)])[:, :d]
                    if d == 2 else x[::-1].copy())):
        kept, rejected = tps.decimate(pts, r)
        jkept, jrejected = jps.decimate(pts, r)
        assert kept == [int(i) for i in jkept] and rejected == list(jrejected)
        assert sorted(kept + rejected) == list(range(pts.shape[0]))
        assert _covered(pts, kept, r)


@pytest.mark.parametrize("d", [2, 3])
def test_plain_greedy_matches_jax_fallback(d, monkeypatch):
    """At small n the port's plain greedy equals the JAX package's numpy
    fallback (its native library made to fail) and the port's native
    decimation."""
    def unavailable(*args, **kw):
        raise OSError("native decimation made unavailable for the test")

    monkeypatch.setattr(jnative, "decimate_native", unavailable)
    rng = np.random.default_rng(10 + d)
    for n, r in ((150, 0.3), (300, 0.5), (80, 1.5)):
        x = rng.normal(size=(n, d)).astype(np.float32)
        ref = tps.decimate_reference(x, r)
        jkept, jrejected = jps.decimate(x, r)
        assert ref == (list(jkept), list(jrejected))
        assert tps.decimate(x, r) == ref
        assert _covered(x, ref[0], r)


def test_host_library_build_raises_without_fallback(monkeypatch, tmp_path):
    """A failed build of the native library raises: no silent switch to the
    O(N^2) plain greedy."""
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "decimate.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", bad)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "HOST_LIB_PATH", tmp_path / "build" / "libhost.so")
    monkeypatch.setattr(_build, "HOST_STAMP_PATH", tmp_path / "build" / "libhost.cmd")
    monkeypatch.setattr(_build, "_host_lib", None)
    monkeypatch.setattr(tps, "_decimate_bound", False)
    with pytest.raises(RuntimeError, match="host library build failed"):
        tps.decimate(np.zeros((4, 2), np.float32), 0.1)


# ---------------------------------------------------------------------------
# DiffPSR with decim support
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2])
def test_support_bit_for_bit(s):
    """set_support_scheme("decim") at K = 3 spirals with one and with two
    structures: q0 and qmask bit for bit the JAX package's (each frame's own
    support, padded to a multiple of 8 with masks); the start momenta zero."""
    jpsr, tpsr = _jax_psr(s), _torch_psr(s)
    np.testing.assert_array_equal(tpsr.q0.numpy(), np.asarray(jpsr.q0))
    np.testing.assert_array_equal(tpsr.qmask.numpy(), np.asarray(jpsr.qmask))
    counts = tpsr.qmask.sum(1)
    assert tpsr.q0.shape[1] % 8 == 0 and bool((counts > 0).all())
    assert len(set(counts.tolist())) > 1  # ragged: a support of each frame's own
    assert tpsr.support_scheme == "decim" and tpsr.rho == RHO
    np.testing.assert_array_equal(tpsr.a0.numpy(), np.asarray(jpsr.a0))


@pytest.fixture(scope="module")
def jax_decim_fes():
    psr = _jax_psr()
    fes = _iterate(psr, 2)
    assert psr.fe_increase_events == 0
    return fes


@pytest.mark.parametrize("route", [None, "kernel"])
def test_diffpsr_decim_fe_sequence_matches_jax(jax_decim_fes, route):
    """Two outer iterations of GMM_opt + Reg_opt with decim support, three
    frames, on the dense route and on the kernel route (the kernels' plain
    versions on the CPU): the same FE sequence, monotone, every data point
    covered."""
    TB.set_backend(route)
    try:
        psr = _torch_psr()
        fes = _iterate(psr, 2)
    finally:
        TB.set_backend(None)
    assert psr.fe_increase_events == 0
    np.testing.assert_allclose(fes, jax_decim_fes, rtol=FE_RTOL)
    assert np.all(np.diff(fes) <= 1e-4 * np.abs(fes[:-1]) + 1e-6)
    unc = psr.last_reg_stats["uncovered"]
    assert unc.shape == (3, 6) and int(unc.sum()) == 0
    x1 = psr.get_warped_data_points(1)
    assert x1.shape == FRAMES[1][1].shape and np.isfinite(x1).all()


def test_run_with_two_structures_matches_jax_run():
    """DiffPSR.run with decim support over two structures against the JAX
    package's compiled run(): the same per-iteration FE sequence."""
    kw = dict(max_em=10, em_tol=1e-3, reg_nmax=2, reg_tol=1e-3, reg_inner=5, reg_ls=12)
    jpsr, tpsr = _jax_psr(2), _torch_psr(2)
    fes_j, fes_t = jpsr.run(2, **kw), tpsr.run(2, **kw)
    assert tpsr.fe_increase_events == 0 and jpsr.fe_increase_events == 0
    np.testing.assert_allclose(fes_t, fes_j, rtol=FE_RTOL)


def test_continue_from_jax_decim_state():
    """A JAX decim state after one iteration (per-frame q0 and qmask,
    support_scheme "decim", rho), loaded into a port DiffPSR built with
    dense support: one L-BFGS iteration on each side takes the same step
    (FE within 1e-5, momenta within 1e-5 of their largest entry, the same
    evaluations), and the state read back carries the decim support.  (With
    two iterations frame 2's line search takes another evaluation in one
    package than in the other, and the FE differs by 1.4e-4: float32
    differences of the two libraries' sums at a stopping test.)"""
    jpsr = _jax_psr()
    _iterate(jpsr, 1)
    arrays = {
        "gmm": [{f: np.asarray(getattr(g, f)) for f in jg.GMMState._fields}
                for g in jpsr.gmm],
        **{k: np.asarray(getattr(jpsr, k))
           for k in ("a0", "q0", "qmask", "x0", "xmask", "x1", "y", "ptw")},
        "support_scheme": jpsr.support_scheme, "rho": jpsr.rho,
        "Cfe": [np.asarray(c) for c in jpsr.Cfe], "FE": jpsr.FE,
        "_reg_alpha": np.asarray(jpsr._reg_alpha),
        "_reg_alpha_qn": np.asarray(jpsr._reg_alpha_qn),
    }
    state, _ = tg.create(MU, sigma=0.05)
    dense = TDiffPSR(FRAMES[1], state, _gcfg(tg), _lcfg(tl), device="cpu")
    dense.printstuff = False
    tpsr = load_psr_state(dense, arrays)
    assert tpsr.support_scheme == "decim" and tpsr.rho == RHO
    np.testing.assert_array_equal(tpsr.qmask.numpy(), np.asarray(jpsr.qmask))
    for psr in (jpsr, tpsr):
        psr.Reg_opt(tol=1e-3, nmax=1, inner=1, ls_steps=12)
    np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=1e-5)
    np.testing.assert_allclose(tpsr.a0.numpy(), np.asarray(jpsr.a0), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jpsr.a0)).max()))
    np.testing.assert_array_equal(tpsr.last_reg_evals.numpy(),
                                  np.asarray(jpsr.last_reg_evals))
    assert tpsr.fe_increase_events == 0
    back = psr_state_to_numpy(tpsr)
    assert back["support_scheme"] == "decim"
    np.testing.assert_array_equal(back["q0"], np.asarray(jpsr.q0))
    np.testing.assert_array_equal(back["qmask"], np.asarray(jpsr.qmask))


# ---------------------------------------------------------------------------
# the api entries with {"scheme": "decim"}
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def multi_frames():
    """tests/test_multistructure.py's frames: S = 2 structures of K = 4."""
    f = generate_multi_structure_frames(jax.random.PRNGKey(0), k=4, n_bounds=(25, 33))
    return [[np.asarray(s) for s in fr[:2]] for fr in f]


def test_icp_atlas_multi_structure_decim_matches_jax(multi_frames):
    """The mirror of tests/test_multistructure.py::
    test_multi_structure_decim_support through the port's icp_atlas and the
    JAX package's: per-frame supports padded with masks (every frame's mask
    sums to more than 0), the same support bit for bit, the FE monotone and
    within 5e-3 of the JAX package's."""
    kw = dict(
        GMM_parameters={"init_components": 10},
        registration_parameters={"type": "diffeomorphic",
                                 "lambda_LDDMM": 2e2, "sigma_LDDMM": 0.25},
        numerical_options={"support_LDDMM": {"scheme": "decim", "rho": 0.7}},
        optim_options={"max_iterations": 2, "convergence_tolerance": 1e-4,
                       "max_repeat_GMM": 5},
        printstuff=False,
    )
    jpsr, _ = j_icp_atlas(multi_frames, **kw)
    try:
        tpsr, evol = t_icp_atlas(multi_frames, device="cpu", **kw)
    finally:
        TB.set_backend(None)
    assert tpsr.S == 2 and tpsr.K == 4 and tpsr.support_scheme == "decim"
    assert tpsr.qmask.shape[0] == tpsr.K
    assert float(tpsr.qmask.sum(1).min()) > 0
    np.testing.assert_array_equal(tpsr.q0.numpy(), np.asarray(jpsr.q0))
    np.testing.assert_array_equal(tpsr.qmask.numpy(), np.asarray(jpsr.qmask))
    assert tpsr.fe_increase_events == 0 and jpsr.fe_increase_events == 0
    np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=FE_RTOL)
    assert len(evol["a0"]) == 2


def test_icp_two_set_decim_matches_jax():
    """icp_two_set with {"scheme": "decim"} (rho defaulting to 1): the same
    support, final FE and GMM sigma as the JAX package, FE monotone."""
    kw = dict(
        GMM_parameters={"sigma": 0.2, "optimize_sigma": True},
        registration_parameters={"type": "diffeomorphic", "sigma_LDDMM": 0.15,
                                 "lambda_LDDMM": 2000.0},
        numerical_options={"support_LDDMM": {"scheme": "decim"}},
        optim_options={"max_iterations": 2},
        printstuff=False,
    )
    x_a, x_b = SPIRAL["x1"], SPIRAL["x0"]
    jpsr, _ = j_icp_two_set(x_a, x_b, **kw)
    try:
        tpsr, _ = t_icp_two_set(x_a, x_b, device="cpu", **kw)
    finally:
        TB.set_backend(None)
    assert tpsr.support_scheme == "decim" == jpsr.support_scheme and tpsr.rho == 1.0
    np.testing.assert_array_equal(tpsr.q0.numpy(), np.asarray(jpsr.q0))
    assert tpsr.fe_increase_events == 0 and jpsr.fe_increase_events == 0
    np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=FE_RTOL)
    np.testing.assert_allclose(float(tpsr.gmm[0].sigma), float(jpsr.gmm[0].sigma),
                               rtol=FE_RTOL)
