"""The grid-support slice as a whole: grid_support, shooting with external
points, v2p, DiffPSR with grid support (stepwise and run()), the
Registration handle, and the icp_two_set / icp_atlas entries with default
numerical options, each against the JAX package on the same data.

The bound on free energies is the one the JAX package uses between two of its
own L-BFGS orderings (tests/test_psr_basic.py:104): relative 5e-3.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from difficp_tpu.api.icp_atlas import icp_atlas as j_icp_atlas
from difficp_tpu.api.icp_two_set import icp_two_set as j_icp_two_set
from difficp_tpu.models import gmm as jg
from difficp_tpu.models import lddmm as jl
from difficp_tpu.models.psr import DiffPSR as JDiffPSR
from difficp_tpu.utils import point_sets as jps
from difficp_torch.api.icp_atlas import icp_atlas as t_icp_atlas
from difficp_torch.api.icp_two_set import icp_two_set as t_icp_two_set
from difficp_torch.models import gmm as tg
from difficp_torch.models import lddmm as tl
from difficp_torch.models.psr import DiffPSR as TDiffPSR
from difficp_torch.ops import backend as TB
from difficp_torch.utils import point_sets as tps
from difficp_torch.utils.convert import load_psr_state, psr_state_to_numpy

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
SPIRAL = np.load(os.path.join(HERE, "goldens", "spiral.npz"))
GOLD = np.load(os.path.join(HERE, "goldens", "lddmm.npz"))
FE_RTOL = 5e-3
FRAMES = [SPIRAL[f"x{k}"] for k in range(3)]
MU = SPIRAL["mu0"]


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _lcfg(mod, nt=5):
    return mod.make_config(sigma=0.2, lambd=500.0, version="hybrid", nt=nt,
                           scheme="Euler")


def _gcfg(mod):
    return mod.GMMConfig(optimize_mu=True, optimize_sigma=True, optimize_w=True,
                         optimize_eta0=False)


def _jax_psr(x=FRAMES):
    state, _ = jg.create(jnp.asarray(MU), sigma=0.05)
    psr = JDiffPSR(x, state, _gcfg(jg), _lcfg(jl))
    psr.printstuff = False
    psr.set_support_scheme("grid", rho=1.0)
    return psr


def _torch_psr(x=FRAMES):
    state, _ = tg.create(MU, sigma=0.05)
    psr = TDiffPSR(x, state, _gcfg(tg), _lcfg(tl), device="cpu")
    psr.printstuff = False
    psr.set_support_scheme("grid", rho=1.0)
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


# ---------------------------------------------------------------------------
# point sets, external-point shooting, v2p
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["spiral", "box3d", "ticks"])
def test_grid_support_bit_identical(case):
    rng = np.random.default_rng(4)
    if case == "spiral":
        args = (np.concatenate(FRAMES), 0.05)
        kw = {}
    elif case == "box3d":
        args = (rng.uniform(-1, 2, size=(500, 3)).astype(np.float32), 0.3)
        kw = {}
    else:
        args = (None, 0.1)
        kw = {"ticks": [np.linspace(0, 1, 7), np.linspace(-1, 0, 4)]}
    got = tps.grid_support(*args, **kw)
    ref = jps.grid_support(*args, **kw)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("route", [None, "kernel"])
def test_intrinsic_scale_matches_jax(route):
    """Mean nearest-neighbour distance, masked, through the dense route and
    through kmin2 with self-exclusion (its plain version here)."""
    x = SPIRAL["x2"]
    mask = np.ones(x.shape[0], np.float32)
    mask[-9:] = 0.0
    ref = jps.intrinsic_scale(jnp.asarray(x), jnp.asarray(mask))
    TB.set_backend(route)
    try:
        got = tps.intrinsic_scale(_t(x), _t(mask))
        assert np.isclose(tps.intrinsic_scale(_t(x)), jps.intrinsic_scale(x), rtol=1e-6)
    finally:
        TB.set_backend(None)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("version", ["classic", "hybrid"])
@pytest.mark.parametrize("scheme", ["Euler", "Ralston"])
def test_shoot_external_points_matches_golden(version, scheme):
    """Arrival of the advected points x, the divergence cost at them and the
    trajectory loss against the torch-reference goldens, at the tolerances
    of tests/test_lddmm.py."""
    cfg = tl.make_config(sigma=0.4, lambd=3.0, version=version, nt=10, scheme=scheme)
    tag = f"{version}_{scheme}"
    final, _ = tl.shoot(cfg, _t(GOLD["q0"]), _t(GOLD["p0"]), _t(GOLD["x0"]))
    np.testing.assert_allclose(final.x.numpy(), GOLD[f"{tag}_x1"], rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(float(final.cost), float(GOLD[f"{tag}_costx1"][0]),
                               rtol=1e-3, atol=2e-4)
    tlv = tl.trajloss(cfg, _t(GOLD["q0"]), _t(GOLD["p0"]), final.cost)
    np.testing.assert_allclose(float(tlv), float(GOLD[f"{tag}_trajloss_x"][0]), rtol=1e-3)


@pytest.mark.parametrize("route", [None, "kernel"])
def test_shoot_and_optimize_with_x0_match_jax(route):
    """shoot(x0=...) with its gradient, and optimize(x0=...), against the JAX
    package on a masked frame, on the dense route and on the kernel route
    (the kernels' plain versions here).  Shoot rtol 1e-5 and gradient 1e-4
    (float32 through five steps and their adjoints); optimize at 1e-3 on p0
    and 1e-4 on the losses."""
    rng = np.random.default_rng(8)
    q0 = tps.grid_support(FRAMES[0], 0.2)
    x0 = FRAMES[0]
    qmask = np.ones(q0.shape[0], np.float32)
    qmask[:3] = 0.0
    xmask = (rng.uniform(size=x0.shape[0]) > 0.1).astype(np.float32)
    p0 = (0.01 * rng.normal(size=q0.shape) * qmask[:, None]).astype(np.float32)
    y = (x0 + 0.02).astype(np.float32)
    cfg_j, cfg_t = _lcfg(jl), _lcfg(tl)

    def jloss(p):
        final, _ = jl.shoot(cfg_j, jnp.asarray(q0), p, jnp.asarray(x0),
                            jnp.asarray(qmask), jnp.asarray(xmask))
        return (jl.trajloss(cfg_j, jnp.asarray(q0), p, final.cost, jnp.asarray(qmask))
                + jnp.sum((final.x - y) ** 2)), final

    (lj, fj), gj = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(p0))
    dl_j = jl.quad_dataloss(jnp.asarray(y), 2.0)
    rj = jl.optimize(cfg_j, dl_j, jnp.asarray(q0), jnp.asarray(p0), jnp.asarray(x0),
                     jnp.asarray(qmask), jnp.asarray(xmask), nmax=2, inner=5)

    TB.set_backend(route)
    try:
        p = _t(p0)[None].requires_grad_(True)
        final, _ = tl.shoot(cfg_t, _t(q0)[None], p, _t(x0)[None], _t(qmask)[None],
                            _t(xmask)[None])
        lt = (tl.trajloss(cfg_t, _t(q0)[None], p, final.cost, _t(qmask)[None])
              + ((final.x - _t(y)[None]) ** 2).sum((-2, -1)))
        (gt,) = torch.autograd.grad(lt.sum(), p)
        rt = tl.optimize(cfg_t, tl.quad_dataloss(_t(y)[None], 2.0), _t(q0)[None],
                         _t(p0)[None], _t(x0)[None], _t(qmask)[None],
                         _t(xmask)[None], nmax=2, inner=5)
    finally:
        TB.set_backend(None)
    np.testing.assert_allclose(final.x[0].detach().numpy(), np.asarray(fj.x),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(lt[0].detach()), float(lj), rtol=1e-5)
    scale = float(np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(gt[0].numpy(), np.asarray(gj), rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(float(rt.trajl[0] + rt.datal[0]),
                               float(rj.trajl + rj.datal), rtol=1e-4)
    np.testing.assert_allclose(rt.p0[0].numpy(), np.asarray(rj.p0), rtol=1e-3,
                               atol=1e-3 * float(np.abs(np.asarray(rj.p0)).max()))
    np.testing.assert_allclose(rt.final.x[0].numpy(), np.asarray(rj.final.x),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("version", ["pinv", "ridge", "ridge_cg"])
def test_v2p_matches_golden_and_jax(version):
    """v2p against the JAX package's own solves and, for pinv, the
    torch-reference golden.  The solve is ill-conditioned, so as
    tests/test_lddmm.py does, the effect is compared (the speeds the momenta
    produce), relative to the largest speed: 1e-4 for pinv against JAX, 5e-3
    for the ridge solves (K + 1e-4 I has a condition number near 1e4, so
    float32 solves in two libraries part at ~1e-7 x 1e4); the golden at
    tests/test_lddmm.py's 5e-2 / 5e-3; then the round trip v2p(v(p))
    reproduces v(p) at that file's 1e-2 / 1e-3."""
    cfg_t, cfg_j = (m.make_config(sigma=0.4, lambd=3.0, version="classic")
                    for m in (tl, jl))
    q, vt = GOLD["q0"], GOLD["v2p_v"]
    qt = _t(q)[None]

    def speeds(p):
        return tl.v(cfg_t, qt, qt, _t(p)[None] if isinstance(p, np.ndarray) else p)[0].numpy()

    got = tl.v2p(cfg_t, qt, _t(vt)[None], version=version)[0].numpy()
    ref = np.asarray(jl.v2p(cfg_j, jnp.asarray(q), jnp.asarray(vt), version=version))
    v_ref = speeds(ref)
    tol = 1e-4 if version == "pinv" else 5e-3
    np.testing.assert_allclose(speeds(got), v_ref, rtol=0, atol=tol * np.abs(v_ref).max())
    if version == "pinv":
        np.testing.assert_allclose(speeds(got), speeds(GOLD["v2p_p"]), rtol=5e-2, atol=5e-3)
    p = _t(np.random.default_rng(0).normal(size=q.shape) * 0.1)[None]
    v0 = tl.v(cfg_t, qt, qt, p)
    p2 = tl.v2p(cfg_t, qt, v0, rcond=1e-6, version=version)
    np.testing.assert_allclose(tl.v(cfg_t, qt, qt, p2).numpy(), v0.numpy(), rtol=1e-2,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# DiffPSR with grid support, stepwise and run()
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_grid_fes():
    psr = _jax_psr()
    fes = _iterate(psr, 2)
    assert psr.fe_increase_events == 0
    return fes, np.asarray(psr.q0)


@pytest.mark.parametrize("route", [None, "kernel"])
def test_diffpsr_grid_fe_sequence_matches_jax(jax_grid_fes, route):
    """Two outer iterations of GMM_opt + Reg_opt with grid support, three
    frames, on the dense route and on the kernel route (the kernels' plain
    versions on the CPU): the same grid, the same FE sequence, monotone,
    every data point covered."""
    fes_j, q0_j = jax_grid_fes
    TB.set_backend(route)
    try:
        psr = _torch_psr()
        np.testing.assert_array_equal(psr.q0.numpy(), q0_j)
        fes = _iterate(psr, 2)
    finally:
        TB.set_backend(None)
    assert psr.fe_increase_events == 0
    np.testing.assert_allclose(fes, fes_j, rtol=FE_RTOL)
    assert np.all(np.diff(fes) <= 1e-4 * np.abs(fes[:-1]) + 1e-6)
    unc = psr.last_reg_stats["uncovered"]
    assert unc.shape == (3, 6) and int(unc.sum()) == 0
    x1 = psr.get_warped_data_points(2)
    assert x1.shape == FRAMES[2].shape and np.isfinite(x1).all()
    np.testing.assert_array_equal(psr.get_data_points(1), FRAMES[1])


def test_run_matches_jax_run():
    """DiffPSR.run (the fused loop's semantics as a Python loop) against the
    JAX package's compiled run(): the same per-iteration FE sequence."""
    kw = dict(max_em=10, em_tol=1e-3, reg_nmax=2, reg_tol=1e-3, reg_inner=5, reg_ls=12)
    jpsr, tpsr = _jax_psr(), _torch_psr()
    fes_j = jpsr.run(3, **kw)
    fes_t = tpsr.run(3, **kw)
    assert fes_t.shape == (3,)
    assert tpsr.fe_increase_events == 0 and jpsr.fe_increase_events == 0
    np.testing.assert_allclose(fes_t, fes_j, rtol=FE_RTOL)
    np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=FE_RTOL)
    # a second call continues from the threaded line-search state
    np.testing.assert_allclose(tpsr.run(1, **kw), jpsr.run(1, **kw), rtol=FE_RTOL)


def test_registration_apply_backward_matches_jax():
    """The Registration handle of frame 1 after two iterations: apply and
    backward against the JAX package's on the same momenta (loaded through
    utils/convert), and backward(apply(x)) ~ x up to the Euler error."""
    jpsr = _jax_psr()
    _iterate(jpsr, 2)
    tpsr = _torch_psr()
    tpsr.a0 = _t(np.asarray(jpsr.a0))
    pts = SPIRAL["x5"][:30]
    jreg, treg = jpsr.Registration(1), tpsr.Registration(1)
    fj = np.asarray(jreg.apply(jnp.asarray(pts)))
    ft = treg.apply(pts).numpy()
    np.testing.assert_allclose(ft, fj, rtol=1e-5, atol=1e-6)
    bt = treg.backward(ft).numpy()
    np.testing.assert_allclose(bt, np.asarray(jreg.backward(jnp.asarray(fj))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bt, pts, atol=2e-2)
    traj = tpsr.trajectories(1)
    assert traj.shape == (6, tpsr.x0.shape[1], 2)
    np.testing.assert_allclose(traj[-1][: FRAMES[1].shape[0]],
                               np.asarray(jpsr.trajectories(1))[-1][: FRAMES[1].shape[0]],
                               rtol=1e-5, atol=1e-6)


def test_continue_from_jax_grid_state():
    """A JAX grid-support state after one iteration, loaded into a port
    DiffPSR built with dense support (utils/convert.load_psr_state carries
    the scheme, rho and the grid): one Reg_opt on each side gives the same
    free energy.  rtol 1e-4 on FE and 1e-2 on the momenta: two L-BFGS
    iterations on a flat objective, whose float32 line searches amplify the
    last-digit differences of two libraries' sums."""
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
    dense = TDiffPSR(FRAMES, state, _gcfg(tg), _lcfg(tl), device="cpu")
    dense.printstuff = False
    tpsr = load_psr_state(dense, arrays)
    assert tpsr.support_scheme == "grid" and tpsr.rho == 1.0
    assert tpsr.q0.shape == np.asarray(jpsr.q0).shape
    for psr in (jpsr, tpsr):
        psr.Reg_opt(tol=1e-3, nmax=1, inner=2, ls_steps=12)
    np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=1e-4)
    np.testing.assert_allclose(tpsr.a0.numpy(), np.asarray(jpsr.a0), rtol=0,
                               atol=1e-2 * float(np.abs(np.asarray(jpsr.a0)).max()))
    np.testing.assert_array_equal(tpsr.last_reg_evals.numpy(),
                                  np.asarray(jpsr.last_reg_evals))
    back = psr_state_to_numpy(tpsr)
    assert back["support_scheme"] == "grid"
    np.testing.assert_array_equal(back["q0"], np.asarray(jpsr.q0))


# ---------------------------------------------------------------------------
# api entries with default numerical options (grid support)
# ---------------------------------------------------------------------------

def test_icp_two_set_default_options_matches_jax():
    """icp_two_set with default numerical_options (grid support, rho 1):
    the same final FE and GMM sigma as the JAX package, FE monotone."""
    kw = dict(
        GMM_parameters={"sigma": 0.2, "optimize_sigma": True},
        registration_parameters={"type": "diffeomorphic", "sigma_LDDMM": 0.3,
                                 "lambda_LDDMM": 2000.0},
        optim_options={"max_iterations": 2},
        printstuff=False,
    )
    x_a, x_b = SPIRAL["x1"], SPIRAL["x0"]
    jpsr, _ = j_icp_two_set(x_a, x_b, **kw)
    try:
        tpsr, evol = t_icp_two_set(x_a, x_b, device="cpu", **kw)
    finally:
        TB.set_backend(None)
    assert tpsr.support_scheme == "grid" == jpsr.support_scheme
    np.testing.assert_array_equal(tpsr.q0.numpy(), np.asarray(jpsr.q0))
    assert tpsr.fe_increase_events == 0 and jpsr.fe_increase_events == 0
    np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=FE_RTOL)
    np.testing.assert_allclose(float(tpsr.gmm[0].sigma), float(jpsr.gmm[0].sigma),
                               rtol=FE_RTOL)
    assert len(evol["a0"]) == 2


@pytest.mark.parametrize("init", [20, ("set", 0)])
def test_icp_atlas_matches_jax(init):
    """icp_atlas on three frames with default numerical options: an ad hoc
    init of 20 components (numpy-seeded re-initialization, as in JAX) and
    the ("set", 0) init; the same template, sigma and final FE."""
    kw = dict(
        GMM_parameters={"init_components": init},
        registration_parameters={"type": "diffeomorphic", "sigma_LDDMM": 0.2,
                                 "lambda_LDDMM": 500.0},
        numerical_options={"integration_nt_LDDMM": 5},
        optim_options={"max_iterations": 2},
        printstuff=False,
    )
    jpsr, _ = j_icp_atlas(FRAMES, **kw)
    try:
        tpsr, evol = t_icp_atlas(FRAMES, device="cpu", **kw)
    finally:
        TB.set_backend(None)
    assert tpsr.fe_increase_events == 0 and jpsr.fe_increase_events == 0
    np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=FE_RTOL)
    np.testing.assert_allclose(float(tpsr.gmm[0].sigma), float(jpsr.gmm[0].sigma),
                               rtol=FE_RTOL)
    np.testing.assert_allclose(tpsr.get_template(), np.asarray(jpsr.get_template()),
                               atol=FE_RTOL * float(np.abs(MU).max()))
    assert len(evol["GMMi"]) == 2
