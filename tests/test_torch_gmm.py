"""The port's GMM EM (difficp_torch/models/gmm.py) against the JAX package's
em_step (dense and tiled E step) and the torch-reference goldens
(tests/goldens/gmm.npz, as tests/test_gmm.py uses them)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from difficp_tpu.models import gmm as jg
from difficp_torch.models import gmm as tg

torch.set_num_threads(1)

G = np.load(os.path.join(os.path.dirname(__file__), "goldens", "gmm.npz"))


def _fields(use_out):
    return dict(mu=G["mu0"], w=G["w0"], sigma=np.float32(G["sigma0"]),
                eta0=np.float32(-1.0 if use_out else 0.0),
                vol0=np.float32(G["out_vol0"] if use_out else 0.0))


def _states(use_out, **cfg_kw):
    f = _fields(use_out)
    js = jg.GMMState(**{k: jnp.asarray(v, jnp.float32) for k, v in f.items()})
    ts = tg.GMMState(**{k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in f.items()})
    return js, jg.GMMConfig(use_outliers=use_out, **cfg_kw), ts, tg.GMMConfig(
        use_outliers=use_out, **cfg_kw)


def _compare(out_t, out_j, rtol):
    for name in ("mu", "w", "sigma", "eta0"):
        np.testing.assert_allclose(getattr(out_t.state, name).numpy(),
                                   np.asarray(getattr(out_j.state, name)),
                                   rtol=rtol, atol=rtol)
    np.testing.assert_allclose(out_t.y.numpy(), np.asarray(out_j.y), rtol=rtol, atol=rtol)
    np.testing.assert_allclose(out_t.gamt.numpy(), np.asarray(out_j.gamt), rtol=rtol, atol=rtol)
    np.testing.assert_allclose(float(out_t.cfe), float(out_j.cfe), rtol=rtol)
    np.testing.assert_allclose(float(out_t.fe), float(out_j.fe), rtol=rtol)


@pytest.mark.parametrize("use_out", [False, True])
@pytest.mark.parametrize("skip_m", [False, True])
@pytest.mark.parametrize("tile", [None, 16])
def test_em_step_matches_jax(use_out, skip_m, tile):
    """Dense and tiled E step, masked, with and without the outlier
    component; rtol 1e-5 (float32 sums of the same terms in two orders)."""
    rng = np.random.default_rng(1)
    x = G["x"].astype(np.float32)
    mask = (rng.uniform(size=x.shape[0]) > 0.2).astype(np.float32)
    js, jc, ts, tc = _states(use_out)
    out_j = jg.em_step(js, jnp.asarray(x), jnp.asarray(mask), jc, skip_m=skip_m, tile=tile)
    out_t = tg.em_step(ts, torch.as_tensor(x), torch.as_tensor(mask), tc, skip_m=skip_m,
                       tile=tile)
    _compare(out_t, out_j, 1e-5)


def test_tiled_route_above_pair_limit_matches_dense():
    """Above DENSE_PAIR_LIMIT the E step streams tiles; same result."""
    from difficp_torch.ops import backend as TB

    js, jc, ts, tc = _states(False)
    x = torch.as_tensor(G["x"].astype(np.float32))
    dense = tg.em_step(ts, x, None, tc)
    keep = TB.DENSE_PAIR_LIMIT
    try:
        TB.DENSE_PAIR_LIMIT = 10
        tiled = tg.em_step(ts, x, None, tc)
    finally:
        TB.DENSE_PAIR_LIMIT = keep
    for a, b in zip((tiled.y, tiled.state.mu, tiled.fe), (dense.y, dense.state.mu, dense.fe)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_out", [False, True])
def test_values_match_golden(use_out):
    """skip-M values and the M step against the torch reference
    (tolerances of tests/test_gmm.py)."""
    tag = "out" if use_out else "noout"
    _, _, ts, tc = _states(use_out)
    x = torch.as_tensor(G["x"])
    out = tg.em_step(ts, x, None, tc, skip_m=True)
    np.testing.assert_allclose(out.y.numpy(), G[f"{tag}_skipM_Y"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(out.cfe), float(G[f"{tag}_skipM_Cfe"]), rtol=2e-4)
    np.testing.assert_allclose(float(out.fe), float(G[f"{tag}_skipM_FE"]), rtol=2e-4)
    out = tg.em_step(ts, x, None, tc)
    np.testing.assert_allclose(out.state.mu.numpy(), G[f"{tag}_M_mu"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(out.state.sigma), float(G[f"{tag}_M_sigma"]), rtol=2e-4)
    lpi = torch.log_softmax(out.state.w, 0).numpy()
    wg = G[f"{tag}_M_w"]
    np.testing.assert_allclose(lpi, wg - np.log(np.exp(wg).sum()), rtol=2e-3, atol=2e-4)
    if use_out:
        np.testing.assert_allclose(float(out.state.eta0), float(G[f"{tag}_M_eta0"]),
                                   rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(out.y.numpy(), G[f"{tag}_M_Y"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("use_out", [False, True])
def test_em_iterations_track_golden(use_out):
    tag = "out" if use_out else "noout"
    _, _, state, cfg = _states(use_out)
    x = torch.as_tensor(G["x"])
    fes = []
    for _ in range(20):
        out = tg.em_step(state, x, None, cfg)
        state = out.state
        fes.append(float(out.fe))
    # Cfe's Gaussian-norm part at the updated sigma (see tests/test_gmm.py)
    np.testing.assert_allclose(fes[-1], G[f"{tag}_FE_seq"][-1], rtol=5e-3)
    np.testing.assert_allclose(state.mu.numpy(), G[f"{tag}_final_mu"], rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(float(state.sigma), float(G[f"{tag}_final_sigma"]), rtol=1e-3)
    fes = np.asarray(fes)
    assert np.all(fes[1:] <= fes[:-1] + 1e-3 * np.abs(fes[:-1]) + 1e-4)


def test_em_optimization_matches_jax():
    """The iterated EM stops after the same number of steps as the JAX
    while_loop, at the same state."""
    js, jc, ts, tc = _states(False)
    x = G["x"].astype(np.float32)
    for tol in (1e-2, 1e-4):
        oj = jg.em_optimization(js, jnp.asarray(x), None, jc, 100, tol)
        ot = tg.em_optimization(ts, torch.as_tensor(x), None, tc, 100, tol)
        assert ot.n_iters == int(oj.n_iters)
        np.testing.assert_allclose(float(ot.fe), float(oj.fe), rtol=1e-5)
        np.testing.assert_allclose(ot.state.mu.numpy(), np.asarray(oj.state.mu),
                                   rtol=1e-4, atol=1e-5)


def test_create_and_vol0_match_jax():
    mu = G["mu0"].astype(np.float32)
    sj, _ = jg.create(jnp.asarray(mu))
    st, _ = tg.create(mu)
    np.testing.assert_allclose(float(st.sigma), float(sj.sigma), rtol=1e-6)
    x = G["x"].astype(np.float32)
    mask = (np.arange(x.shape[0]) % 3 > 0).astype(np.float32)
    np.testing.assert_allclose(
        float(tg.bbox_volume(torch.as_tensor(x), torch.as_tensor(mask))),
        float(jg.bbox_volume(jnp.asarray(x), jnp.asarray(mask))), rtol=1e-6)
