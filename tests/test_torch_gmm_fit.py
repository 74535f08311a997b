"""The rest of the GMM module: ``fit``, ``sample``, ``log_likelihoods``,
``likelihoods`` and ``symm_kl_div`` of the port against the JAX package on
the same inputs.  torch cannot reproduce ``jax.random``, so the JAX side's
draws (fit's start indices, the samples) are handed to the port.

Tolerances: a fit is float32 EM steps from the same start, summed in another
order: centroids and sigma within 1e-4 relative (2e-5 absolute), the
log-scores within 1e-3 absolute.  The fits run a fixed 30 steps (tol = 0),
except the default one: with a tolerance, a step whose FE change lies within
float32 rounding of tol * |FE| stops one package and not the other (this
happens with optimize_w at key 3, 24 against 25 steps), which compares
stopping rules, not fits.  The log-likelihoods are one float32
logsumexp: within 1e-5 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difficp_tpu.models import gmm as jg
from difficp_torch.models import gmm as tg

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
G = np.load(os.path.join(HERE, "goldens", "gmm.npz"))
SPIRAL = np.load(os.path.join(HERE, "goldens", "spiral.npz"))


def _states(use_out):
    """The JAX GMM test's state (tests/test_gmm.py make_state) in both
    packages."""
    fields = dict(mu=G["mu0"], w=G["w0"], sigma=np.float32(G["sigma0"]),
                  eta0=np.float32(-1.0 if use_out else 0.0),
                  vol0=np.float32(G["out_vol0"] if use_out else 0.0))
    j = jg.GMMState(**{k: jnp.asarray(v) for k, v in fields.items()})
    t = tg.GMMState(**{k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in fields.items()})
    return j, t


def _close_state(t, j, rtol=1e-4, atol=2e-5):
    np.testing.assert_allclose(t.mu.numpy(), np.asarray(j.mu), rtol=rtol, atol=atol)
    np.testing.assert_allclose(t.w.numpy(), np.asarray(j.w), atol=1e-3)
    np.testing.assert_allclose(float(t.sigma), float(j.sigma), rtol=rtol)
    np.testing.assert_allclose(float(t.eta0), float(j.eta0), rtol=rtol, atol=atol)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("use_outliers,optimize_w,fixed_sigma",
                         [(False, False, None), (False, True, None), (True, True, None),
                          (False, True, 0.03)])
def test_fit_matches_jax_with_its_indices(masked, use_outliers, optimize_w, fixed_sigma):
    x = np.concatenate([SPIRAL["x0"], SPIRAL["x1"]])
    n, c = x.shape[0], 12
    key = jax.random.PRNGKey(3)
    mask = None
    if masked:
        mask = (np.random.default_rng(0).uniform(size=n) > 0.2).astype(np.float32)
        idx = jax.random.choice(key, n, (c,), p=jnp.asarray(mask / mask.sum()))
    else:
        idx = jax.random.randint(key, (c,), 0, n)
    kw = dict(fixed_sigma=fixed_sigma, optimize_w=optimize_w, use_outliers=use_outliers,
              max_iterations=30, tol=0.0)
    js, jcfg = jg.fit(jnp.asarray(x), c, key, None if mask is None else jnp.asarray(mask), **kw)
    ts, tcfg = tg.fit(torch.as_tensor(x), c, mask=None if mask is None else torch.as_tensor(mask),
                      idx=np.array(idx), **kw)
    assert tcfg == tg.GMMConfig(*jcfg)
    _close_state(ts, js)
    if fixed_sigma is not None:
        assert float(ts.sigma) == pytest.approx(fixed_sigma)


def test_fit_matches_jax_with_default_options():
    x = SPIRAL["x2"]
    key = jax.random.PRNGKey(0)
    idx = np.asarray(jax.random.randint(key, (10,), 0, x.shape[0]))
    js, _ = jg.fit(jnp.asarray(x), 10, key)
    ts, _ = tg.fit(torch.as_tensor(x), 10, idx=idx)
    _close_state(ts, js)


def test_fit_draws_from_the_generator():
    """Without indices, the start is drawn from the generator: the same seed
    gives the same fit, and only masked points are drawn."""
    x = torch.as_tensor(SPIRAL["x0"])
    fits = [tg.fit(x, 8, torch.Generator().manual_seed(5)) for _ in range(2)]
    np.testing.assert_array_equal(fits[0][0].mu.numpy(), fits[1][0].mu.numpy())
    mask = torch.zeros(x.shape[0])
    mask[:4] = 1.0
    st, _ = tg.fit(x, 6, torch.Generator().manual_seed(1), mask=mask, max_iterations=0)
    assert all(any(torch.equal(m, p) for p in x[:4]) for m in st.mu)


@pytest.mark.parametrize("use_out", [False, True])
def test_log_likelihoods_and_symm_kl_match_jax_on_its_samples(use_out):
    js, ts = _states(use_out)
    other_j = js._replace(mu=js.mu + 0.5, sigma=js.sigma * 1.3)
    other_t = ts._replace(mu=ts.mu + 0.5, sigma=ts.sigma * 1.3)
    xs = jg.sample(js, jax.random.PRNGKey(0), 700)
    ys = jg.sample(other_j, jax.random.PRNGKey(1), 700)
    for j_state, t_state in ((js, ts), (other_j, other_t)):
        for pts in (xs, ys):
            np.testing.assert_allclose(
                tg.log_likelihoods(t_state, torch.as_tensor(np.asarray(pts))).numpy(),
                np.asarray(jg.log_likelihoods(j_state, pts)), rtol=1e-5, atol=1e-5)
    # JAX draws its two sample sets from a split of its key
    kx, ky = jax.random.split(jax.random.PRNGKey(2))
    xs, ys = jg.sample(js, kx, 1000), jg.sample(other_j, ky, 1000)
    want = float(jg.symm_kl_div(js, other_j, jax.random.PRNGKey(2)))
    got = float(tg.symm_kl_div(ts, other_t, samples=(torch.as_tensor(np.asarray(xs)),
                                                      torch.as_tensor(np.asarray(ys)))))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sampling_and_loglik():
    """Mirror of tests/test_gmm.py::test_sampling_and_loglik."""
    _, state = _states(False)
    s = tg.sample(state, torch.Generator().manual_seed(0), 500)
    assert s.shape == (500, 2)
    assert torch.isfinite(tg.log_likelihoods(state, s)).all()
    # density integrates to ~1 over a grid (normalization check)
    g = np.linspace(-4, 4, 200, dtype=np.float32)
    xx, yy = np.meshgrid(g, g)
    pts = torch.as_tensor(np.stack([xx.ravel(), yy.ravel()], 1))
    integral = float(tg.likelihoods(state, pts).sum()) * (g[1] - g[0]) ** 2
    assert abs(integral - 1.0) < 2e-2


def test_sample_follows_the_mixture():
    """The sample's component shares follow softmax(w) and its spread sigma."""
    _, state = _states(False)
    state = state._replace(w=torch.tensor([0.0, 1.0, -1.0] + [-50.0] * (state.mu.shape[0] - 3)),
                           sigma=torch.tensor(1e-3))
    s = tg.sample(state, torch.Generator().manual_seed(4), 20000)
    near = ((s[:, None, :] - state.mu[None]) ** 2).sum(-1).argmin(1)
    shares = torch.bincount(near, minlength=state.mu.shape[0]).double() / s.shape[0]
    np.testing.assert_allclose(shares[:3].numpy(), torch.softmax(state.w.double(), 0)[:3].numpy(),
                               atol=0.015)


def test_symm_kl_positive():
    """Mirror of tests/test_gmm.py::test_symm_kl_positive."""
    _, state = _states(False)
    other = state._replace(mu=state.mu + 0.5)
    assert float(tg.symm_kl_div(state, other, torch.Generator().manual_seed(1))) > 0
