"""Prior sampling ``lddmm.random_p`` in the port: mirrors of the five tests
of tests/test_random_p.py (the RFF covariance, the rff_cg law against the
dense ridge law, masking, the dispatch above the pair limit, its warning),
and the dense 'svd' and 'ridge' versions against the JAX package's for the
same standard normals (torch cannot reproduce ``jax.random``; the JAX draws
are handed to the port).

Tolerances: the statistical bounds are the JAX tests' own; the dense roots
are float32 SVD / Cholesky factorizations of an ill-conditioned Gram matrix,
within 1e-3 of the largest |p| (the 'svd' pseudo-inverse root amplifies
rounding by up to rcond^-1/2 ~ 32).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difficp_tpu.models import lddmm as jl
from difficp_torch.models import lddmm as tl
from difficp_torch.ops import backend as TB
from difficp_torch.ops.solvers import rff_gaussian_field

torch.set_num_threads(1)


def _gram(q, sigma):
    d2 = np.sum((q[:, None, :] - q[None, :, :]) ** 2, axis=-1)
    return np.exp(-d2 / (2.0 * sigma**2))


def _q(m, seed):
    return torch.as_tensor(np.random.default_rng(seed).uniform(0, 1, size=(m, 2)),
                           dtype=torch.float32)


def test_rff_field_covariance_matches_gram():
    """Empirical covariance over many independent fields ~= K (the O(1/sqrt
    F) feature bias + O(1/sqrt S) sampling error), mean ~ 0."""
    m, sigma, n_samples, n_feat = 48, 0.35, 4096, 4096
    q = _q(m, 0)
    gen = torch.Generator().manual_seed(1)
    f = torch.cat([rff_gaussian_field(q.expand(256, m, 2), sigma, 1, n_feat, gen)[..., 0]
                   for _ in range(n_samples // 256)]).double().numpy()
    err = np.abs(f.T @ f / n_samples - _gram(q.double().numpy(), sigma)).max()
    assert err < 0.12, f"max |cov - K| = {err}"
    assert np.abs(f.mean(0)).max() < 0.1


def test_random_p_rff_cg_matches_ridge_covariance():
    """End to end: Cov(p_col) ~= (K + alpha I)^{-1} / lambda, the law of
    version='ridge' (frames on the leading axis, one CG per frame)."""
    m, sigma, alpha, lam = 40, 0.4, 0.05, 2.0
    q = _q(m, 1)
    cfg = tl.make_config(sigma=sigma, lambd=lam, version="classic", nt=5)
    gen = torch.Generator().manual_seed(2)
    p = torch.cat([tl.random_p(cfg, q.expand(256, m, 2), gen, alpha=alpha, version="rff_cg",
                               n_features=4096) for _ in range(16)]).double().numpy()
    cols = p.transpose(2, 0, 1).reshape(-1, m)  # both dims are iid draws
    cov = cols.T @ cols / cols.shape[0]
    cov_true = np.linalg.inv(_gram(q.double().numpy(), sigma) + alpha * np.eye(m)) / lam
    rel = np.abs(cov - cov_true).max() / np.abs(cov_true).max()
    assert rel < 0.08, f"relative covariance error = {rel}"


def test_random_p_rff_cg_masked_rows_zero_and_finite():
    m = 32
    mask = (torch.arange(m) < 20).float()
    cfg = tl.make_config(sigma=0.3, lambd=5.0, version="classic", nt=5)
    p = tl.random_p(cfg, _q(m, 2), torch.Generator().manual_seed(3), alpha=0.05,
                    version="rff_cg", qmask=mask, n_features=512)
    assert torch.isfinite(p).all()
    assert (p[20:] == 0.0).all()
    assert p[:20].abs().max() > 0.0


def test_random_p_large_m_dispatch(monkeypatch):
    """Above the dense pair limit: 'ridge' re-routes to rff_cg (no dense (M,
    M) anywhere; the CG matvec is the kernel route's kred, whose plain
    version runs on the CPU), 'svd' raises naming rff_cg."""
    m = 64
    q = _q(m, 3)
    cfg = tl.make_config(sigma=0.3, lambd=2.0, version="classic", nt=5)
    monkeypatch.setattr(TB, "DENSE_PAIR_LIMIT", 100)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        p = tl.random_p(cfg, q, torch.Generator().manual_seed(4), alpha=0.05,
                        version="ridge", n_features=256)
    assert torch.isfinite(p).all() and p.shape == (m, 2)
    with pytest.raises(ValueError, match="rff_cg"):
        tl.random_p(cfg, q, torch.Generator().manual_seed(4), version="svd")


def test_random_p_ridge_reroute_warns(monkeypatch):
    cfg = tl.make_config(sigma=0.3, lambd=2.0, version="classic", nt=5)
    monkeypatch.setattr(TB, "DENSE_PAIR_LIMIT", 100)
    with pytest.warns(UserWarning, match="rff_cg"):
        tl.random_p(cfg, _q(64, 5), torch.Generator().manual_seed(0), alpha=0.05,
                    version="ridge", n_features=128)


@pytest.mark.parametrize("version,kw", [("svd", {"rcond": 1e-3}), ("ridge", {"alpha": 10.0}),
                                        ("ridge", {"alpha": 1e-2})])
@pytest.mark.parametrize("masked", [False, True])
def test_dense_versions_match_jax_for_the_same_normals(version, kw, masked):
    m = 60
    q = np.random.default_rng(6).uniform(0, 1, size=(m, 2)).astype(np.float32)
    mask = (np.arange(m) < 47).astype(np.float32) if masked else None
    key = jax.random.PRNGKey(8)
    zeta = np.asarray(jax.random.normal(key, q.shape, jnp.float32))
    jcfg = jl.make_config(sigma=0.2, lambd=100.0, version="classic", nt=5)
    tcfg = tl.make_config(sigma=0.2, lambd=100.0, version="classic", nt=5)
    want = np.asarray(jl.random_p(jcfg, jnp.asarray(q), key, version=version,
                                  qmask=None if mask is None else jnp.asarray(mask), **kw))
    got = tl.random_p(tcfg, torch.as_tensor(q), version=version, zeta=torch.from_numpy(zeta.copy()),
                      qmask=None if mask is None else torch.as_tensor(mask), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())
    if masked:
        assert (got[47:] == 0.0).all()


def test_random_p_needs_eta_zero():
    cfg = tl.make_config(sigma=0.2, lambd=100.0, version="logdet")
    with pytest.raises(NotImplementedError):
        tl.random_p(cfg, _q(8, 0))
