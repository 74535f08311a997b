"""The port's LDDMM shooting (difficp_torch/models/lddmm.py and
utils/integrators.py) against the JAX package and the torch-reference goldens
(tests/goldens/lddmm.npz, as tests/test_lddmm.py uses them)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from difficp_tpu.models import lddmm as jl
from difficp_torch.models import lddmm as tl
from difficp_torch.ops import backend as TB

torch.set_num_threads(1)

GOLD = np.load(os.path.join(os.path.dirname(__file__), "goldens", "lddmm.npz"))
Q0 = GOLD["q0"]
P0 = GOLD["p0"]


def cfg_for(mod, version, scheme, nt=10):
    return mod.make_config(sigma=0.4, lambd=3.0, version=version, nt=nt,
                           scheme=scheme)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("version", ["classic", "logdet", "hybrid"])
def test_hamiltonian_matches_golden(version):
    h = tl.hamiltonian(cfg_for(tl, version, "Euler"), _t(Q0), _t(P0))
    np.testing.assert_allclose(float(h), float(GOLD[f"{version}_Euler_H"]), rtol=2e-4)


@pytest.mark.parametrize("version", ["classic", "logdet", "hybrid"])
@pytest.mark.parametrize("scheme", ["Euler", "Ralston"])
def test_shoot_matches_golden(version, scheme):
    """Support-only shoot (the x1 goldens need external points, which come
    with the grid-support slice); tolerances of tests/test_lddmm.py."""
    cfg = cfg_for(tl, version, scheme)
    tag = f"{version}_{scheme}"
    final, _ = tl.shoot(cfg, _t(Q0), _t(P0))
    np.testing.assert_allclose(final.q.numpy(), GOLD[f"{tag}_q1"], rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(final.p.numpy(), GOLD[f"{tag}_p1"], rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(float(final.cost), float(GOLD[f"{tag}_cost1"]),
                               rtol=1e-3, atol=2e-4)
    tlv = tl.trajloss(cfg, _t(Q0), _t(P0), final.cost)
    np.testing.assert_allclose(float(tlv), float(GOLD[f"{tag}_trajloss"]), rtol=1e-3)


@pytest.mark.parametrize("version", ["classic", "hybrid"])
@pytest.mark.parametrize("scheme", ["Euler", "Ralston"])
def test_shoot_and_gradient_match_jax(version, scheme):
    """shoot, trajloss and dL/dp0 through the shoot against the JAX package
    (jax.grad through its scan), masked; rtol 1e-5 on the state, 1e-4 on the
    gradient (float32 through ten time steps and their adjoints)."""
    rng = np.random.default_rng(7)
    m = 48
    q = rng.normal(size=(m, 2)).astype(np.float32) * 0.6
    p = rng.normal(size=(m, 2)).astype(np.float32) * 0.2
    mask = (rng.uniform(size=m) > 0.2).astype(np.float32)
    p = p * mask[:, None]
    target = (q + 0.1).astype(np.float32)
    cj, ct = cfg_for(jl, version, scheme), cfg_for(tl, version, scheme)

    def jloss(p_):
        final, _ = jl.shoot(cj, jnp.asarray(q), p_, None, jnp.asarray(mask))
        return (jl.trajloss(cj, jnp.asarray(q), p_, final.cost, jnp.asarray(mask))
                + jnp.sum((final.q - target) ** 2)), final

    (lj, fj), gj = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(p))

    pt = _t(p).requires_grad_(True)
    final, _ = tl.shoot(ct, _t(q), pt, None, _t(mask))
    lt = (tl.trajloss(ct, _t(q), pt, final.cost, _t(mask))
          + ((final.q - _t(target)) ** 2).sum())
    (gt,) = torch.autograd.grad(lt, pt)
    np.testing.assert_allclose(final.q.detach().numpy(), np.asarray(fj.q), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(final.p.detach().numpy(), np.asarray(fj.p), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(final.cost), float(fj.cost), rtol=1e-5, atol=1e-6)
    # the loss is a sum of terms of either sign: compare at their scale
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5,
                               atol=1e-5 * abs(float(fj.cost)) + 1e-5)
    scale = float(np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-4 * scale)


def test_kernel_route_matches_dense_shoot():
    """The same shoot and gradient through the kernel Functions (their plain
    versions on the CPU) as through the dense route; rtol 1e-5."""
    cfg = cfg_for(tl, "hybrid", "Ralston")
    tgt = _t(Q0 + 0.05)

    def run():
        pt = _t(P0).requires_grad_(True)
        final, _ = tl.shoot(cfg, _t(Q0), pt)
        loss = tl.trajloss(cfg, _t(Q0), pt, final.cost) + ((final.q - tgt) ** 2).sum()
        return loss.detach(), torch.autograd.grad(loss, pt)[0]

    l_dense, g_dense = run()
    TB.set_backend("kernel")
    try:
        l_kern, g_kern = run()
    finally:
        TB.set_backend(None)
    np.testing.assert_allclose(float(l_kern), float(l_dense), rtol=1e-5)
    scale = float(g_dense.abs().max())
    np.testing.assert_allclose(g_kern.numpy(), g_dense.numpy(), rtol=1e-5, atol=1e-5 * scale)


def test_grad_through_shoot_matches_fd():
    """autograd through the Python time loop vs central finite differences,
    in float64 (the port's ops take any float dtype on the CPU)."""
    cfg = tl.make_config(sigma=0.4, lambd=3.0, version="logdet", nt=5, scheme="Euler")
    q0 = torch.as_tensor(Q0, dtype=torch.float64)
    p0 = torch.as_tensor(P0, dtype=torch.float64)
    y_t = q0 + 0.05

    def loss(p):
        final, _ = tl.shoot(cfg, q0, p)
        return tl.trajloss(cfg, q0, p, final.cost) + ((final.q - y_t) ** 2).sum()

    pg = p0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(pg), pg)
    rng = np.random.default_rng(2)
    for _ in range(3):
        dp = torch.as_tensor(rng.normal(size=P0.shape))
        eps = 1e-5
        fd = (float(loss(p0 + eps * dp)) - float(loss(p0 - eps * dp))) / (2 * eps)
        an = float((g * dp).sum())
        assert abs(fd - an) < 1e-6 * max(1.0, abs(an))


def test_masked_shoot_equals_subset():
    cfg = cfg_for(tl, "hybrid", "Ralston")
    rng = np.random.default_rng(1)
    mask = (rng.uniform(size=Q0.shape[0]) > 0.3).astype(np.float32)
    idx = np.nonzero(mask)[0]
    f_m, _ = tl.shoot(cfg, _t(Q0), _t(P0 * mask[:, None]), None, _t(mask))
    f_s, _ = tl.shoot(cfg, _t(Q0[idx]), _t(P0[idx]))
    np.testing.assert_allclose(f_m.q.numpy()[idx], f_s.q.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(f_m.cost), float(f_s.cost), rtol=1e-4, atol=1e-5)
    h_m = tl.hamiltonian(cfg, _t(Q0), _t(P0 * mask[:, None]), _t(mask))
    h_s = tl.hamiltonian(cfg, _t(Q0[idx]), _t(P0[idx]))
    np.testing.assert_allclose(float(h_m), float(h_s), rtol=1e-5)


def test_batched_frames_shoot_like_single_frames():
    """Frames on a leading axis shoot independently (the lockstep lanes)."""
    cfg = cfg_for(tl, "hybrid", "Euler")
    q = torch.stack([_t(Q0), _t(Q0) + 0.3])
    p = torch.stack([_t(P0), 0.5 * _t(P0)])
    fb, traj = tl.shoot(cfg, q, p, save_traj=True)
    assert traj.q.shape == (cfg.nt + 1,) + tuple(q.shape)
    for k in range(2):
        fk, _ = tl.shoot(cfg, q[k], p[k])
        np.testing.assert_allclose(fb.q[k].numpy(), fk.q.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(fb.cost[k]), float(fk.cost), rtol=1e-6)


def test_optimize_matches_jax():
    """One frame of lddmm.optimize (L-BFGS over the shoot) against the JAX
    package, ten quasi-Newton iterations: the same evaluation count and loss
    within rtol 1e-4.  (Further on, float32 rounding in two orders flips a
    line-search branch on this stiff logdet loss and the paths part.)"""
    cfg_j = jl.make_config(sigma=0.5, lambd=1.0, version="hybrid", nt=6, scheme="Euler")
    cfg_t = tl.make_config(sigma=0.5, lambd=1.0, version="hybrid", nt=6, scheme="Euler")
    target = (Q0 + np.asarray([0.3, -0.2], np.float32)).astype(np.float32)
    rj = jl.optimize(cfg_j, lambda pts: 10.0 * jnp.sum((pts - target) ** 2),
                     jnp.asarray(Q0), jnp.zeros_like(jnp.asarray(Q0)), nmax=1,
                     inner=10, tol=1e-4)
    rt = tl.optimize(cfg_t, lambda pts: 10.0 * ((pts - _t(target)) ** 2).sum((-2, -1)),
                     _t(Q0)[None], torch.zeros((1,) + Q0.shape), nmax=1, inner=10,
                     tol=1e-4)
    np.testing.assert_allclose(float(rt.datal[0] + rt.trajl[0]),
                               float(rj.datal + rj.trajl), rtol=1e-4)
    np.testing.assert_allclose(rt.p0[0].numpy(), np.asarray(rj.p0), rtol=1e-3, atol=1e-4)
    assert int(rt.n_evals[0]) == int(rj.n_evals)
    assert float(rt.alpha[0]) == pytest.approx(float(rj.alpha), rel=1e-5)
    assert float(rt.datal[0]) < 0.5 * float(10.0 * ((Q0 - target) ** 2).sum())


def test_seed_alpha_and_quad_dataloss_match_jax():
    """The quadratic landmark dataloss and the line-search seed
    min(1, 1/||g0||) derived from it, against the JAX package; rtol 1e-5
    (one float32 shoot and its gradient)."""
    target = (Q0 + np.asarray([0.3, -0.2], np.float32)).astype(np.float32)
    cfg_j, cfg_t = cfg_for(jl, "hybrid", "Euler"), cfg_for(tl, "hybrid", "Euler")
    dl_j, dl_t = jl.quad_dataloss(jnp.asarray(target), 4.0), tl.quad_dataloss(
        _t(target)[None], 4.0)
    np.testing.assert_allclose(float(dl_t(_t(Q0)[None])[0]),
                               float(dl_j(jnp.asarray(Q0))), rtol=1e-6)
    aj = jl.seed_alpha(cfg_j, dl_j, jnp.asarray(Q0), jnp.asarray(P0))
    at = tl.seed_alpha(cfg_t, dl_t, _t(Q0)[None], _t(P0)[None])
    assert at.shape == (1,)
    np.testing.assert_allclose(float(at[0]), float(aj), rtol=1e-5)
    assert 0.0 < float(at[0]) < 1.0


def test_external_points_not_ported():
    with pytest.raises(NotImplementedError):
        tl.shoot(cfg_for(tl, "hybrid", "Euler"), _t(Q0), _t(P0), _t(Q0))
