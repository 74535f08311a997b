"""The port's lane-batched L-BFGS (difficp_torch/utils/lbfgs.py) against the
JAX package's lbfgs_optimize, and the threading contracts of
tests/test_round3_fixes.py, test_round4_fixes.py and test_round5_fixes.py.

Lanes are the leading axis: a single problem is one lane, params (1, n) and
per-lane losses (1,)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from difficp_tpu.utils import lbfgs as jlb
from difficp_torch.utils.lbfgs import lbfgs_optimize, zero_memory

torch.set_num_threads(1)


def _quad_problem(n=24, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    a = (a @ a.T + np.diag(np.linspace(1.0, 200.0, n))).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    return a, b


def _torch_quad(a, b, counter=None):
    A, B = torch.as_tensor(a), torch.as_tensor(b)

    def loss(p):
        if counter is not None:
            counter[0] += 1
        return 0.5 * ((p @ A) * p).sum(-1) - p @ B

    return loss


@pytest.mark.parametrize("nmax,inner", [(1, 6), (3, 4)])
def test_iterates_match_jax_on_quadratic(nmax, inner):
    """Same iterates, loss, step counts and threaded scales as the JAX
    optimizer on a stiff quadratic; rtol 1e-5 (float32 in two orders)."""
    a, b = _quad_problem()
    rj = jlb.lbfgs_optimize(
        lambda p: 0.5 * p @ jnp.asarray(a) @ p - jnp.asarray(b) @ p,
        jnp.zeros(24), nmax=nmax, inner=inner, tol=0.0)
    rt = lbfgs_optimize(_torch_quad(a, b), torch.zeros((1, 24)), nmax=nmax,
                        inner=inner, tol=0.0)
    np.testing.assert_allclose(rt.params[0].numpy(), np.asarray(rj.params),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(rt.loss[0]), float(rj.loss), rtol=1e-5)
    assert int(rt.n_steps[0]) == int(rj.n_steps)
    assert int(rt.n_evals[0]) == int(rj.n_evals)
    assert float(rt.alpha[0]) == pytest.approx(float(rj.alpha), rel=1e-5)
    assert float(rt.alpha_qn[0]) == pytest.approx(float(rj.alpha_qn), rel=1e-5)
    assert int(rt.memory.count[0]) == int(rj.memory.count)


def test_iterates_match_jax_on_lddmm_loss():
    """The registration objective of one frame (hybrid LDDMM shoot + a
    quadratic data term) through both optimizers, warm state threaded over
    two calls as Reg_opt does; rtol 1e-4 on the loss and momenta."""
    from difficp_tpu.models import lddmm as jl
    from difficp_torch.models import lddmm as tl

    rng = np.random.default_rng(4)
    q = rng.uniform(size=(40, 2)).astype(np.float32)
    y = (q + 0.05 * np.sin(4 * q[:, ::-1])).astype(np.float32)
    cj = jl.make_config(sigma=0.2, lambd=50.0, version="hybrid", nt=5, scheme="Euler")
    ct = tl.make_config(sigma=0.2, lambd=50.0, version="hybrid", nt=5, scheme="Euler")
    rj = rt = None
    for _ in range(2):
        rj = jl.optimize(cj, lambda pts: 50.0 * jnp.sum((pts - y) ** 2), jnp.asarray(q),
                         jnp.zeros_like(jnp.asarray(q)) if rj is None else rj.p0,
                         nmax=1, inner=3, alpha0=None if rj is None else rj.alpha,
                         alpha_qn0=None if rj is None else rj.alpha_qn,
                         memory0=jlb.zero_memory(80) if rj is None else rj.memory)
        rt = tl.optimize(ct, lambda pts: 50.0 * ((pts - torch.as_tensor(y)) ** 2).sum((-2, -1)),
                         torch.as_tensor(q)[None],
                         torch.zeros((1, 40, 2)) if rt is None else rt.p0,
                         nmax=1, inner=3, alpha0=None if rt is None else rt.alpha,
                         alpha_qn0=None if rt is None else rt.alpha_qn,
                         memory0=zero_memory(1, 80) if rt is None else rt.memory)
        np.testing.assert_allclose(float(rt.trajl[0] + rt.datal[0]),
                                   float(rj.trajl + rj.datal), rtol=1e-4)
        assert int(rt.n_evals[0]) == int(rj.n_evals)
    np.testing.assert_allclose(rt.p0[0].numpy(), np.asarray(rj.p0), rtol=1e-3, atol=1e-5)


def test_lockstep_lanes_equal_single_lanes():
    """Two lanes with different problems in one call (K = 2) give each lane's
    single-lane result: a finished lane is frozen while the other searches."""
    probs = [_quad_problem(seed=1), _quad_problem(seed=2)]
    A = torch.as_tensor(np.stack([p[0] for p in probs]))
    B = torch.as_tensor(np.stack([p[1] for p in probs]))

    def loss2(p):
        return 0.5 * (torch.einsum("kn,knm->km", p, A) * p).sum(-1) - (p * B).sum(-1)

    joint = lbfgs_optimize(loss2, torch.zeros((2, 24)), nmax=2, inner=5, tol=0.0)
    for k, (a, b) in enumerate(probs):
        single = lbfgs_optimize(_torch_quad(a, b), torch.zeros((1, 24)), nmax=2,
                                inner=5, tol=0.0)
        np.testing.assert_allclose(joint.params[k].numpy(), single.params[0].numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert int(joint.n_evals[k]) == int(single.n_evals[0])
        assert float(joint.alpha[k]) == pytest.approx(float(single.alpha[0]), rel=1e-6)


def test_memory_threading_matches_single_long_call():
    """Chained short calls with threaded memory == one long call; fresh-memory
    chaining stalls on a stiff quadratic (test_round3_fixes.py)."""
    scales = torch.as_tensor(np.logspace(0, 6, 50), dtype=torch.float32)

    def loss(p):
        return 0.5 * (scales * p * p).sum(-1)

    p0 = torch.ones((1, 50))
    r_long = lbfgs_optimize(loss, p0, nmax=1, inner=40, tol=0.0)
    p, a, mem = p0, None, zero_memory(1, 50)
    for _ in range(10):
        r = lbfgs_optimize(loss, p, nmax=1, inner=4, tol=0.0, alpha0=a, memory0=mem)
        p, a, mem = r.params, r.alpha, r.memory
    assert float(r.loss[0]) == pytest.approx(float(r_long.loss[0]), rel=1e-6)
    p, a = p0, None
    for _ in range(10):
        rf = lbfgs_optimize(loss, p, nmax=1, inner=4, tol=0.0, alpha0=a)
        p, a = rf.params, rf.alpha
    assert float(rf.loss[0]) > 2.0 * float(r_long.loss[0])


def test_zoom_accepts_seed_overshoot_within_budget():
    kappa = 1e6

    def loss(p):
        return 0.5 * kappa * (p * p).sum(-1)

    seed = 0.5
    res = lbfgs_optimize(loss, torch.ones((1, 2)), nmax=1, inner=1, tol=0.0,
                         max_linesearch_steps=12, alpha0=seed)
    assert float(res.loss[0]) < 0.5 * kappa * 2 * 0.9
    assert float(res.alpha[0]) < seed / 16.0
    assert float(res.alpha[0]) > seed / 4096.0 - 1e-12


def _chain(loss, n, ncalls, thread_vg):
    p, a, mem = torch.zeros((1, n)), None, zero_memory(1, n)
    v = g = None
    results = []
    for _ in range(ncalls):
        r = lbfgs_optimize(loss, p, nmax=1, inner=3, tol=0.0, alpha0=a, memory0=mem,
                           value0=v if thread_vg else None,
                           grad0=g if thread_vg else None)
        p, a, mem = r.params, r.alpha, r.memory
        if thread_vg:
            v, g = r.loss, r.grad
        results.append(r)
    return results


def test_vg_threading_identical_trajectory_one_fewer_eval_per_call():
    """value0/grad0 threading == the unthreaded chain exactly, one entry
    evaluation saved per threaded call (test_round4_fixes.py)."""
    a, b = _quad_problem()
    cnt = [0]
    loss = _torch_quad(a, b, cnt)
    plain = _chain(loss, 24, 4, thread_vg=False)
    evals_plain, cnt[0] = cnt[0], 0
    threaded = _chain(loss, 24, 4, thread_vg=True)
    assert cnt[0] == evals_plain - 3
    for rp, rt in zip(plain, threaded):
        np.testing.assert_array_equal(rp.params.numpy(), rt.params.numpy())
        assert float(rp.loss[0]) == float(rt.loss[0])
        assert float(rp.alpha[0]) == float(rt.alpha[0])


def test_grad_result_is_gradient_at_params_and_vg_checks():
    a, b = _quad_problem()
    loss = _torch_quad(a, b)
    r = lbfgs_optimize(loss, torch.ones((1, 24)), nmax=1, inner=4, tol=0.0)
    x = r.params.clone().requires_grad_(True)
    (g_true,) = torch.autograd.grad(loss(x).sum(), x)
    np.testing.assert_allclose(r.grad.numpy(), g_true.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        lbfgs_optimize(loss, torch.ones((1, 24)), value0=torch.ones(1))
    with pytest.raises(ValueError):
        lbfgs_optimize(lambda p: (loss(p), ()), torch.ones((1, 24)), has_aux=True,
                       value0=torch.ones(1), grad0=torch.ones((1, 24)))


def test_stall_threading_skips_all_work():
    """A stalled-in lane makes ZERO evaluations and keeps its entry state
    (test_round5_fixes.py); a stalled lane beside a live one stays frozen."""
    def f(x):
        return ((x - 0.5) ** 2).sum(-1)

    x0 = torch.zeros((1, 4))
    res = lbfgs_optimize(f, x0, nmax=3, inner=5, stall0=torch.tensor([True]))
    assert int(res.n_evals[0]) == 0
    np.testing.assert_array_equal(res.params.numpy(), x0.numpy())
    assert bool(res.stalled[0])
    res2 = lbfgs_optimize(f, x0, nmax=3, inner=5, stall0=torch.tensor([False]))
    assert float(res2.loss[0]) < 1e-8
    both = lbfgs_optimize(f, torch.zeros((2, 4)), nmax=3, inner=5,
                          stall0=torch.tensor([True, False]))
    assert int(both.n_evals[0]) == 0 and int(both.n_evals[1]) > 0
    np.testing.assert_array_equal(both.params[0].numpy(), np.zeros(4, np.float32))
    assert float(both.loss[1]) < 1e-8


def test_stalled_flag_set_when_no_step_found():
    def g(x):
        return -x.sum(-1) + torch.where(x.abs().amax(-1) > 1e-12, torch.inf, 0.0)

    res = lbfgs_optimize(g, torch.zeros((1, 4)), nmax=1, inner=1,
                         max_linesearch_steps=3, alpha0=0.5)
    assert bool(res.stalled[0])
    res_c = lbfgs_optimize(g, torch.zeros((1, 4)), nmax=1, inner=1,
                           max_linesearch_steps=3)
    assert not bool(res_c.stalled[0])
    assert float(res_c.alpha[0]) < 0.01

    def f(x):
        return ((x - 5.0) ** 2).sum(-1)

    res2 = lbfgs_optimize(f, torch.zeros((1, 4)), nmax=1, inner=1,
                          max_linesearch_steps=20)
    assert not bool(res2.stalled[0])


def test_alpha_qn_contracts():
    """No collapse near convergence; adapts on a stiff objective; untouched
    by budget-fallback steps (test_round5_fixes.py)."""
    def quad(x):
        return ((x - 0.5) ** 2).sum(-1)

    res = lbfgs_optimize(quad, torch.zeros((1, 4)), nmax=6, inner=10,
                         max_linesearch_steps=12)
    assert float(res.loss[0]) < 1e-10
    assert float(res.alpha_qn[0]) == 1.0

    def barrier(x):
        return -torch.log(1.0 - x).sum(-1) + 50.0 * (x * x).sum(-1)

    res = lbfgs_optimize(barrier, torch.zeros((1, 4)) + 0.01, nmax=1, inner=1,
                         max_linesearch_steps=20)
    assert float(res.alpha_qn[0]) < 0.1

    def g(x):
        return -x.sum(-1) + torch.where(x.abs().amax(-1) > 1e-12, torch.inf, 0.0)

    res = lbfgs_optimize(g, torch.zeros((1, 4)), nmax=1, inner=1, max_linesearch_steps=3)
    assert float(res.alpha_qn[0]) == 1.0


def test_linesearch_guards():
    """Aberrant bracketing trial, divergent seed back-off and NaN-cliff
    recovery (test_round5_fixes.py, test_round4_fixes.py, test_lddmm.py)."""
    def spike(x):
        v = x[:, 0]
        return (v - 1.0) ** 2 + torch.where(v > 2.0, 1e12, 0.0)

    res = lbfgs_optimize(spike, torch.zeros((1, 1)), nmax=2, inner=8,
                         max_linesearch_steps=12, errthresh=1e6)
    assert np.isfinite(float(res.loss[0]))
    assert 0.0 < float(res.params[0, 0]) <= 2.0
    assert float(res.loss[0]) < 1.0

    scale = 1e4

    def quartic(p):
        t = (p * p).sum(-1)
        quart = (scale * t) ** 2
        return torch.where(quart > 1e6, torch.nan, scale * t + quart)

    p0 = torch.full((1, 8), 3e-4)
    res = lbfgs_optimize(quartic, p0, nmax=1, inner=2, tol=0.0, max_linesearch_steps=8)
    assert float(res.loss[0]) < float(quartic(p0)[0]) - 1e-6
    assert float(res.alpha[0]) > 0.0

    def nasty(p):
        lv = ((p - 0.3) ** 2).sum(-1)
        return torch.where(lv < 1.0, lv, torch.nan)

    p0 = torch.zeros((1, 8))
    res = lbfgs_optimize(nasty, p0, nmax=4, inner=5, tol=1e-6)
    assert np.isfinite(float(res.loss[0]))
    assert torch.isfinite(res.params).all()
    assert float(res.loss[0]) <= float(nasty(p0)[0])
