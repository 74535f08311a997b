"""The standard algorithm's DiffPSRStd in the port against the JAX package:
data_distance on both routes, Reg_opt and Template_opt from the same state
for dense, grid (with template weights) and decim support, the state carried
both ways, and the port's own invariants of tests/test_standard_scale.py.

The registration problem is tests/test_standard_scale.py's (2 frames of 40
points, a template of 25, sigma_LDDMM 0.5, lambda 200, classic, nt = 4): a
well-conditioned one, where a perturbation of the start momenta by 1e-6
moves the energies by at most 5e-4.  (On 40-point spirals at sigma_LDDMM
0.25 and lambda 2, the API's Deformetrica setting, dense support is chaotic
in float32: the same perturbation moves the energy after one alternation by
9% in either package, so no sequence there compares beyond its first step.)

Tolerances: data_distance and its gradients within 1e-5 of the largest
reference entry (float32 sums in another order); the energy after each step
within 5e-3 relative of the JAX package's, the bound the JAX package uses
between two of its own orderings (tests/test_psr_basic.py:104), and the
increase events equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difficp_tpu.models import lddmm as JL
from difficp_tpu.models import psr_standard as JS
from difficp_torch.models import lddmm as TL
from difficp_torch.models import psr_standard as TS
from difficp_torch.ops import backend as TB
from difficp_torch.utils.convert import load_std_state, std_state_to_numpy

torch.set_num_threads(1)

E_RTOL = 5e-3
RTOL = 1e-5
STEP = dict(nmax=2, tol=1e-4)
# support scheme, template weights
CONFIGS = {"dense": (None, False), "grid_weights": ("grid", True), "decim": ("decim", False)}


def _sets(seed=3, k=2, n=40, ny=25):
    rng = np.random.default_rng(seed)
    x = [rng.normal(size=(n, 2)).astype(np.float32) * 0.5 for _ in range(k)]
    y = rng.normal(size=(ny, 2)).astype(np.float32) * 0.5
    return x, y


def build(jax_side, support=None, weights=False):
    """tests/test_standard_scale.py's _make_psr in either package."""
    x, y = _sets()
    mod, lmod = (JS, JL) if jax_side else (TS, TL)
    lcfg = lmod.make_config(sigma=0.5, lambd=200.0, version="classic", nt=4)
    kw = {} if jax_side else {"device": "cpu"}
    psr = mod.DiffPSRStd(x, y, noise_std=0.2, lcfg=lcfg, data_sigma=0.3,
                         template_weights=weights, **kw)
    psr.printstuff = False
    if support is not None:
        psr.set_support_scheme(support, rho=1.0)
    return psr


def _host(a):
    return None if a is None else np.array(a)


def jax_state(p):
    """A JAX DiffPSRStd's state in the form ``load_std_state`` reads."""
    def lanes(name):
        v = getattr(p, name, None)
        return None if v is None else [_host(a) for a in v]

    mem = getattr(p, "_reg_memory", None)
    return {"y0": [_host(a) for a in p.y0],
            "w0": [_host(a) for a in p.w0] if p.template_weights else None,
            "q0": _host(p.q0), "a0": _host(p.a0), "y1": _host(p.y1),
            "support_scheme": p.support_scheme, "rho": p.rho,
            "_reg_alpha": _host(getattr(p, "_reg_alpha", None)),
            "_reg_alpha_qn": _host(getattr(p, "_reg_alpha_qn", None)),
            "_tmpl_alpha": lanes("_tmpl_alpha"), "_tmpl_alpha_qn": lanes("_tmpl_alpha_qn"),
            "_reg_memory": None if mem is None else {f: _host(getattr(mem, f))
                                                     for f in mem._fields},
            "regloss": p.regloss, "dataloss": p.dataloss, "E": p.E}


@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_steps(request):
    """One alternation of the JAX package from its start: for each step its
    name, the state before it, the energy and increase events after it."""
    support, weights = CONFIGS[request.param]
    psr = build(True, support, weights)
    steps = []
    for name in ("Reg_opt", "Template_opt"):
        before = jax_state(psr)
        getattr(psr, name)(**STEP)
        steps.append((name, before, psr.E, psr.e_increase_events, jax_state(psr)))
    return request.param, steps


def test_steps_match_jax(jax_steps):
    """The port's set-up energy and support, then each step from the JAX
    package's state before it: the energy within E_RTOL and the increase
    events equal; after Template_opt the template within 1e-3 of the JAX
    one, and with template_weights the weights within 1e-2 of the largest
    (two outer L-BFGS steps in float32 over 75 parameters: 5e-3 apart where
    the energies are 2e-4 apart)."""
    config, steps = jax_steps
    support, weights = CONFIGS[config]
    psr = build(False, support, weights)
    start = steps[0][1]
    np.testing.assert_allclose(psr.E, start["E"], rtol=1e-5)
    np.testing.assert_allclose(psr.q0.numpy(), start["q0"], atol=1e-6)
    for name, before, e_after, events, after in steps:
        psr = build(False, support, weights)
        load_std_state(psr, before)
        getattr(psr, name)(**STEP)
        assert abs(psr.E - e_after) <= E_RTOL * abs(e_after), (config, name, psr.E, e_after)
        assert psr.e_increase_events == events
    assert psr.support_scheme == support
    # the last step was Template_opt
    np.testing.assert_allclose(psr.y0[0].numpy(), after["y0"][0], atol=1e-3)
    if weights:
        np.testing.assert_allclose(psr.w0[0].numpy(), after["w0"][0],
                                   atol=1e-2 * np.abs(after["w0"][0]).max())
    np.testing.assert_allclose(psr.q0.numpy(), after["q0"], atol=1e-3)


def test_data_distance_routes_match_jax():
    """data_distance (masked data, weighted template) on the dense route and
    on the kernel route (KRed's plain version), two frames in one call,
    against the JAX package's dense route frame by frame: the value and its
    gradients in y and w; skip_xx drops exactly <fx, fx>."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 60, 2)).astype(np.float32)
    y = rng.normal(size=(2, 45, 2)).astype(np.float32)
    mx = np.stack([(np.arange(60) < n).astype(np.float32) for n in (50, 60)])
    w = (rng.uniform(0.5, 1.5, size=45) / 45).astype(np.float32)
    want, gy, gw = [], [], []
    for k in range(2):
        fn = lambda yy, ww: JS.data_distance(jnp.asarray(x[k]), yy, 0.4, w=ww,  # noqa: E731
                                             mask_x=jnp.asarray(mx[k]))
        val, (dy, dw) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(y[k]),
                                                               jnp.asarray(w))
        want.append(float(val))
        gy.append(np.asarray(dy))
        gw.append(np.asarray(dw))
    for mode in ("dense", "kernel"):
        yt = torch.tensor(y, requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        TB.set_backend(mode)
        try:
            got = TS.data_distance(torch.tensor(x), yt, 0.4, w=wt, mask_x=torch.tensor(mx))
            part = TS.data_distance(torch.tensor(x), yt, 0.4, w=wt,
                                    mask_x=torch.tensor(mx), skip_xx=True)
            xx = TS.data_distance(torch.tensor(x), yt, 0.4, w=wt, mask_x=torch.tensor(mx)) - part
        finally:
            TB.set_backend(None)
        dy, dw = torch.autograd.grad(got.sum(), [yt, wt])
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=RTOL)
        for k in range(2):
            scale = np.abs(gy[k]).max()
            np.testing.assert_allclose(dy[k].numpy(), gy[k], rtol=0, atol=RTOL * scale)
        dw_want = gw[0] + gw[1]  # w is shared by the frames
        np.testing.assert_allclose(dw.numpy(), dw_want, rtol=0,
                                   atol=RTOL * np.abs(dw_want).max())
        # the dropped term is <fx, fx>, independent of y and w
        wx = torch.tensor(mx) / torch.tensor(mx).sum(-1, keepdim=True)
        fxfx = (wx * TB.kred_scal(torch.tensor(x), torch.tensor(x), wx, 0.4)).sum(-1)
        np.testing.assert_allclose(xx.detach().numpy(), fxfx.numpy(), rtol=1e-5, atol=1e-6)


def test_state_round_trip():
    """std_state_to_numpy then load_std_state gives the same state and the
    same next step, bit for bit, with a curvature memory carried."""
    a = build(False, "grid", True)
    a.Reg_opt(nmax=1, tol=1e-3, carry_memory=True)
    a.Template_opt(nmax=1, tol=1e-3, carry_memory=True)
    state = std_state_to_numpy(a)
    b = load_std_state(build(False, "grid", True), state)
    again = std_state_to_numpy(b)
    for key, val in state.items():
        if isinstance(val, list):
            for u, v in zip(val, again[key]):
                if isinstance(u, dict):
                    for f in u:
                        np.testing.assert_array_equal(u[f], v[f])
                else:
                    np.testing.assert_array_equal(u, v)
        elif isinstance(val, dict):
            for f in val:
                np.testing.assert_array_equal(val[f], again[key][f])
        else:
            np.testing.assert_array_equal(val, again[key])
    a.Reg_opt(nmax=1, tol=1e-3, carry_memory=True)
    b.Reg_opt(nmax=1, tol=1e-3, carry_memory=True)
    assert a.E == b.E
    np.testing.assert_array_equal(a.a0.numpy(), b.a0.numpy())


def test_skip_xx_is_exactly_the_constant():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(30, 2)), dtype=torch.float32)
    ys = [torch.tensor(rng.normal(size=(20, 2)), dtype=torch.float32) for _ in range(2)]
    diffs = [float(TS.data_distance(x, y, 0.3) - TS.data_distance(x, y, 0.3, skip_xx=True))
             for y in ys]
    assert abs(diffs[0] - diffs[1]) < 1e-6


def test_cached_dataloss_equals_eager():
    """The cached <fx, fx> plus the batched y-dependent terms equal the
    eager data_distance of each (k, s), after a few monotone steps with the
    inner / line-search knobs."""
    psr = build(False)
    for _ in range(2):
        psr.Reg_opt(nmax=1, tol=1e-3, inner=4, ls_steps=12)
        psr.Template_opt(nmax=1, tol=1e-3, inner=4, ls_steps=12)
    assert psr.e_increase_events == 0
    eager = np.array([[psr._dataloss_ks(k, s) for s in range(psr.S)] for k in range(psr.K)])
    np.testing.assert_allclose(psr.dataloss, eager, rtol=1e-4, atol=1e-6)


def test_carry_memory_and_value():
    """carry_memory persists across Reg_opt calls and is dropped when the
    dense support moves with the template; carry_value threads the entry
    (value, grad) until the template moves; the energy stays monotone."""
    psr = build(False)
    psr.Reg_opt(nmax=1, tol=1e-3, inner=3, ls_steps=8, carry_memory=True)
    assert psr._reg_memory is not None and int(psr._reg_memory.count[0]) > 0
    assert psr._reg_vg is not None
    psr.Reg_opt(nmax=1, tol=1e-3, inner=3, ls_steps=8, carry_memory=True, carry_value=True)
    psr.Template_opt(nmax=1, tol=1e-3, inner=3, ls_steps=8)
    assert psr._reg_memory is None and psr._reg_vg is None  # dense support moved
    assert psr.e_increase_events == 0


def test_fused_run_zero_iters_and_energy():
    """run(0) returns an empty (0, 2) sequence; run's E equals update_E's on
    the state it leaves; decim support refuses run."""
    psr = build(False)
    assert psr.run(0).shape == (0, 2)
    psr.run(1, reg_nmax=2, tmpl_nmax=2)
    e_run = psr.E
    psr.update_datalosses()
    psr.E = None
    psr.update_E()
    assert abs(psr.E - e_run) < 1e-3 * max(1.0, abs(e_run))
    with pytest.raises(ValueError, match="decim"):
        build(False, "decim").run(1)
