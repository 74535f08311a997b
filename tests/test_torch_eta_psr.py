"""The gradcomponent (eta != 0) model's registrations against the JAX
package: small DiffPSR runs with eta != 0 (grid and dense support, the
port's kernel route forced) against the JAX package's free energies, the
start momenta and the monotone-FE oracle, and a JAX eta state carried into
the port by utils/convert.

On the CPU the kernel route takes the kernels' plain PyTorch versions.  The
bound on free energies is the one the JAX package uses between two of its
own L-BFGS orderings (tests/test_psr_basic.py:104): relative 5e-3.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from difficp_tpu.models import gmm as jg
from difficp_tpu.models import lddmm as jl
from difficp_tpu.models.psr import DiffPSR as JDiffPSR
from difficp_torch.models import gmm as tg
from difficp_torch.models import lddmm as tl
from difficp_torch.models.psr import DiffPSR as TDiffPSR
from difficp_torch.ops import backend as TB
from difficp_torch.utils.convert import load_psr_state

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
SPIRAL = np.load(os.path.join(HERE, "goldens", "spiral.npz"))
FRAMES = [SPIRAL[f"x{k}"] for k in range(3)]
MU = SPIRAL["mu0"]
FE_RTOL = 5e-3


def _lcfg(mod):
    # lambda = 200 (eta = 1/200, the dense eta path's): at lambda = 100 the JAX
    # package's own dense-support run raises its free energy once here
    return mod.make_config(sigma=0.2, lambd=200.0, version="logdet", nt=5, scheme="Euler")


def _gcfg(mod):
    return mod.GMMConfig(optimize_mu=True, optimize_sigma=True, optimize_w=True,
                         optimize_eta0=False)


def _iterate(psr, n_iter):
    fes = []
    for _ in range(n_iter):
        psr.GMM_opt(max_iterations=10, tol=1e-3)
        fes.append(psr.FE)
        psr.Reg_opt(tol=1e-3, nmax=2, inner=5, ls_steps=12, carry_memory=True)
        fes.append(psr.FE)
    return np.asarray(fes)


def _jax_shoot_start(jpsr):
    """The port's start (DiffPSR._record_start) with the JAX package's own
    functions: x1 and regloss of the start momenta a0 from one shoot, then
    the targets and the free energy recomputed from them as a new baseline
    (the JAX package keeps x1 = x0 and regloss = 0 there)."""
    cfg, ext = jpsr.lcfg, jpsr.support_scheme is not None

    def one(q, a, x, mq, mx):
        final, _ = jl.shoot(cfg, q, a, x if ext else None, mq, mx if ext else None)
        return (final.x if ext else final.q), jl.trajloss(cfg, q, a, final.cost, mq)

    jpsr.x1, jpsr.regloss = jax.vmap(one)(jpsr.q0, jpsr.a0, jpsr.x0, jpsr.qmask,
                                          jpsr.xmask)
    jpsr.FE = None
    jpsr.update_GMM_targets()


def patch_jax_start(monkeypatch):
    """For one test, give the JAX package's DiffPSR the port's start: new
    momenta at eta != 0 (initialize_a0, update_a0) have their free energy
    recorded before the next GMM_opt, Reg_opt or run, as the port's DiffPSR
    does.  The JAX package's files are unchanged."""
    def setting(fn):
        def wrapped(self, *args, **kwargs):
            out = fn(self, *args, **kwargs)
            self._start_pending = self.lcfg.eta != 0.0
            return out
        return wrapped

    def recording(fn):
        def wrapped(self, *args, **kwargs):
            if getattr(self, "_start_pending", False):
                self._start_pending = False
                _jax_shoot_start(self)
            return fn(self, *args, **kwargs)
        return wrapped

    for name in ("initialize_a0", "update_a0"):
        monkeypatch.setattr(JDiffPSR, name, setting(getattr(JDiffPSR, name)))
    for name in ("GMM_opt", "Reg_opt", "run"):
        monkeypatch.setattr(JDiffPSR, name, recording(getattr(JDiffPSR, name)))


def _jax_psr(support, lcfg=_lcfg):
    state, _ = jg.create(jnp.asarray(MU), sigma=0.05)
    psr = JDiffPSR(FRAMES, state, _gcfg(jg), lcfg(jl))
    psr.printstuff = False
    if support == "grid":
        psr.set_support_scheme("grid", rho=1.0)
    return psr


@pytest.mark.parametrize("support", ["grid", "dense"])
def test_diffpsr_eta_fe_sequence_matches_jax(support, monkeypatch):
    """Two outer iterations of GMM_opt + Reg_opt at eta = 1/200 ("logdet"),
    three frames, grid or dense support, with the port's kernel route forced
    (the any-eta kernels and the generated backward, their plain versions
    here) against the JAX package from the same start state: the same start
    momenta, the same FE sequence within 5e-3, monotone."""
    patch_jax_start(monkeypatch)
    jpsr = _jax_psr(support)
    fes_j = _iterate(jpsr, 2)
    assert jpsr.fe_increase_events == 0
    TB.set_backend("kernel")
    try:
        state, _ = tg.create(MU, sigma=0.05)
        psr = TDiffPSR(FRAMES, state, _gcfg(tg), _lcfg(tl), device="cpu")
        psr.printstuff = False
        if support == "grid":
            psr.set_support_scheme("grid", rho=1.0)
        a0 = psr.a0.numpy()
        fes = _iterate(psr, 2)
    finally:
        TB.set_backend(None)
    assert np.abs(a0).max() > 0.0
    assert psr.fe_increase_events == 0
    np.testing.assert_allclose(fes, fes_j, rtol=FE_RTOL)
    assert np.all(np.diff(fes) <= 1e-4 * np.abs(fes[:-1]) + 1e-6)


def test_start_momenta_do_not_count_as_an_fe_increase(monkeypatch):
    """At eta != 0 the start momenta of initialize_a0 are not zero.  The JAX
    package records the free energy without their energy (regloss 0, x1 =
    x0) and, with dense support and lambda = 100, counts its first Reg_opt
    as an FE increase.  The port records the start's own free energy (one
    shoot of a0) before its first step: its FE sequence is the JAX package's
    from that same start (rtol 5e-3), and neither counts an increase."""
    def lcfg(mod):
        return mod.make_config(sigma=0.2, lambd=100.0, version="logdet", nt=5,
                               scheme="Euler")

    jpsr = _jax_psr("dense", lcfg)
    _iterate(jpsr, 1)
    assert jpsr.fe_increase_events == 1
    patch_jax_start(monkeypatch)
    jpsr = _jax_psr("dense", lcfg)
    fes_j = _iterate(jpsr, 1)
    assert jpsr.fe_increase_events == 0
    state, _ = tg.create(MU, sigma=0.05)
    psr = TDiffPSR(FRAMES, state, _gcfg(tg), lcfg(tl), device="cpu")
    psr.printstuff = False
    assert float(psr.regloss.abs().max()) == 0.0
    psr.GMM_opt(max_iterations=10, tol=1e-3)
    assert float(psr.regloss.abs().min()) > 0.0
    fes = [psr.FE]
    psr.Reg_opt(tol=1e-3, nmax=2, inner=5, ls_steps=12, carry_memory=True)
    np.testing.assert_allclose(fes + [psr.FE], fes_j, rtol=FE_RTOL)
    assert psr.fe_increase_events == 0


def test_continue_from_jax_eta_state(monkeypatch):
    """A JAX eta state after one iteration (grid support), loaded into a port
    DiffPSR by utils/convert.load_psr_state with nothing new: the momenta and
    the GMM carry over as at eta = 0.  The same free energy, and a shoot from
    the carried momenta gives the same trajectory loss (rtol 1e-5: one
    shoot's float32 sums); one Reg_opt on each side then ends within 5e-3
    (the bound between two L-BFGS orderings)."""
    patch_jax_start(monkeypatch)
    jpsr = _jax_psr("grid")
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
    tpsr = TDiffPSR(FRAMES, state, _gcfg(tg), _lcfg(tl), device="cpu")
    tpsr.printstuff = False
    tpsr = load_psr_state(tpsr, arrays)
    np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=1e-6)
    cfg_t, cfg_j = _lcfg(tl), _lcfg(jl)
    final, _ = tl.shoot(cfg_t, tpsr.q0, tpsr.a0, tpsr.x0, tpsr.qmask, tpsr.xmask)
    trajl = tl.trajloss(cfg_t, tpsr.q0, tpsr.a0, final.cost, tpsr.qmask)
    for k in range(len(FRAMES)):
        args = [jnp.asarray(getattr(jpsr, n)[k]) for n in ("q0", "a0", "x0", "qmask", "xmask")]
        jfinal, _ = jl.shoot(cfg_j, *args)
        jtrajl = jl.trajloss(cfg_j, args[0], args[1], jfinal.cost, args[3])
        np.testing.assert_allclose(float(trajl[k]), float(jtrajl), rtol=1e-5)
        np.testing.assert_allclose(final.x[k].numpy(), np.asarray(jfinal.x), rtol=1e-5,
                                   atol=1e-6)
    for psr in (jpsr, tpsr):
        psr.Reg_opt(tol=1e-3, nmax=1, inner=2, ls_steps=12)
    np.testing.assert_allclose(tpsr.FE, jpsr.FE, rtol=FE_RTOL)
