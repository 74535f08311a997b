"""The CUDA kernels of difficp_torch/csrc/rhs_self.cu on the card, against
their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has a card and no JAX.  From the repository root there:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets JAX up.)  Without a card
every test skips.
"""

import numpy as np
import pytest
import torch

from difficp_torch.models import lddmm
from difficp_torch.ops import backend
from difficp_torch.ops import rhs_self as RS

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

SIG = 0.1
# float32 pair sums taken in another order than the plain version, relative
# to the largest |plain| output (as chip_smoke.py)
TOL_FWD = 1e-5
TOL_BWD = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _inputs(b, m, d, seed, device):
    """Box cloud of side 1 (R / sigma = 10), ragged mask with a padded tail."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(size=(b, m, d))
    p = 0.05 * rng.normal(size=(b, m, d))
    mask = (rng.uniform(size=(b, m)) > 0.1).astype(np.float64)
    mask[:, -5:] = 0.0
    a = rng.normal(size=(b, m, d))
    gb = rng.normal(size=(b, m, d))
    c = rng.normal(size=(b,))
    return [torch.tensor(x, dtype=torch.float32, device=device)
            for x in (q, p, mask, a, gb, c)]


def _close(x, ref, tol):
    x, ref = x.double().cpu(), ref.double().cpu()
    err = float((x - ref).abs().max())
    scale = float(ref.abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("withlogdet", [True, False])
def test_kernels_match_plain(cuda, d, withlogdet):
    """Forward and backward kernels against the plain versions evaluated in
    float64 on the same float32 inputs, M = 3,001 (not a multiple of the
    block), masked."""
    q, p, m, a, b, c = _inputs(1, 3001, d, seed=d, device=cuda)
    v, w, dc = RS.rhs_self_fwd(q, p, m, SIG, withlogdet)
    dq, dp = RS.rhs_self_bwd(q, p, m, a, b, c, SIG, withlogdet)
    torch.cuda.synchronize()
    f64 = [t.double() for t in (q, p, m, a, b, c)]
    rv, rw, rdc = RS.rhs_self_fwd_reference(*f64[:3], SIG, withlogdet)
    rq, rp = RS.rhs_self_bwd_reference(*f64, SIG, withlogdet)
    _close(v, rv, TOL_FWD)
    _close(w, rw, TOL_FWD)
    # the dcost sum cancels: its error is relative to the sum of |partials|
    assert float((dc.double().sum() - rdc.sum()).abs()) <= TOL_FWD * float(
        rdc.abs().sum())
    _close(dq, rq, TOL_BWD)
    _close(dp, rp, TOL_BWD)
    assert bool((v[m == 0] == 0).all()) and bool((dq[m == 0] == 0).all())


def test_frames_are_independent(cuda):
    """A batch of three frames (one grid row each) gives what each frame
    gives alone."""
    q, p, m, a, b, c = _inputs(3, 1000, 2, seed=7, device=cuda)
    batch = RS.rhs_self_fwd(q, p, m, SIG, True) + RS.rhs_self_bwd(
        q, p, m, a, b, c, SIG, True)
    for k in range(3):
        one = RS.rhs_self_fwd(q[k:k + 1], p[k:k + 1], m[k:k + 1], SIG, True) + \
            RS.rhs_self_bwd(q[k:k + 1], p[k:k + 1], m[k:k + 1], a[k:k + 1],
                            b[k:k + 1], c[k:k + 1], SIG, True)
        for x, y in zip(batch, one):
            torch.testing.assert_close(x[k:k + 1], y, rtol=1e-6, atol=0.0)


def test_functions_on_card_match_cpu(cuda):
    """RHSSelf and Hamiltonian with autograd on the card against the same
    Functions on the CPU (the plain versions) in float64."""
    inputs = _inputs(2, 700, 3, seed=3, device=cuda)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        q, p, m, a, b, c = (t.to(dev).clone() if dev.type == "cuda"
                            else t.to(dev).double() for t in inputs)
        q.requires_grad_(True)
        p.requires_grad_(True)
        v, w, dcost = RS.RHSSelf.apply(q, p, m, SIG, True)
        h = RS.Hamiltonian.apply(q, p, m, SIG)
        loss = (v * a).sum() + (w * b).sum() + (c * dcost).sum() + h.sum()
        out[dev.type] = (v, w, dcost, h, *torch.autograd.grad(loss, (q, p)))
    for x, ref in zip(out["cuda"], out["cpu"]):
        _close(x.detach(), ref.detach(), TOL_BWD)


def test_launch_counters(cuda):
    """One count per kernel launch: RHSSelf runs the forward and the
    backward kernel once each; the Hamiltonian's gradient needs no kernel."""
    q, p, m, *_ = _inputs(1, 256, 2, seed=1, device=cuda)
    q.requires_grad_(True)
    p.requires_grad_(True)
    for key in RS.launches:
        RS.launches[key] = 0
    v, w, dcost = RS.RHSSelf.apply(q, p, m, SIG, True)
    torch.autograd.grad(v.sum() + w.sum() + dcost.sum(), (q, p))
    assert RS.launches == {"rhs_self_fwd": 1, "rhs_self_bwd": 1}
    torch.autograd.grad(RS.Hamiltonian.apply(q, p, m, SIG).sum(), (q, p))
    assert RS.launches == {"rhs_self_fwd": 2, "rhs_self_bwd": 1}


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, p, m, a, b, c = _inputs(1, 64, 2, seed=2, device=cuda)
    with pytest.raises(ValueError):
        RS.rhs_self_fwd(q.double(), p.double(), m.double(), SIG, True)
    with pytest.raises(ValueError):
        RS.rhs_self_fwd(q.transpose(-1, -2).contiguous().transpose(-1, -2), p, m,
                        SIG, True)
    with pytest.raises(ValueError):
        RS.rhs_self_fwd(q, p, m[..., :-1], SIG, True)
    with pytest.raises(ValueError):
        RS.rhs_self_bwd(q, p, m, a, b, c.cpu(), SIG, True)
    q4 = torch.zeros((1, 64, 4), device=cuda)
    with pytest.raises(ValueError):
        RS.rhs_self_fwd(q4, q4, m, SIG, True)


@pytest.mark.parametrize("scheme", ["Euler", "Ralston"])
def test_shoot_kernel_route_matches_dense_on_card(cuda, scheme):
    """Geodesic shooting and its gradient on the card: the kernel route
    against the dense route, M = 500, hybrid (logdet on)."""
    q0, p0, m, *_ = _inputs(1, 500, 2, seed=5, device=cuda)
    cfg = lddmm.make_config(sigma=SIG, lambd=200.0, version="hybrid", nt=5,
                            scheme=scheme)
    res = {}
    try:
        for mode in ("kernel", "dense"):
            backend.set_backend(mode)
            p = p0.clone().requires_grad_(True)
            final, _ = lddmm.shoot(cfg, q0, p, None, m)
            loss = (lddmm.trajloss(cfg, q0, p, final.cost, m).sum()
                    + (final.q ** 2).sum())
            res[mode] = (final.q, final.p, final.cost, loss,
                         torch.autograd.grad(loss, p)[0])
    finally:
        backend.set_backend(None)
    for x, ref in zip(res["kernel"], res["dense"]):
        _close(x.detach(), ref.detach(), TOL_BWD)
