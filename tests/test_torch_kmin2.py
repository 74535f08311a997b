"""The port's top-2 minimum op (difficp_torch/ops/kmin2.py) against the JAX
package: kmin2_pallas as the JAX package runs it on the CPU (interpret mode)
and the dense min_sqdist / second_min_sqdist, with exact ties; and the
backend routes that take kmin2 above the dense pair limit.

On the CPU the op takes the kernel's plain PyTorch version; the CUDA kernel is
checked against it on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from difficp_tpu.ops import reductions as R
from difficp_torch.ops import backend as TB
from difficp_torch.ops import kmin2 as K2

torch.set_num_threads(1)


def _cloud(n, m, seed, dup=True, d=2):
    """x (n, d) and y (m, d) on a coarse lattice, so equal distances (ties)
    are common, with exact duplicates in y and a ragged y mask."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 12, size=(m, d)).astype(np.float32) / 8.0
    if dup:
        y[m // 2: m // 2 + 20] = y[:20]
    x = rng.integers(0, 12, size=(n, d)).astype(np.float32) / 8.0
    my = (rng.uniform(size=m) > 0.15).astype(np.float32)
    return x, y, my


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("d", [2, 3])
def test_plain_matches_pallas_interpret(exclude_self, d):
    """(m1, m2) against kmin2_pallas (ti=64, tj=128 so several tiles) in
    interpret mode, both modes, with ties and duplicates: equal up to one
    rounding of the squares (rtol 1e-6)."""
    from difficp_tpu.ops.pallas_reductions import kmin2_pallas

    x, y, my = _cloud(150, 300, seed=d, d=d)
    if exclude_self:
        x = y
    r1, r2 = kmin2_pallas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(my),
                          exclude_self=exclude_self, ti=64, tj=128)
    m1, m2 = K2.kmin2(*_t(x, y, my), exclude_self=exclude_self)
    np.testing.assert_allclose(m1.numpy(), np.asarray(r1), rtol=1e-6)
    np.testing.assert_allclose(m2.numpy(), np.asarray(r2), rtol=1e-6)
    assert np.any(m1.numpy() == m2.numpy())  # the ties were exercised


def test_plain_matches_dense_min_and_second_min():
    """m1 is the dense min_sqdist; with self-exclusion m1 is the dense
    second_min_sqdist (the nearest neighbour other than the point)."""
    x, y, my = _cloud(90, 210, seed=5)
    m1, _ = K2.kmin2(*_t(x, y, my))
    np.testing.assert_allclose(
        m1.numpy(), np.asarray(R.min_sqdist(jnp.asarray(x), jnp.asarray(y), jnp.asarray(my))),
        rtol=1e-6)
    n1, _ = K2.kmin2(*_t(y, y, my), exclude_self=True)
    np.testing.assert_allclose(
        n1.numpy(), np.asarray(R.second_min_sqdist(jnp.asarray(y), jnp.asarray(my))),
        rtol=1e-6)


def test_leading_frames_are_independent():
    """All leading axes are frames: a (2, 3) batch gives what each frame
    gives alone (the coverage pass sends (nt + 1, K) trajectories as one
    call); a fully masked frame gives +inf."""
    sets = [_cloud(40, 70, seed=s) for s in range(6)]
    x = torch.as_tensor(np.stack([s[0] for s in sets]).reshape(2, 3, 40, 2))
    y = torch.as_tensor(np.stack([s[1] for s in sets]).reshape(2, 3, 70, 2))
    my = torch.as_tensor(np.stack([s[2] for s in sets]).reshape(2, 3, 70))
    my[1, 2] = 0.0
    m1, m2 = K2.kmin2(x, y, my)
    assert m1.shape == (2, 3, 40)
    for a in range(2):
        for b in range(3):
            o1, o2 = K2.kmin2(x[a, b], y[a, b], my[a, b])
            np.testing.assert_array_equal(m1[a, b].numpy(), o1.numpy())
            np.testing.assert_array_equal(m2[a, b].numpy(), o2.numpy())
    assert torch.isinf(m1[1, 2]).all() and torch.isinf(m2[1, 2]).all()


def test_backend_routes_through_kmin2():
    """Forced onto the kernel route, min_sqdist, second_min_sqdist and
    check_coverage (with a mask broadcast over leading frames) give the
    dense route's answers."""
    x, y, my = _cloud(60, 130, seed=8, dup=False)
    xt, yt, myt = _t(x, y, my)
    xb = torch.stack([xt, xt + 0.05, xt - 0.3])           # (3, 60, 2)
    yb = torch.stack([yt, yt, yt + 0.1])                  # (3, 130, 2)
    mx = torch.ones(60)
    try:
        dense = (TB.min_sqdist(xt, yt, myt), TB.second_min_sqdist(yt, myt),
                 TB.check_coverage(xb, yb, 0.1, 1.0, mx, myt))
        TB.set_backend("kernel")
        kern = (TB.min_sqdist(xt, yt, myt), TB.second_min_sqdist(yt, myt),
                TB.check_coverage(xb, yb, 0.1, 1.0, mx, myt))
    finally:
        TB.set_backend(None)
    np.testing.assert_allclose(kern[0].numpy(), dense[0].numpy(), rtol=1e-6)
    np.testing.assert_allclose(kern[1].numpy(), dense[1].numpy(), rtol=1e-6)
    np.testing.assert_array_equal(kern[2].numpy(), dense[2].numpy())
    assert kern[2].dtype == torch.bool and 0 < int(kern[2].sum()) < kern[2].numel()


def test_ops_per_pair_and_bad_input():
    assert K2.ops_per_pair(2) == 8 and K2.ops_per_pair(3) == 11
    x, y, my = _t(*_cloud(10, 12, seed=1, dup=False))
    with pytest.raises(ValueError, match="exclude_self"):
        K2.kmin2(x, y, my, exclude_self=True)
    with pytest.raises(ValueError):
        K2.kmin2(x.to("meta"), y.to("meta"), my.to("meta"))
