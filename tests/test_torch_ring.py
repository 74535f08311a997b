"""The port's point-sharded ring and two-set step (difficp_torch/parallel/)
against the JAX package's on a 4-device mesh (``make_mesh(4, axis="points")``
on the virtual CPU devices).

The port's side runs as 4 gloo ranks: subprocesses of
tests/torch_ring_worker.py that import torch and the port only and meet
through a ``file://`` store in a temporary directory.  They run once for the
module; each test reads their results.  Held against the JAX package:
``ring_rhs_self`` (eta != 0), ``ring_rhs_ext``, ``ring_hamiltonian``,
``make_ring_shoot`` (Euler and Ralston) and two ``make_twoset_step`` calls on
tests/test_parallel_twoset.py's spiral set-up (and one port step from the JAX
package's state after its first).  The gradient of the 4-rank sharded loss is
held against the world-of-one ring's and the dense single-process loss's.
Also: ``em_step`` and ``lbfgs_optimize`` with a world-of-one group give bit
for bit what they give without one, and the process-group set-up.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from difficp_tpu.models import gmm as jgmm
from difficp_tpu.models import lddmm as jlddmm
from difficp_tpu.parallel import ring as jring
from difficp_tpu.parallel.atlas import make_mesh
from difficp_tpu.parallel.twoset import make_twoset_step, zero_twoset_memory
from difficp_torch.models import gmm as tgmm
from difficp_torch.models import lddmm as tlddmm
from difficp_torch.parallel import launch, make_sharded_reg_loss, shard_twoset
from difficp_torch.utils.convert import twoset_out_from_numpy
from difficp_torch.utils.lbfgs import lbfgs_optimize

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
WORLD = 4
AXIS = "points"


def _points(m, seed, scale=0.2):
    """tests/test_parallel_twoset.py's points: a masked normal cloud."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(m, 2)).astype(np.float32)
    p = rng.normal(size=(m, 2)).astype(np.float32) * scale
    mask = (rng.uniform(size=m) > 0.15).astype(np.float32)
    return q, p * mask[:, None], mask


def _close(x, ref, rtol):
    """|x - ref| <= rtol (|ref| + max|ref|): float32 sums in two orders."""
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(x, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _sharded(fn, n_in, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=make_mesh(WORLD, axis=AXIS),
                                 in_specs=(P(AXIS),) * n_in, out_specs=out_specs,
                                 check_vma=False))


def _twoset_start():
    """tests/test_parallel_twoset.py:119's start: three spiral sets, n a
    multiple of 8, zero momenta, the golden GMM moved by 0.01."""
    spiral = np.load(HERE / "goldens" / "spiral.npz")
    x_all = np.concatenate([spiral[f"x{k}"] for k in range(3)], 0)
    q0 = x_all[: (x_all.shape[0] // 8) * 8].astype(np.float32)
    gmm = {"mu": (spiral["mu0"] + 0.01).astype(np.float32), "w": np.zeros(20, np.float32),
           "sigma": np.float32(0.1), "eta0": np.float32(0.0), "vol0": np.float32(0.0)}
    return q0, np.ones(q0.shape[0], np.float32), gmm


def _jax_twoset(q0, mask, gmm):
    """Two JAX make_twoset_step calls (carry_memory) on the 4-device mesh:
    the state after each."""
    lcfg = jlddmm.make_config(sigma=0.2, lambd=500.0, version="hybrid", nt=3, scheme="Euler")
    mesh = make_mesh(WORLD, axis=AXIS)
    step = make_twoset_step(jgmm.GMMConfig(), lcfg, mesh, AXIS, em_iters=3, reg_nmax=1,
                            reg_inner=8, reg_ls=8, tol=1e-3, ring_tile=32, carry_memory=True)
    sh = NamedSharding(mesh, P(AXIS))
    q0j, maskj = jax.device_put(jnp.asarray(q0), sh), jax.device_put(jnp.asarray(mask), sh)
    st = jgmm.GMMState(**{k: jnp.asarray(v) for k, v in gmm.items()})
    a0 = jnp.zeros_like(q0j)
    outs, x1, al, mem = [], q0j, jnp.zeros((), jnp.float32), zero_twoset_memory(a0)
    for _ in range(2):
        out = step(st, q0j, a0, x1, maskj, al, mem)
        st, a0, x1, al, mem = out.gmm, out.a0, out.x1, out.alpha, out.memory
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def ring_run(tmp_path_factory):
    """Inputs, the JAX two-set steps and the 4 ranks' results (each rank's
    dict of numpy arrays)."""
    inp = {}
    for key, (m, seed) in {"self": (WORLD * 24, 0), "ham": (WORLD * 24, 4),
                           "shoot": (WORLD * 16, 1)}.items():
        inp[f"{key}_q"], inp[f"{key}_p"], inp[f"{key}_m"] = _points(m, seed)
    inp["shoot_m"] = np.ones_like(inp["shoot_m"])
    inp["ext_q"], inp["ext_p"], inp["ext_mq"] = _points(WORLD * 16, 2)
    inp["ext_x"], _, inp["ext_mx"] = _points(WORLD * 24, 3)
    inp.update(self_sigma=0.5, self_eta=0.05, ext_sigma=0.5, ham_sigma=0.4, ham_eta=0.03,
               shoot_sigma=0.5)
    # the registration loss at a non-zero momentum, with ragged weights
    rng = np.random.default_rng(7)
    lq, _, lmask = _points(WORLD * 20, 8)
    inp.update(loss_q0=lq, loss_mask=lmask, loss_sigma=0.5, loss_sig2=0.05,
               loss_a0=(0.05 * rng.normal(size=lq.shape)).astype(np.float32) * lmask[:, None],
               loss_y=(lq + 0.1 * rng.normal(size=lq.shape)).astype(np.float32),
               loss_w=rng.uniform(0.2, 1.0, size=lq.shape[0]).astype(np.float32))
    q0, mask, gmm = _twoset_start()
    inp.update(ts_q0=q0, ts_mask=mask, **{f"ts_gmm_{k}": v for k, v in gmm.items()})

    directory = tmp_path_factory.mktemp("ring")
    np.savez(directory / "inputs.npz", **inp)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_ring_worker.py"),
                               str(directory), str(r), str(WORLD)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    # the JAX steps while the ranks run; they read its first step's state
    # when they come to it
    try:
        outs = _jax_twoset(q0, mask, gmm)
        first = outs[0]
        state = dict(a0=np.asarray(first.a0), x1=np.asarray(first.x1),
                     alpha=np.asarray(first.alpha),
                     **{f"gmm_{f}": np.asarray(getattr(first.gmm, f))
                        for f in jgmm.GMMState._fields},
                     **{f"mem_{f}": np.asarray(getattr(first.memory, f))
                        for f in ("S", "Y", "rho", "pos", "count")})
        np.savez(directory / "jax_step1.tmp.npz", **state)
        os.replace(directory / "jax_step1.tmp.npz", directory / "jax_step1.npz")
    except BaseException:
        for proc in procs:
            proc.kill()
        raise
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=240)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    codes = [proc.returncode for proc in procs]
    assert codes == [0] * WORLD, "\n".join(f"rank {r}: rc {c}\n{log[-3000:]}"
                                           for r, (c, log) in enumerate(zip(codes, logs)))
    ranks = [dict(np.load(directory / f"out_{r}.npz")) for r in range(WORLD)]
    return inp, outs, ranks


def _rows(ranks, key):
    return np.concatenate([r[key] for r in ranks], 0)


def _replicated(ranks, key):
    """A value every rank holds: the same bits on each (the L-BFGS steers
    its branches by such values on every rank)."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


# ring reductions: float32 direct sums against the JAX package's blockwise
# ring bodies, in other orders: 1e-5 relative to the largest output
TOL = 1e-5


def test_ring_rhs_self_eta_matches_jax(ring_run):
    inp, _, ranks = ring_run
    fn = _sharded(lambda q, p, m: jring.ring_rhs_self(q, p, m, inp["self_sigma"], True, AXIS,
                                                      eta=inp["self_eta"], tile=16),
                  3, (P(AXIS), P(AXIS), P()))
    vq, mgq, dc = fn(*(jnp.asarray(inp[f"self_{k}"]) for k in "qpm"))
    _close(_rows(ranks, "self_vq"), vq, TOL)
    _close(_rows(ranks, "self_mgq"), mgq, TOL)
    np.testing.assert_allclose(_replicated(ranks, "self_dc"), float(dc), rtol=TOL)


def test_ring_rhs_ext_matches_jax(ring_run):
    inp, _, ranks = ring_run
    fn = _sharded(lambda q, p, x, mq, mx: jring.ring_rhs_ext(q, p, x, mq, mx, inp["ext_sigma"],
                                                             True, AXIS, tile=16),
                  5, (P(AXIS), P(AXIS), P(), P(AXIS)))
    vq, mgq, dc, vx = fn(*(jnp.asarray(inp[f"ext_{k}"]) for k in ("q", "p", "x", "mq", "mx")))
    _close(_rows(ranks, "ext_vq"), vq, TOL)
    _close(_rows(ranks, "ext_mgq"), mgq, TOL)
    _close(_rows(ranks, "ext_vx"), vx, TOL)
    np.testing.assert_allclose(_replicated(ranks, "ext_dc"), float(dc), rtol=TOL)


def test_ring_hamiltonian_matches_jax(ring_run):
    inp, _, ranks = ring_run
    fn = _sharded(lambda q, p, m: jring.ring_hamiltonian(q, p, m, inp["ham_sigma"],
                                                         inp["ham_eta"], AXIS, tile=16),
                  3, P())
    h = fn(*(jnp.asarray(inp[f"ham_{k}"]) for k in "qpm"))
    np.testing.assert_allclose(_replicated(ranks, "ham"), float(h), rtol=TOL)


@pytest.mark.parametrize("scheme", ["Euler", "Ralston"])
def test_ring_shoot_matches_jax(ring_run, scheme):
    """make_ring_shoot (nt = 5, logdet on): the arrival points (1e-5
    relative to the largest) and the global divergence cost (rtol 1e-4: a sum
    of five steps' partly cancelling dcost terms; tests/test_parallel.py holds
    the JAX ring's at 1e-3)."""
    inp, _, ranks = ring_run
    shoot = jring.make_ring_shoot(inp["shoot_sigma"], 100.0, True, 5, make_mesh(WORLD, axis=AXIS),
                                  AXIS, scheme=scheme)
    q1, _, cost = shoot(*(jnp.asarray(inp[f"shoot_{k}"]) for k in "qpm"))
    _close(_rows(ranks, f"shoot_{scheme}_q1"), q1, TOL)
    np.testing.assert_allclose(_replicated(ranks, f"shoot_{scheme}_cost"), float(cost),
                               rtol=1e-4, atol=1e-6)


def _dense_loss(lcfg, a, q0, y, w, mask, sig2):
    """The registration loss on one process through the dense route:
    lddmm trajloss plus the weighted quadratic dataloss."""
    final, _ = tlddmm.shoot(lcfg, q0, a, None, mask)
    quad = ((mask * w)[:, None] * (final.q - y) ** 2).sum() / (2.0 * sig2)
    return tlddmm.trajloss(lcfg, q0, a, final.cost, mask) + quad


@pytest.mark.parametrize("version", ["hybrid", "logdet"])
def test_sharded_loss_gradient(ring_run, version):
    """The 4-rank sharded loss and its gradient, gathered, against the
    world-of-one ring's within 1e-5 relative (the rotation's and psum's
    backward); and against the dense single-process loss's within 1e-3
    relative (the ring's backward is the generated float32 kernel-sums;
    the world-of-one ring measured 3.5e-7 (eta = 0) and 2.6e-7 (eta != 0)
    relative to the largest entry on these inputs, on the CPU)."""
    inp, _, ranks = ring_run
    lcfg = tlddmm.make_config(sigma=inp["loss_sigma"], lambd=500.0, version=version, nt=3,
                              scheme="Euler")
    args = [torch.as_tensor(inp[f"loss_{k}"]) for k in ("a0", "q0", "y", "w", "mask")]
    sig2 = float(inp["loss_sig2"])
    grads = {}
    for name, fn in (("ring", make_sharded_reg_loss(lcfg, None)),
                     ("dense", lambda *a: _dense_loss(lcfg, *a))):
        a = args[0].clone().requires_grad_(True)
        loss = fn(a, *args[1:], sig2)
        grads[name] = (float(loss.detach()), torch.autograd.grad(loss, a)[0].numpy())
    g4 = _rows(ranks, f"grad_{version}")
    loss4 = float(_replicated(ranks, f"loss_{version}"))
    np.testing.assert_allclose(loss4, grads["ring"][0], rtol=1e-5)
    _close(g4, grads["ring"][1], 1e-5)
    np.testing.assert_allclose(loss4, grads["dense"][0], rtol=1e-5)
    _close(g4, grads["dense"][1], 1e-3)


def test_twoset_steps_match_jax(ring_run):
    """Two port steps from the start give free energies within rtol 1e-2 of
    the JAX package's two steps (the bound test_parallel_twoset.py sets
    between the JAX package's own sharded and single-device runs), monotone;
    one port step from the JAX package's state after its first step gives its
    second free energy within the same bound."""
    _, outs, ranks = ring_run
    fes = _replicated(ranks, "ts_fe")
    want = [float(o.fe) for o in outs]
    assert fes[1] <= fes[0] + 1e-3 * abs(fes[0])
    np.testing.assert_allclose(fes, want, rtol=1e-2)
    np.testing.assert_allclose(_replicated(ranks, "ts_fe_from_jax"), want[1], rtol=1e-2)
    assert np.isfinite(_replicated(ranks, "ts_alpha")) and _replicated(ranks, "ts_alpha") > 0
    assert _rows(ranks, "ts_x1").shape == outs[1].x1.shape


def test_shard_and_convert_cut_as_jax(monkeypatch):
    """shard_twoset and twoset_out_from_numpy cut each rank's block as the
    JAX package's P(axis) sharding does, the memory's rows too; a point count
    that does not divide over the ranks raises."""
    mesh = make_mesh(WORLD, axis=AXIS)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(40, 2)).astype(np.float32)
    arr = jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(AXIS)))
    blocks = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    mem = {"S": rng.normal(size=(3, 80)).astype(np.float32),
           "Y": rng.normal(size=(3, 80)).astype(np.float32),
           "rho": np.ones(3, np.float32), "pos": np.int32(1), "count": np.int32(2)}
    state = {"gmm": {"mu": np.zeros((4, 2)), "w": np.zeros(4), "sigma": 0.1, "eta0": 0.0,
                     "vol0": 0.0}, "a0": a, "x1": a + 1, "alpha": 0.5, "memory": mem}
    import difficp_torch.parallel.twoset as tset

    for r, dev in enumerate(mesh.devices):
        shard = twoset_out_from_numpy(state, r, WORLD, "cpu")
        np.testing.assert_array_equal(shard.a0.numpy(), blocks[dev])
        np.testing.assert_array_equal(shard.x1.numpy(), blocks[dev] + 1)
        s = shard.memory.S.numpy().reshape(3, 10, 2)
        np.testing.assert_array_equal(s, mem["S"].reshape(3, 40, 2)[:, 10 * r:10 * (r + 1)])
        assert shard.memory.S.shape == (1, 3, 20) and int(shard.memory.count[0]) == 2
        monkeypatch.setattr(tset, "world", lambda group: WORLD)
        monkeypatch.setattr(tset, "rank_of", lambda group, r=r: r)
        np.testing.assert_array_equal(shard_twoset(object(), a, device="cpu")[0].numpy(),
                                      blocks[dev])
    with pytest.raises(ValueError, match="do not divide"):
        shard_twoset(object(), a[:39], device="cpu")


def test_without_a_group_is_unchanged_and_init_distributed(monkeypatch):
    """em_step and lbfgs_optimize with a world-of-one gloo group give bit for
    bit what they give with group=None (the collectives are identities on
    the values); init_distributed gives a world of one without a store and,
    asked for NCCL while a gloo group runs, raises instead of switching."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(300, 2)).astype(np.float32))
    mask = torch.as_tensor((rng.uniform(size=300) > 0.1).astype(np.float32))
    state, _ = tgmm.create(x[:12].numpy() + 0.01, sigma=0.3, device="cpu")
    cfg = tgmm.GMMConfig()
    target = torch.as_tensor(rng.normal(size=(2, 30)).astype(np.float32))

    def lossfn(p):
        return ((p - target) ** 4).sum(-1) + (p[:, 1:] * p[:, :-1]).sum(-1)

    def run(group):
        outs = [tgmm.em_step(state, x, mask, cfg, group=group),
                tgmm.em_step(state, x, mask, cfg, tile=64, group=group)]
        res = lbfgs_optimize(lossfn, torch.zeros(2, 30), nmax=3, inner=5, group=group)
        return [t for o in outs for t in (*o.state, o.y, o.cfe, o.fe, o.gamt)] + [
            res.params, res.loss, res.alpha, res.memory.S, res.change]

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch.init_distributed("cuda")
    plain = run(None)
    group, size, rank = launch.init_distributed("cpu")
    try:
        assert (size, rank) == (1, 0)
        assert launch.init_distributed("cpu")[1:] == (1, 0)
        monkeypatch.setattr(launch, "resolve_device", lambda device=None: torch.device("cuda"))
        with pytest.raises(RuntimeError, match="gloo process group is running"):
            launch.init_distributed("cuda")
        grouped = run(group)
    finally:
        torch.distributed.destroy_process_group()
    for a, b in zip(plain, grouped):
        assert torch.equal(a, b)
