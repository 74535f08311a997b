"""The port's frame-parallel atlas (difficp_torch/parallel/atlas.py) at
world size 4 against world size 1 and against the JAX package's on a
4-device mesh (``make_mesh(4)`` on the virtual CPU devices), at the bars of
tests/test_parallel.py:40-117,171-226.

The port's side runs as 4 gloo ranks: subprocesses of
tests/torch_atlas_worker.py that import torch and the port only and meet
through a ``file://`` store in a temporary directory, once for the module,
while the JAX programs run here.  Held: the sharded EM step against
``em_step`` on all points (rtol 1e-5) and against the JAX package's
``em_step_frames_sharded``; the atlas step (3 EM steps, one L-BFGS pass,
dense support) at world size 4 against world size 1 and against the JAX
package's (mu rtol 1e-4 / atol 1e-5, sigma rtol 1e-5, x1 rtol 2e-2 / atol
2e-3, FE rtol 2e-3); ``shard_psr``'s FE within 1e-3 of the unsharded
DiffPSR's; the step sizes and memory threaded over three steps, monotone,
the carried sequence at least as low.  Also: with a world-of-one group a
DiffPSR and the atlas step give bit for bit what they give without one, and
the state of a step carried across (utils/convert.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from difficp_tpu.models import gmm as jgmm
from difficp_tpu.models import lddmm as jlddmm
from difficp_tpu.parallel import atlas as jatlas
from difficp_tpu.utils.io import pad_frames as jpad_frames
from difficp_torch.models import gmm as tgmm
from difficp_torch.models import lddmm as tlddmm
from difficp_torch.models.psr import DiffPSR
from difficp_torch.parallel import atlas as tatlas
from difficp_torch.parallel import launch
from difficp_torch.utils.convert import atlas_out_from_numpy, atlas_out_to_numpy
from difficp_torch.utils.io import pad_frames

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
SPIRAL = np.load(HERE / "goldens" / "spiral.npz")
WORLD = 4
FRAMES = [SPIRAL[f"x{k}"] for k in range(8)]
PADDED = pad_frames(FRAMES, "cpu")
X, MASK = PADDED.x, PADDED.mask
GMM0 = {"mu": (SPIRAL["mu0"] + 0.01).astype(np.float32), "w": np.zeros(20, np.float32),
        "sigma": np.float32(0.1), "eta0": np.float32(0.0), "vol0": np.float32(0.0)}


def _tgmm(g=GMM0):
    return tgmm.GMMState(*(torch.as_tensor(np.asarray(g[f], np.float32))
                           for f in tgmm.GMMState._fields))


def _jgmm(g=GMM0):
    return jgmm.GMMState(**{k: jnp.asarray(v) for k, v in g.items()})


def _lcfg(mod, nt=5):
    return mod.make_config(sigma=0.2, lambd=500.0, version="hybrid", nt=nt, scheme="Euler")


def _threading_problem():
    """tests/test_parallel.py:171-226's problem: 8 frames of 24 normal
    points, 5 components."""
    rng = np.random.default_rng(5)
    k, n, c, d = 8, 24, 5, 2
    x = rng.normal(size=(k, n, d)).astype(np.float32)
    gmm = {"mu": rng.normal(size=(c, d)).astype(np.float32), "w": np.zeros(c, np.float32),
           "sigma": np.float32(0.5), "eta0": np.float32(0.0), "vol0": np.float32(0.0)}
    return x, np.ones((k, n), np.float32), gmm


def _jax_runs():
    """The JAX package's sharded EM step and atlas step on a 4-device mesh."""
    mesh = jatlas.make_mesh(WORLD)
    jp = jpad_frames(FRAMES)
    st, y, cfe, fe = jatlas.em_step_frames_sharded(_jgmm(), jp.x, jp.mask, jgmm.GMMConfig(),
                                                   mesh)
    step = jatlas.make_atlas_train_step(jgmm.GMMConfig(), _lcfg(jlddmm), mesh, em_iters=3,
                                        reg_nmax=1, use_ext=False)
    out = step(_jgmm(), jp.x, jnp.zeros_like(jp.x), jp.x, jp.x, jp.mask, jp.mask)
    return {"em_mu": np.asarray(st.mu), "em_sigma": float(st.sigma), "em_y": np.asarray(y),
            "em_fe": float(fe), "step_mu": np.asarray(out.gmm.mu),
            "step_sigma": float(out.gmm.sigma), "step_x1": np.asarray(out.x1),
            "step_fe": float(out.fe)}


@pytest.fixture(scope="module")
def atlas_run(tmp_path_factory):
    """The 4 ranks' results (each rank's dict of numpy arrays) and the JAX
    package's, computed meanwhile."""
    thr_x, thr_mask, thr_gmm = _threading_problem()
    inp = {"x": X.numpy(), "mask": MASK.numpy(), "n_frames": len(FRAMES),
           "thr_x": thr_x, "thr_mask": thr_mask,
           **{f"gmm_{k}": v for k, v in GMM0.items()},
           **{f"thr_gmm_{k}": v for k, v in thr_gmm.items()},
           **{f"frame{k}": f for k, f in enumerate(FRAMES)}}
    directory = tmp_path_factory.mktemp("atlas")
    np.savez(directory / "inputs.npz", **inp)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_atlas_worker.py"),
                               str(directory), str(r), str(WORLD)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        jax_out = _jax_runs()
        logs = [proc.communicate(timeout=300)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    codes = [proc.returncode for proc in procs]
    assert codes == [0] * WORLD, "\n".join(f"rank {r}: rc {c}\n{log[-3000:]}"
                                           for r, (c, log) in enumerate(zip(codes, logs)))
    ranks = [dict(np.load(directory / f"out_{r}.npz")) for r in range(WORLD)]
    return ranks, jax_out, thr_x, thr_mask, thr_gmm


def _rows(ranks, key):
    return np.concatenate([r[key] for r in ranks], 0)


def _replicated(ranks, key):
    """A value every rank holds: the same bits on each."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


def test_sharded_em_matches_single_device_and_jax(atlas_run):
    ranks, jax_out, *_ = atlas_run
    k, n, d = X.shape
    ref = tgmm.em_step(_tgmm(), X.reshape(k * n, d), MASK.reshape(k * n), tgmm.GMMConfig())
    mu, sigma = _replicated(ranks, "em_mu"), float(_replicated(ranks, "em_sigma"))
    y = _rows(ranks, "em_y")
    fe = float(_replicated(ranks, "em_fe"))
    for want_mu, want_sigma, want_y, want_fe in (
            (ref.state.mu.numpy(), float(ref.state.sigma), ref.y.numpy(), float(ref.fe)),
            (jax_out["em_mu"], jax_out["em_sigma"], jax_out["em_y"], jax_out["em_fe"])):
        np.testing.assert_allclose(mu, want_mu, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sigma, want_sigma, rtol=1e-6)
        np.testing.assert_allclose(y.reshape(k * n, d), want_y.reshape(k * n, d), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(fe, want_fe, rtol=1e-4)


def test_atlas_step_world4_matches_world1_and_jax(atlas_run):
    ranks, jax_out, *_ = atlas_run
    step = tatlas.make_atlas_train_step(tgmm.GMMConfig(), _lcfg(tlddmm), None, em_iters=3,
                                        reg_nmax=1, use_ext=False)
    one = step(_tgmm(), X, torch.zeros_like(X), X, X, MASK, MASK)
    mu, sigma = _replicated(ranks, "step_mu"), float(_replicated(ranks, "step_sigma"))
    x1, fe = _rows(ranks, "step_x1"), float(_replicated(ranks, "step_fe"))
    assert np.isfinite(_rows(ranks, "step_alpha")).all()
    for want_mu, want_sigma, want_x1, want_fe in (
            (one.gmm.mu.numpy(), float(one.gmm.sigma), one.x1.numpy(), float(one.fe)),
            (jax_out["step_mu"], jax_out["step_sigma"], jax_out["step_x1"],
             jax_out["step_fe"])):
        np.testing.assert_allclose(mu, want_mu, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(sigma, want_sigma, rtol=1e-5)
        np.testing.assert_allclose(x1, want_x1, rtol=2e-2, atol=2e-3)
        np.testing.assert_allclose(fe, want_fe, rtol=2e-3)


def test_shard_psr_matches_unsharded(atlas_run):
    """A DiffPSR sharded over 4 ranks (2 frames each) runs GMM_opt and
    Reg_opt to the unsharded FE within 1e-3; the momenta loosely (rtol 5e-2
    / atol 1e-2, the JAX test's weak oracle)."""
    ranks, *_ = atlas_run
    psr = DiffPSR(FRAMES, _tgmm(), tgmm.GMMConfig(), _lcfg(tlddmm), device="cpu")
    psr.printstuff = False
    psr.GMM_opt(max_iterations=5, tol=1e-4)
    psr.Reg_opt(tol=1e-3, nmax=1)
    assert all(int(r["psr_k"]) == 2 for r in ranks)
    assert all(int(r["psr_events"]) == 0 for r in ranks)
    fe = float(_replicated(ranks, "psr_fe"))
    assert abs(fe - psr.FE) < 1e-3 * abs(psr.FE)
    np.testing.assert_allclose(_rows(ranks, "psr_a0"), psr.a0.numpy(), rtol=5e-2, atol=1e-2)


def test_atlas_step_alpha_and_memory_threading(atlas_run):
    """Three steps threading the step sizes, without and with the carried
    curvature memory (size 4): finite, monotone, and the carried sequence
    at least as low at the same budget; world size 4 as world size 1 (FE
    rtol 2e-3)."""
    ranks, _, thr_x, thr_mask, thr_gmm = atlas_run
    fes = {False: _replicated(ranks, "thr_fes"), True: _replicated(ranks, "thr_fes_mem")}
    for seq in fes.values():
        assert np.isfinite(seq).all()
        assert all(b <= a + 1e-3 * abs(a) for a, b in zip(seq, seq[1:]))
    assert fes[True][-1] <= fes[False][-1] + 1e-3 * abs(fes[False][-1])

    x, mask = torch.as_tensor(thr_x), torch.as_tensor(thr_mask)
    lcfg = tlddmm.make_config(sigma=0.5, lambd=100.0, version="hybrid", nt=3, scheme="Euler")
    step = tatlas.make_atlas_train_step(tgmm.GMMConfig(), lcfg, None, em_iters=2, reg_nmax=1,
                                        use_ext=False, reg_inner=3, reg_ls=8, carry_memory=True,
                                        memory_size=4)
    st, a0, x1, al = _tgmm(thr_gmm), torch.zeros_like(x), x, torch.zeros(8)
    mem = tatlas.zero_atlas_memory(a0, 4)
    one = []
    for _ in range(3):
        out = step(st, x, a0, x, x1, mask, mask, al, mem)
        st, a0, x1, al, mem = out.gmm, out.a0, out.x1, out.alpha, out.memory
        one.append(float(out.fe))
    assert mem.S.shape == (8, 4, 48)
    np.testing.assert_allclose(fes[True], one, rtol=2e-3)


def test_world_of_one_group_is_bit_for_bit(monkeypatch):
    """With a world-of-one gloo group, DiffPSR (GMM_opt, Reg_opt, run) and
    the atlas step give bit for bit what they give with group=None; a step's
    output carried out and back (utils/convert.py) continues identically;
    frame counts that do not divide over the ranks raise."""
    frames = FRAMES[:2]

    def psr_fes(group):
        psr = DiffPSR(frames, _tgmm(), tgmm.GMMConfig(), _lcfg(tlddmm, nt=3), device="cpu")
        psr.printstuff = False
        if group is not None:
            tatlas.shard_psr(psr, group)
        psr.GMM_opt(max_iterations=3, tol=0.0)
        psr.Reg_opt(tol=1e-3, nmax=1, inner=4, ls_steps=6)
        return [psr.FE, *psr.run(1, max_em=2, reg_nmax=1, reg_inner=4, reg_ls=6)]

    x, mask = X[:2].contiguous(), MASK[:2].contiguous()

    def step_out(group):
        step = tatlas.make_atlas_train_step(tgmm.GMMConfig(), _lcfg(tlddmm, nt=3), group,
                                            em_iters=2, reg_nmax=1, use_ext=False, reg_inner=4,
                                            reg_ls=6)
        return step(_tgmm(), x, torch.zeros_like(x), x, x, mask, mask)

    plain_fes, plain_out = psr_fes(None), step_out(None)
    group, size, rank = launch.init_distributed("cpu")
    try:
        assert (size, rank) == (1, 0)
        assert tatlas.frame_range(8, group) == slice(0, 8)
        grouped_fes, grouped_out = psr_fes(group), step_out(group)
    finally:
        torch.distributed.destroy_process_group()
    assert plain_fes == grouped_fes
    for a, b in zip(plain_out, grouped_out):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(plain_out.gmm, grouped_out.gmm))

    back = atlas_out_from_numpy(atlas_out_to_numpy(plain_out), "cpu")
    for a, b in zip(plain_out, back):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    half = atlas_out_from_numpy(atlas_out_to_numpy(plain_out), "cpu", frames=slice(1, 2))
    assert torch.equal(half.a0, plain_out.a0[1:2])

    monkeypatch.setattr(tatlas, "world", lambda group: 4)
    monkeypatch.setattr(tatlas, "rank_of", lambda group: 3)
    assert tatlas.frame_range(8, object()) == slice(6, 8)
    with pytest.raises(ValueError, match="do not divide"):
        tatlas.frame_range(6, object())
