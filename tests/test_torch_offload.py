"""The port's host-offload atlas (difficp_torch/models/offload.py) against
itself across chunkings, against the port's DiffPSR, and against the JAX
package's HostOffloadAtlas on the same inputs: tests/test_offload.py's four
cases (spiral.npz's 8 frames, its GMM start and LCFG, em_tol = 0 and a fixed
number of EM sweeps), at its bars: FE rtol 5e-3 between chunkings and
between the packages, 2e-3 against DiffPSR; warped points rtol 5e-2 / atol
5e-3.  Also K = 7 frames in chunks of 4 (a filler frame) against the JAX
package, the state carried both ways (utils/convert.py) and a run continued
from the JAX package's state, and the host traffic counters.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from difficp_tpu.models import gmm as jg
from difficp_tpu.models import lddmm as jl
from difficp_tpu.models.offload import HostOffloadAtlas as JAtlas
from difficp_torch.models import gmm as tg
from difficp_torch.models import lddmm as tl
from difficp_torch.models.offload import HostOffloadAtlas as TAtlas
from difficp_torch.models.psr import DiffPSR as TDiffPSR
from difficp_torch.utils.convert import load_offload_state, offload_state_to_numpy

torch.set_num_threads(1)

HERE = os.path.dirname(__file__)
SPIRAL = np.load(os.path.join(HERE, "goldens", "spiral.npz"))
X = [SPIRAL[f"x{k}"] for k in range(8)]
RUN_KW = dict(max_em=4, em_tol=0.0, reg_nmax=1, reg_inner=8, reg_ls=8)
FE_CHUNKS = 5e-3
FE_PSR = 2e-3
X1_TOL = dict(rtol=5e-2, atol=5e-3)


def _lcfg(mod):
    return mod.make_config(sigma=0.2, lambd=500.0, version="hybrid", nt=3, scheme="Euler")


def _jax_gmm():
    state = jg.GMMState(mu=jnp.asarray(SPIRAL["mu0"]) + 0.01, w=jnp.zeros(20),
                        sigma=jnp.asarray(0.1), eta0=jnp.asarray(0.0), vol0=jnp.asarray(0.0))
    return state, jg.GMMConfig()


def _torch_gmm():
    state = tg.GMMState(mu=torch.as_tensor(SPIRAL["mu0"] + 0.01), w=torch.zeros(20),
                        sigma=torch.tensor(0.1), eta0=torch.tensor(0.0), vol0=torch.tensor(0.0))
    return state, tg.GMMConfig()


def _jax_state(atlas):
    """A JAX HostOffloadAtlas's state under the port's keys, as numpy
    copies (the atlas writes its host arrays in place)."""
    out = {name: np.array(getattr(atlas, name)) for name in
           ("x0", "x1", "y", "ptw", "mask", "q0", "qmask", "a0", "_alpha")}
    out["gmm"] = [{f: np.array(getattr(g, f)) for f in jg.GMMState._fields}
                  for g in atlas.gmm]
    out.update(cfe=list(atlas.cfe), quadloss=atlas.quadloss, regloss=atlas.regloss,
               FE=atlas.FE, fe_increase_events=atlas.fe_increase_events,
               support_scheme=atlas.support_scheme)
    return out


def run_offload(chunk, x=X):
    state, gcfg = _torch_gmm()
    atlas = TAtlas(x, state, gcfg, _lcfg(tl), chunk_frames=chunk, device="cpu")
    return atlas, atlas.run(2, **RUN_KW)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's offload atlas, chunks of 4: on the 8 frames (one
    iteration, its state, a second iteration) and on the first 7 frames."""
    state, gcfg = _jax_gmm()
    atlas = JAtlas(X, state, gcfg, _lcfg(jl), chunk_frames=4)
    fe1 = atlas.run(1, **RUN_KW)
    state1 = _jax_state(atlas)
    fe2 = atlas.run(1, **RUN_KW)
    seven = JAtlas(X[:7], state, gcfg, _lcfg(jl), chunk_frames=4)
    fes7 = seven.run(2, **RUN_KW)
    return {"fes": np.concatenate([fe1, fe2]), "state1": state1, "x1": np.asarray(atlas.x1),
            "fes7": fes7, "x1_7": np.asarray(seven.x1), "events": atlas.fe_increase_events,
            "events7": seven.fe_increase_events}


def test_offload_monotone_and_chunk_invariant():
    atlas4, fes4 = run_offload(4)
    atlas8, fes8 = run_offload(8)
    assert atlas4.fe_increase_events == 0 and atlas8.fe_increase_events == 0
    np.testing.assert_allclose(fes4, fes8, rtol=FE_CHUNKS)
    np.testing.assert_allclose(atlas4.x1[:8].numpy(), atlas8.x1[:8].numpy(), **X1_TOL)


def _psr_steps(psr, n=2):
    psr.printstuff = False
    for _ in range(n):
        psr.GMM_opt(max_iterations=RUN_KW["max_em"], tol=0.0)
        psr.Reg_opt(tol=1e-3, nmax=RUN_KW["reg_nmax"], inner=RUN_KW["reg_inner"],
                    ls_steps=RUN_KW["reg_ls"])
    return psr


def test_offload_matches_diffpsr():
    atlas, fes = run_offload(4)
    state, gcfg = _torch_gmm()
    psr = _psr_steps(TDiffPSR(X, state, gcfg, _lcfg(tl), device="cpu"))
    assert psr.fe_increase_events == 0
    np.testing.assert_allclose(fes[-1], psr.FE, rtol=FE_PSR)
    np.testing.assert_allclose(atlas.x1[:8].numpy(), psr.x1.numpy(), **X1_TOL)


def test_offload_matches_jax(jax_runs):
    """The FE sequence and the warped points against the JAX package's
    offload atlas in the same chunks; no increase in either."""
    atlas, fes = run_offload(4)
    assert atlas.fe_increase_events == 0 == jax_runs["events"]
    np.testing.assert_allclose(fes, jax_runs["fes"], rtol=FE_CHUNKS)
    np.testing.assert_allclose(atlas.x1.numpy(), jax_runs["x1"], **X1_TOL)


def test_filler_frames_match_jax(jax_runs):
    """K = 7 frames in chunks of 4: one filler frame (frame 0 at mask 0)
    whose zero gradient keeps a finite cold seed; the FE sequence within
    5e-3 of the JAX package's, the real frames' warped points at its bars."""
    atlas, fes = run_offload(4, X[:7])
    assert (atlas.K, atlas.Kpad) == (7, 8)
    assert atlas.fe_increase_events == 0 == jax_runs["events7"]
    assert float(atlas.mask[7].abs().max()) == 0.0
    assert bool(torch.isfinite(atlas._alpha).all())
    np.testing.assert_allclose(fes, jax_runs["fes7"], rtol=FE_CHUNKS)
    np.testing.assert_allclose(atlas.x1[:7].numpy(), jax_runs["x1_7"][:7], **X1_TOL)


def test_state_round_trip_and_continue_from_jax(jax_runs):
    """The state after one iteration carried out and back in bit for bit;
    a port atlas loaded with the JAX package's state after one iteration
    gives its second FE within 5e-3."""
    state, gcfg = _torch_gmm()
    atlas = TAtlas(X, state, gcfg, _lcfg(tl), chunk_frames=4, device="cpu")
    atlas.run(1, **RUN_KW)
    saved = offload_state_to_numpy(atlas)
    twin = load_offload_state(TAtlas(X, state, gcfg, _lcfg(tl), chunk_frames=4, device="cpu"),
                              saved)
    again = offload_state_to_numpy(twin)
    for key, val in saved.items():
        if key == "gmm":
            for a, b in zip(val, again["gmm"]):
                for f in a:
                    np.testing.assert_array_equal(a[f], b[f])
        elif isinstance(val, np.ndarray):
            np.testing.assert_array_equal(val, again[key])
        else:
            assert val == again[key]
    np.testing.assert_array_equal(atlas.run(1, **RUN_KW), twin.run(1, **RUN_KW))

    cont = load_offload_state(TAtlas(X, state, gcfg, _lcfg(tl), chunk_frames=4, device="cpu"),
                              jax_runs["state1"])
    assert cont.FE == jax_runs["fes"][0]
    fe2 = cont.run(1, **RUN_KW)
    assert cont.fe_increase_events == 0
    np.testing.assert_allclose(fe2[0], jax_runs["fes"][1], rtol=FE_CHUNKS)


def _multi_structure_data(k=6, seed=0):
    """tests/test_offload.py's K frames x S = 2 structures (a spiral subset
    and a shifted circle), ragged."""
    rng = np.random.default_rng(seed)
    x = []
    for kk in range(k):
        s0 = SPIRAL[f"x{kk}"][: 60 + 5 * kk]
        th = rng.uniform(0, 2 * np.pi, 40 + 3 * kk).astype(np.float32)
        s1 = np.stack([1.5 + 0.3 * np.cos(th), 1.5 + 0.3 * np.sin(th)], 1)
        s1 = s1 + 0.02 * rng.standard_normal(s1.shape).astype(np.float32)
        x.append([s0, s1.astype(np.float32)])
    return x


def test_offload_multistructure_grid_support_matches_diffpsr():
    """S = 2 structures on a grid (rho 1.5) in chunks of 3 (a filler frame
    whose support mask is 1): the port's DiffPSR's FE and warped points."""
    x = _multi_structure_data()
    sc = [_torch_gmm(), _torch_gmm()]
    states, cfgs = [s for s, _ in sc], [c for _, c in sc]
    atlas = TAtlas(x, states, cfgs, _lcfg(tl), chunk_frames=3, device="cpu")
    atlas.set_support_scheme("grid", rho=1.5)
    fes = atlas.run(2, **RUN_KW)
    assert atlas.fe_increase_events == 0
    psr = TDiffPSR(x, states, cfgs, _lcfg(tl), device="cpu")
    psr.printstuff = False
    psr.set_support_scheme("grid", rho=1.5)
    _psr_steps(psr)
    assert psr.fe_increase_events == 0
    assert atlas.q0.shape[1:] == psr.q0.shape[1:]
    np.testing.assert_allclose(fes[-1], psr.FE, rtol=FE_PSR)
    np.testing.assert_allclose(atlas.x1[:6].numpy(), psr.x1.numpy(), **X1_TOL)


def test_offload_decim_support_runs_monotone():
    """Decim support (each frame's own cover, its two structures together)
    at rho 2: monotone, the support's filler rows masked; each chunk crosses
    once a pass: two uploads of the warped points a structure an EM sweep."""
    x = _multi_structure_data(k=4)
    sc = [_torch_gmm(), _torch_gmm()]
    atlas = TAtlas(x, [s for s, _ in sc], [c for _, c in sc], _lcfg(tl), chunk_frames=4,
                   device="cpu")
    atlas.set_support_scheme("decim", rho=2.0)
    assert atlas.support_scheme == "decim" and float(atlas.qmask.sum()) < atlas.q0.shape[1] * 4
    before = atlas.bytes_h2d
    atlas._em_sweep()
    point_bytes = atlas.Kpad * atlas.Ntot * (atlas.D + 1) * 4
    assert atlas.bytes_h2d - before == 2 * point_bytes
    atlas.run(2, **RUN_KW)
    assert atlas.fe_increase_events == 0


def test_tiled_em_inside_a_chunk(monkeypatch):
    """Above the dense pair limit a chunk's E steps stream point tiles (here
    forced: a limit of 1,000 pairs, tiles of 100 points): the sweep's GMM,
    targets, weights and energy terms as the dense sweep's (rtol 1e-5)."""
    from difficp_torch.models import offload
    from difficp_torch.ops import backend

    def sweep():
        state, gcfg = _torch_gmm()
        atlas = TAtlas(X, state, gcfg, _lcfg(tl), chunk_frames=4, device="cpu")
        fe = atlas._em_sweep()
        return fe, atlas

    fe_dense, dense = sweep()
    monkeypatch.setattr(backend, "DENSE_PAIR_LIMIT", 1000)
    monkeypatch.setattr(tg, "EM_TILE", 100)
    assert len(offload._point_tiles(4 * dense.Ntot, 20)) > 1
    fe_tiled, tiled = sweep()
    np.testing.assert_allclose(fe_tiled, fe_dense, rtol=1e-5)
    for a, b in zip(tiled.gmm[0], dense.gmm[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tiled.y.numpy(), dense.y.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tiled.ptw.numpy(), dense.ptw.numpy(), rtol=1e-5)
