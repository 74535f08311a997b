"""The port's IO bridge against the JAX package (mirrors tests/test_io_bridge.py):
VTK landmark files, checkpoints of DiffPSR (dense and grid support) and
AffinePSR across the two packages in both directions, the generic pytree
helpers' leaf order, the Deformetrica-output replay and the Chui loader."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difficp_tpu.api.deformetrica_atlas import load_deformetrica_output as j_load_dfca
from difficp_tpu.models import affine as ja
from difficp_tpu.models import gmm as jg
from difficp_tpu.models import lddmm as jl
from difficp_tpu.models.psr import AffinePSR as JAffinePSR
from difficp_tpu.models.psr import DiffPSR as JDiffPSR
from difficp_tpu.utils import checkpoint as jck
from difficp_tpu.utils import vtk_io as jvtk
from difficp_torch.api.deformetrica_atlas import deformetrica_atlas
from difficp_torch.api.deformetrica_atlas import load_deformetrica_output as t_load_dfca
from difficp_torch.examples.chui import load_chui
from difficp_torch.models import affine as ta
from difficp_torch.models import gmm as tg
from difficp_torch.models import lddmm as tl
from difficp_torch.models.psr import AffinePSR as TAffinePSR
from difficp_torch.models.psr import DiffPSR as TDiffPSR
from difficp_torch.models.psr_standard import AffinePSRStd, DiffPSRStd
from difficp_torch.utils import checkpoint as tck
from difficp_torch.utils import vtk_io as tvtk

torch.set_num_threads(1)

SPIRAL = np.load(os.path.join(os.path.dirname(__file__), "goldens", "spiral.npz"))
FRAMES = [SPIRAL[f"x{k}"] for k in range(3)]


# ----- VTK landmarks --------------------------------------------------------

@pytest.mark.parametrize("d", [2, 3])
def test_vtk_roundtrip_and_byte_identical(tmp_path, d):
    pts = np.random.default_rng(d).normal(size=(37, d)).astype(np.float32)
    ft, fj = str(tmp_path / "t.vtk"), str(tmp_path / "j.vtk")
    tvtk.write_landmarks(ft, torch.as_tensor(pts))
    jvtk.write_landmarks(fj, pts)
    with open(ft, "rb") as a, open(fj, "rb") as b:
        assert a.read() == b.read()
    for reader in (tvtk.read_landmarks, jvtk.read_landmarks):
        for f in (ft, fj):
            back = reader(f)
            assert back.shape == (37, d) and back.dtype == np.float32
            np.testing.assert_array_equal(back, pts)


# ----- checkpoints ----------------------------------------------------------

def _gmm_cfg(mod):
    return mod.GMMConfig(optimize_mu=True, optimize_sigma=True, optimize_w=True,
                         optimize_eta0=False)


def _diff_psrs(scheme, version="hybrid"):
    """A fresh DiffPSR of each package on the same three spiral frames,
    with the same support."""
    lcfg = dict(sigma=0.2, lambd=500.0, version=version, nt=5, scheme="Euler")
    jstate, _ = jg.create(jnp.asarray(SPIRAL["mu0"]), sigma=0.1)
    jpsr = JDiffPSR(FRAMES, jstate, _gmm_cfg(jg), jl.make_config(**lcfg))
    tstate, _ = tg.create(SPIRAL["mu0"], sigma=0.1)
    tpsr = TDiffPSR(FRAMES, tstate, _gmm_cfg(tg), tl.make_config(**lcfg), device="cpu")
    for psr in (jpsr, tpsr):
        psr.printstuff = False
        if scheme is not None:
            psr.set_support_scheme(scheme, rho=1.0)
    return jpsr, tpsr


def _affine_psrs():
    jstate, _ = jg.create(jnp.asarray(SPIRAL["mu0"]), sigma=0.1)
    jpsr = JAffinePSR(FRAMES, jstate, _gmm_cfg(jg), ja.AffineConfig(version="similarity"))
    tstate, _ = tg.create(SPIRAL["mu0"], sigma=0.1)
    tpsr = TAffinePSR(FRAMES, tstate, _gmm_cfg(tg), ta.AffineConfig(version="similarity"),
                      device="cpu")
    for psr in (jpsr, tpsr):
        psr.printstuff = False
    return jpsr, tpsr


def _state(psr, kind):
    """The checkpointed arrays of a PSR of either package, as numpy."""
    host = lambda v: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)  # noqa: E731
    names = ["x1", "y", "ptw", "regloss", "quadloss"]
    names += ["a0", "q0", "qmask"] if kind == "diff" else ["M", "t"]
    out = {n: host(getattr(psr, n)) for n in names}
    for s, g in enumerate(psr.gmm):
        out.update({f"gmm{s}_{f}": host(v) for f, v in zip(g._fields, g)})
    out["Cfe"] = np.asarray([float(c) for c in psr.Cfe])
    return out


def _assert_same_state(a, b, kind):
    sa, sb = _state(a, kind), _state(b, kind)
    assert sa.keys() == sb.keys()
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)
        assert sa[key].dtype == sb[key].dtype, key
    assert abs(a.FE - b.FE) < 1e-9


@pytest.mark.parametrize("kind,scheme", [("diff", None), ("diff", "grid"), ("affine", None)])
def test_checkpoint_across_packages(tmp_path, kind, scheme):
    """The port's state saved by the port loads into a fresh JAX PSR; that
    JAX PSR saves it again and a fresh port PSR loads it: every array equal,
    in its dtype, the FE within 1e-9, and the files' keys and header the
    same."""
    if kind == "diff":
        jfresh, src = _diff_psrs(scheme)
        _, tfresh = _diff_psrs(scheme)
    else:
        jfresh, src = _affine_psrs()
        _, tfresh = _affine_psrs()
    src.GMM_opt(max_iterations=3, tol=1e-4)
    src.Reg_opt(tol=1e-3, nmax=1)
    ft, fj = str(tmp_path / "port"), str(tmp_path / "jax.npz")
    tck.save_psr(ft, src)
    assert os.path.exists(ft + ".npz")
    jck.load_psr(ft, jfresh)
    _assert_same_state(src, jfresh, kind)
    jck.save_psr(fj, jfresh)
    tck.load_psr(fj, tfresh)
    _assert_same_state(src, tfresh, kind)
    assert all(t.device.type == "cpu" for t in (tfresh.x1, tfresh.gmm[0].mu))
    with np.load(ft + ".npz") as a, np.load(fj) as b:
        assert sorted(a.files) == sorted(b.files)
        assert bytes(a["__header__"]) == bytes(b["__header__"])
    # the loaded port PSR continues as the source does
    for psr in (src, tfresh):
        psr.GMM_opt(max_iterations=3, tol=1e-4)
    assert tfresh.fe_increase_events == 0
    np.testing.assert_allclose(tfresh.FE, src.FE, rtol=1e-6)


@pytest.mark.parametrize("stage", ["start", "trained"])
def test_checkpoint_eta_start_survives(tmp_path, stage):
    """An eta != 0 DiffPSR: a fresh one holds a pending start free energy
    (the port records the start momenta's free energy before its first
    step; the JAX package does not).  A loaded checkpoint drops it, so the
    next GMM_opt keeps the loaded warped points and FE as its baseline, as
    the JAX package does, and both packages give the same FE after it; at
    "start" the checkpoint is of an untouched PSR, whose warped points are
    not the shoot of its momenta."""
    jfresh, src = _diff_psrs("grid", version="logdet")
    _, tfresh = _diff_psrs("grid", version="logdet")
    assert tfresh._start_pending
    if stage == "trained":
        src.GMM_opt(max_iterations=3, tol=1e-4)
        src.Reg_opt(tol=1e-3, nmax=1)
    f = str(tmp_path / "eta.npz")
    tck.save_psr(f, src)
    tck.load_psr(f, tfresh)
    jck.load_psr(f, jfresh)
    assert not tfresh._start_pending and tfresh._reg_vg is None
    x1 = tfresh.x1.clone()
    fe_loaded = tfresh.FE
    tfresh.GMM_opt(max_iterations=3, tol=1e-4)
    jfresh.GMM_opt(max_iterations=3, tol=1e-4)
    assert torch.equal(tfresh.x1, x1)
    assert tfresh.fe_increase_events == 0 and tfresh.FE <= fe_loaded
    np.testing.assert_allclose(tfresh.FE, jfresh.FE, rtol=1e-5)


def test_checkpoint_support_mismatch_raises(tmp_path):
    _, src = _diff_psrs("grid")
    _, dense = _diff_psrs(None)
    f = str(tmp_path / "grid.npz")
    tck.save_psr(f, src)
    with pytest.raises(ValueError, match="support"):
        tck.load_psr(f, dense)


@pytest.mark.parametrize("cls", [DiffPSRStd, AffinePSRStd])
def test_checkpoint_standard_psr_raises(tmp_path, cls):
    x = [SPIRAL["x0"], SPIRAL["x1"]]
    if cls is DiffPSRStd:
        cfg = tl.make_config(sigma=0.2, lambd=2.0, version="classic", nt=5, scheme="Euler")
    else:
        cfg = ta.AffineConfig(version="rigid")
    psr = cls(x, SPIRAL["x0"], 0.2, cfg, data_sigma=0.1, device="cpu")
    with pytest.raises(TypeError):
        tck.save_psr(str(tmp_path / "std"), psr)


def test_save_pytree_leaf_order_matches_jax(tmp_path):
    """Dict keys not in sorted order, a None, a NamedTuple and nested
    containers: leaf_i is the same leaf in both packages, both ways."""
    rng = np.random.default_rng(3)
    arr = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    tree = {"zeta": arr(3), "alpha": [arr(2, 2), None, (arr(1), np.int32(7))],
            "mid": tg.GMMState(*(arr(2) for _ in range(5))), "beta": {"y": arr(4), "x": 1.5}}
    jleaves = jax.tree.flatten(tree)[0]
    ft, fj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    treedef = tck.save_pytree(ft, tree, meta={"step": 3})
    jck.save_pytree(fj, tree, meta={"step": 3})
    assert treedef.num_leaves == len(jleaves) == 11
    jback, jmeta = jck.load_leaves(ft)
    tback, tmeta = tck.load_leaves(fj, device="cpu")
    assert jmeta == tmeta == {"step": 3}
    for ref, a, b in zip(jleaves, jback, tback):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(ref))
        np.testing.assert_array_equal(b.numpy(), np.asarray(ref))
    rebuilt = treedef.unflatten(tback)
    assert list(rebuilt) == sorted(tree) and isinstance(rebuilt["mid"], tg.GMMState)
    assert rebuilt["alpha"][1] is None
    np.testing.assert_array_equal(rebuilt["beta"]["y"].numpy(), tree["beta"]["y"])


# ----- Deformetrica ---------------------------------------------------------

def _write_dfca_output(out, template, q0, a0):
    """A Deformetrica deterministic-atlas output directory (the files
    load_deformetrica_output reads)."""
    out.mkdir()
    jvtk.write_landmarks(
        str(out / "DeterministicAtlas__EstimatedParameters__Template_pointset.vtk"), template)
    np.savetxt(str(out / "DeterministicAtlas__EstimatedParameters__ControlPoints.txt"), q0)
    k_frames, nq, d = a0.shape
    with open(str(out / "DeterministicAtlas__EstimatedParameters__Momenta.txt"), "w") as f:
        f.write(f"{k_frames} {nq} {d}\n\n")
        for kk in range(k_frames):
            for row in a0[kk]:
                f.write(f"{row[0]} {row[1]}\n")


def test_deformetrica_replay_matches_jax(tmp_path):
    """test_io_bridge.py::test_deformetrica_replay's output directory
    replayed through both packages: a0, the warped templates and E agree."""
    rng = np.random.default_rng(2)
    k_frames, n, d, nq = 3, 25, 2, 12
    x = [rng.normal(size=(n, d)).astype(np.float32) for _ in range(k_frames)]
    template = rng.normal(size=(n, d)).astype(np.float32)
    q0 = rng.normal(size=(nq, d)).astype(np.float32)
    a0 = 0.1 * rng.normal(size=(k_frames, nq, d)).astype(np.float32)
    _write_dfca_output(tmp_path / "out", template, q0, a0)
    kw = dict(sigma_data=0.5, noise_std=0.3, sigma_lddmm=0.5)
    tpsr = t_load_dfca(x, str(tmp_path / "out"), device="cpu", **kw)
    jpsr = j_load_dfca(x, str(tmp_path / "out"), **kw)
    assert tpsr.K == k_frames and tpsr.support_scheme == "custom"
    np.testing.assert_allclose(tpsr.a0.numpy(), a0, rtol=1e-5)
    np.testing.assert_allclose(tpsr.a0.numpy(), np.asarray(jpsr.a0), rtol=1e-5)
    np.testing.assert_array_equal(tpsr.q0.numpy(), np.asarray(jpsr.q0))
    np.testing.assert_allclose(tpsr.y1.numpy(), np.asarray(jpsr.y1), atol=1e-5)
    np.testing.assert_allclose(tpsr.E, jpsr.E, rtol=1e-5)
    # frame 0's warped template is an explicit shoot of the imports
    final, _ = tl.shoot(tpsr.lcfg, torch.as_tensor(q0), torch.as_tensor(a0[0]),
                        torch.as_tensor(template))
    np.testing.assert_allclose(tpsr.y1[0].numpy(), final.x.numpy(), rtol=1e-4, atol=1e-5)


def test_deformetrica_atlas_needs_the_package():
    with pytest.raises(ImportError, match="deformetrica"):
        deformetrica_atlas([SPIRAL["x0"], SPIRAL["x1"]],
                           model_parameters={"sigma_data": 0.1, "noise_std": 0.2,
                                             "sigma_LDDMM": 0.2}, device="cpu")


# ----- Chui ------------------------------------------------------------------

@pytest.mark.parametrize("dataset,names", [(3, ("x3", "y3")), (4, ("x1", "y2a"))])
def test_load_chui_from_a_mat_file(tmp_path, dataset, names):
    import scipy.io

    rng = np.random.default_rng(dataset)
    xa, xb = rng.normal(size=(50, 2)), rng.normal(size=(91, 2))
    scipy.io.savemat(str(tmp_path / f"demodata_ex{dataset}.mat"),
                     {names[0]: xa, names[1]: xb, "other": np.zeros(3)})
    a, b = load_chui(dataset, path=str(tmp_path))
    assert a.dtype == b.dtype == np.float32 and a.flags.c_contiguous
    np.testing.assert_array_equal(a, xa.astype(np.float32))
    np.testing.assert_array_equal(b, xb.astype(np.float32))


def test_load_chui_missing(tmp_path, monkeypatch):
    monkeypatch.setenv("DIFFICP_CHUI_PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="DIFFICP_CHUI_PATH"):
        load_chui(2, path=str(tmp_path))
