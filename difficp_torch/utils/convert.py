"""State carried across between the JAX package and the port, as numpy arrays.

``load_psr_state`` puts a mid-run ``DiffPSR`` state (GMMs, momenta, points,
targets and the L-BFGS state threaded between ``Reg_opt`` calls) or
``AffinePSR`` state (GMMs, the maps M and t, points and targets) into a port
PSR of the same kind, so both packages can continue from the same point;
``psr_state_to_numpy`` is the reverse.  Arrays are keyed by the attribute
names both packages use; a GMM is a dict of its five fields and the curvature
memory a dict of the ``LBFGSMemory`` fields.  The support travels as
``support_scheme`` and ``rho`` beside the ``q0`` / ``qmask`` arrays, so a
grid-support state continues with the same grid.

``load_std_state`` / ``std_state_to_numpy`` do the same for the standard
algorithm's ``DiffPSRStd`` (template, weights, support, momenta, warped
templates and the L-BFGS lanes of Reg_opt and of each structure's
Template_opt) and ``AffinePSRStd`` (template, weights, M, t and the lanes).

``twoset_out_from_numpy`` takes the state between two point-sharded two-set
steps (the JAX package's ``TwosetStepOut``, gathered) to one rank's
``parallel.twoset.TwosetStepOut``.
"""

from __future__ import annotations

import numpy as np
import torch

from difficp_torch.models.gmm import GMMState
from difficp_torch.utils.lbfgs import LBFGSMemory
from difficp_torch.utils.spec import as_tensor

_ARRAYS = ("a0", "q0", "qmask", "x0", "xmask", "x1", "y", "ptw", "M", "t")
_LANE_STATE = ("_reg_alpha", "_reg_alpha_qn")
_SUPPORT = ("support_scheme", "rho")


def gmm_state_from_numpy(mu, w, sigma, eta0, vol0, device) -> GMMState:
    """GMMState on ``device`` from the JAX GMMState's fields as numpy."""
    return GMMState(*(as_tensor(f, device) for f in (mu, w, sigma, eta0, vol0)))


def memory_from_numpy(mem: dict, device) -> LBFGSMemory:
    return LBFGSMemory(
        S=as_tensor(mem["S"], device), Y=as_tensor(mem["Y"], device),
        rho=as_tensor(mem["rho"], device),
        pos=as_tensor(mem["pos"], device, torch.long),
        count=as_tensor(mem["count"], device, torch.long))


def twoset_out_from_numpy(out: dict, rank: int, world: int, device):
    """This rank's ``TwosetStepOut`` from the JAX package's ``TwosetStepOut``
    fields as numpy: ``gmm`` (a dict of the GMMState fields), the point arrays
    ``a0``, ``x1`` (and ``y``) of the whole set, cut as ``shard_twoset`` cuts
    them, the scalars ``alpha`` (and ``cfe``, ``fe``, ``trajl``, ``quad``)
    and ``memory`` (a dict of the LBFGSMemory fields with S, Y (m, n) over
    the whole raveled momenta, or None).  Missing entries are None."""
    from difficp_torch.parallel.twoset import TwosetStepOut, rank_block

    def block(a):
        return as_tensor(rank_block(a, rank, world), device).contiguous()

    def scalar(name):
        return None if out.get(name) is None else as_tensor(out[name], device)

    a0 = out["a0"]
    mem = out.get("memory")
    if mem is not None:
        m = mem["S"].shape[0]

        def rows(t):  # (m, n) over the whole set -> (1, m, this rank's n)
            return block(t.reshape(m, *a0.shape).swapaxes(0, 1)).swapaxes(0, 1).reshape(
                1, m, -1).contiguous()

        mem = LBFGSMemory(S=rows(mem["S"]), Y=rows(mem["Y"]),
                          rho=as_tensor(mem["rho"], device)[None],
                          pos=as_tensor(mem["pos"], device, torch.long).reshape(1),
                          count=as_tensor(mem["count"], device, torch.long).reshape(1))
    g = out["gmm"]
    return TwosetStepOut(
        gmm=gmm_state_from_numpy(g["mu"], g["w"], g["sigma"], g["eta0"], g["vol0"], device),
        a0=block(a0), x1=block(out["x1"]),
        y=None if out.get("y") is None else block(out["y"]),
        cfe=scalar("cfe"), fe=scalar("fe"), trajl=scalar("trajl"), quad=scalar("quad"),
        alpha=scalar("alpha"), memory=mem)


def load_psr_state(psr, arrays: dict):
    """Load a mid-run state into a port ``DiffPSR`` or ``AffinePSR`` of the
    same shapes.

    ``arrays`` keys: ``gmm`` (list over structures of dicts mu/w/sigma/eta0/
    vol0), the arrays of ``_ARRAYS`` (an affine state's M and t, a
    diffeomorphic one's momenta and support), ``support_scheme`` and ``rho``,
    ``Cfe`` (list) and ``FE``, and the threaded ``_reg_alpha``, ``_reg_alpha_qn``, ``_reg_memory`` (dict) and
    ``_reg_stall``, each optional (None = cold).  The threaded entry
    (value, grad) is not carried: the next ``Reg_opt`` re-evaluates it."""
    dev = psr.device
    psr.gmm = [gmm_state_from_numpy(g["mu"], g["w"], g["sigma"], g["eta0"],
                                    g["vol0"], dev) for g in arrays["gmm"]]
    for name in _ARRAYS:
        if arrays.get(name) is not None:
            setattr(psr, name, as_tensor(arrays[name], dev))
    for name in _SUPPORT:
        if name in arrays:
            setattr(psr, name, arrays[name])
    if "Cfe" in arrays:
        psr.Cfe = [as_tensor(c, dev) for c in arrays["Cfe"]]
    for name in _LANE_STATE:
        val = arrays.get(name)
        setattr(psr, name, None if val is None else as_tensor(val, dev))
    mem = arrays.get("_reg_memory")
    psr._reg_memory = None if mem is None else memory_from_numpy(mem, dev)
    stall = arrays.get("_reg_stall")
    psr._reg_stall = None if stall is None else as_tensor(stall, dev, torch.bool)
    psr._reg_vg = None
    psr._update_quadlosses()
    if "FE" in arrays:
        psr.FE = None if arrays["FE"] is None else float(arrays["FE"])
    # the loaded momenta, warped points and free energy belong together: no
    # start free energy is pending
    psr._start_pending = False
    return psr


def psr_state_to_numpy(psr) -> dict:
    """The state ``load_psr_state`` reads, as numpy arrays."""
    host = lambda t: None if t is None else t.detach().cpu().numpy()  # noqa: E731
    out = {"gmm": [{f: host(getattr(g, f)) for f in GMMState._fields}
                   for g in psr.gmm]}
    for name in _ARRAYS + _LANE_STATE + ("_reg_stall",):
        out[name] = host(getattr(psr, name, None))
    for name in _SUPPORT:
        out[name] = getattr(psr, name, None)
    out["Cfe"] = [host(c) for c in psr.Cfe]
    mem = getattr(psr, "_reg_memory", None)
    out["_reg_memory"] = None if mem is None else {
        f: host(getattr(mem, f)) for f in LBFGSMemory._fields}
    out["FE"] = psr.FE
    return out



_STD_ARRAYS = ("q0", "a0", "y1", "M", "t")
_STD_LANES = ("_reg_alpha", "_reg_alpha_qn")
_STD_TMPL_LANES = ("_tmpl_alpha", "_tmpl_alpha_qn")


def _lane_memory(mem: dict, device) -> LBFGSMemory:
    """A memory dict with or without its lane axis (the JAX package keeps one
    lane's memory unbatched: S (m, n), pos and count scalars)."""
    if mem["S"].ndim == 2:
        mem = {"S": mem["S"][None], "Y": mem["Y"][None], "rho": mem["rho"][None],
               "pos": np.reshape(mem["pos"], (1,)), "count": np.reshape(mem["count"], (1,))}
    return memory_from_numpy(mem, device)


def load_std_state(psr, arrays: dict):
    """Load a mid-run state into a port ``DiffPSRStd`` or ``AffinePSRStd`` of
    the same shapes.

    ``arrays`` keys, each optional (None = cold): ``y0`` and ``w0`` (lists over
    structures), the arrays of ``_STD_ARRAYS`` (a diffeomorphic state's
    support q0 (M, D), momenta a0 and warped templates y1 (K, Ny, D); an
    affine one's M and t), ``support_scheme`` and ``rho``, the lanes
    ``_reg_alpha`` and ``_reg_alpha_qn`` (K,), ``_tmpl_alpha`` and
    ``_tmpl_alpha_qn`` (lists over structures of one lane each),
    ``_reg_memory`` (a dict of the LBFGSMemory fields), ``_tmpl_mem`` (a list
    of such dicts or None, with or without the lane axis), ``regloss`` (K,),
    ``dataloss`` (K, S) and ``E``.  The threaded entries (value, grad) are not
    carried: the next step re-evaluates them."""
    dev = psr.device
    if arrays.get("y0") is not None:
        psr.y0 = [as_tensor(y, dev) for y in arrays["y0"]]
    if arrays.get("w0") is not None:
        psr.w0 = [None if w is None else as_tensor(w, dev) for w in arrays["w0"]]
    for name in _STD_ARRAYS:
        if arrays.get(name) is not None:
            setattr(psr, name, as_tensor(arrays[name], dev))
    for name in _SUPPORT:
        if name in arrays:
            setattr(psr, name, arrays[name])
    for name in _STD_LANES:
        val = arrays.get(name)
        setattr(psr, name, None if val is None else as_tensor(val, dev))
    for name in _STD_TMPL_LANES:
        val = arrays.get(name)
        setattr(psr, name, None if val is None else [
            None if v is None else as_tensor(v, dev).reshape(1) for v in val])
    mem = arrays.get("_reg_memory")
    psr._reg_memory = None if mem is None else memory_from_numpy(mem, dev)
    mems = arrays.get("_tmpl_mem")
    psr._tmpl_mem = None if mems is None else [
        None if m is None else _lane_memory(m, dev) for m in mems]
    psr._reg_vg = psr._tmpl_vg = None
    if arrays.get("regloss") is not None:
        psr.regloss = np.asarray(arrays["regloss"], np.float64)
    if arrays.get("dataloss") is not None:
        psr.dataloss = np.asarray(arrays["dataloss"], np.float64)
    if "E" in arrays:
        psr.E = None if arrays["E"] is None else float(arrays["E"])
    return psr


def std_state_to_numpy(psr) -> dict:
    """The state ``load_std_state`` reads, as numpy arrays."""
    host = lambda t: None if t is None else t.detach().cpu().numpy()  # noqa: E731

    def memory(mem):
        return None if mem is None else {f: host(getattr(mem, f)) for f in LBFGSMemory._fields}

    out = {"y0": [host(y) for y in psr.y0],
           "w0": [host(w) for w in psr.w0] if psr.template_weights else None}
    for name in _STD_ARRAYS + _STD_LANES:
        out[name] = host(getattr(psr, name, None))
    for name in _SUPPORT:
        out[name] = getattr(psr, name, None)
    for name in _STD_TMPL_LANES:
        val = getattr(psr, name, None)
        out[name] = None if val is None else [host(v) for v in val]
    out["_reg_memory"] = memory(getattr(psr, "_reg_memory", None))
    mems = getattr(psr, "_tmpl_mem", None)
    out["_tmpl_mem"] = None if mems is None else [memory(m) for m in mems]
    out["regloss"] = np.asarray(psr.regloss, np.float64)
    out["dataloss"] = np.asarray(psr.dataloss, np.float64)
    out["E"] = psr.E
    return out
