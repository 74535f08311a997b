"""State carried across between the JAX package and the port, as numpy arrays.

``load_psr_state`` puts a mid-run ``DiffPSR`` state (GMMs, momenta, points,
targets and the L-BFGS state threaded between ``Reg_opt`` calls) into a port
``DiffPSR``, so both packages can continue from the same point;
``psr_state_to_numpy`` is the reverse.  Arrays are keyed by the attribute
names both packages use; a GMM is a dict of its five fields and the curvature
memory a dict of the ``LBFGSMemory`` fields.
"""

from __future__ import annotations

import torch

from difficp_torch.models.gmm import GMMState
from difficp_torch.utils.lbfgs import LBFGSMemory
from difficp_torch.utils.spec import as_tensor

_ARRAYS = ("a0", "q0", "qmask", "x0", "xmask", "x1", "y", "ptw")
_LANE_STATE = ("_reg_alpha", "_reg_alpha_qn")


def gmm_state_from_numpy(mu, w, sigma, eta0, vol0, device) -> GMMState:
    """GMMState on ``device`` from the JAX GMMState's fields as numpy."""
    return GMMState(*(as_tensor(f, device) for f in (mu, w, sigma, eta0, vol0)))


def memory_from_numpy(mem: dict, device) -> LBFGSMemory:
    return LBFGSMemory(
        S=as_tensor(mem["S"], device), Y=as_tensor(mem["Y"], device),
        rho=as_tensor(mem["rho"], device),
        pos=as_tensor(mem["pos"], device, torch.long),
        count=as_tensor(mem["count"], device, torch.long))


def load_psr_state(psr, arrays: dict):
    """Load a mid-run state into a port ``DiffPSR`` of the same shapes.

    ``arrays`` keys: ``gmm`` (list over structures of dicts mu/w/sigma/eta0/
    vol0), the point arrays of ``_ARRAYS``, ``Cfe`` (list) and ``FE``, and
    the threaded ``_reg_alpha``, ``_reg_alpha_qn``, ``_reg_memory`` (dict) and
    ``_reg_stall``, each optional (None = cold).  The threaded entry
    (value, grad) is not carried: the next ``Reg_opt`` re-evaluates it."""
    dev = psr.device
    psr.gmm = [gmm_state_from_numpy(g["mu"], g["w"], g["sigma"], g["eta0"],
                                    g["vol0"], dev) for g in arrays["gmm"]]
    for name in _ARRAYS:
        if name in arrays:
            setattr(psr, name, as_tensor(arrays[name], dev))
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
    return psr


def psr_state_to_numpy(psr) -> dict:
    """The state ``load_psr_state`` reads, as numpy arrays."""
    host = lambda t: None if t is None else t.detach().cpu().numpy()  # noqa: E731
    out = {"gmm": [{f: host(getattr(g, f)) for f in GMMState._fields}
                   for g in psr.gmm]}
    for name in _ARRAYS + _LANE_STATE + ("_reg_stall",):
        out[name] = host(getattr(psr, name, None))
    out["Cfe"] = [host(c) for c in psr.Cfe]
    mem = getattr(psr, "_reg_memory", None)
    out["_reg_memory"] = None if mem is None else {
        f: host(getattr(mem, f)) for f in LBFGSMemory._fields}
    out["FE"] = psr.FE
    return out

