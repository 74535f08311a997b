"""ICP-based two-set registration (counterpart of
``difficp_tpu/api/icp_two_set.py``; reference ICP_two_set.py:73-288).

Point set xA is registered onto xB, whose points are the fixed centroids of a
GMM; the GMM sigma (and optionally an outlier weight) are optimized by EM
while the registration is optimized per alternation.

Ported: the diffeomorphic branch with ``support_LDDMM={"scheme": "dense"}``.
Affine types, grid/decim support and ``lambda_LDDMM="auto"`` raise
``NotImplementedError`` until their modules are ported.

:return: (PSR object, evol dict with per-iteration a0 / GMM snapshots)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from difficp_torch.api import common
from difficp_torch.models import gmm as gmm_mod
from difficp_torch.models.psr import DiffPSR
from difficp_torch.utils.spec import resolve_device


def icp_two_set(
    x_a,
    x_b,
    GMM_parameters: Optional[dict],
    registration_parameters: dict,
    numerical_options: Optional[dict] = None,
    optim_options: Optional[dict] = None,
    printstuff: bool = True,
    callback_function=None,
    device=None,
):
    reg_type = registration_parameters.get("type")
    if reg_type not in common.ALLOWED_REG_TYPES:
        raise ValueError(f"registration_parameters['type'] should be one of "
                         f"{common.ALLOWED_REG_TYPES}")
    if reg_type != "diffeomorphic":
        raise NotImplementedError(
            f"{reg_type!r} registration needs models/affine.py, which is not "
            "ported yet")
    if not {"lambda_LDDMM", "sigma_LDDMM"}.issubset(registration_parameters):
        raise ValueError("diffeomorphic registration needs lambda_LDDMM and sigma_LDDMM")
    device = resolve_device(device)

    # xB-as-GMM hack (ICP_two_set.py:121-126)
    is_gmm_b = (isinstance(x_b, tuple) and len(x_b) == 2
                and isinstance(x_b[0], gmm_mod.GMMState))
    if is_gmm_b:
        if GMM_parameters is not None:
            raise ValueError("set GMM_parameters=None with a GMM xB")
        gmm_state, gmm_cfg = x_b
    else:
        if not {"optimize_sigma", "sigma"}.issubset(GMM_parameters):
            raise ValueError("GMM_parameters needs at least sigma and optimize_sigma")
        ow = GMM_parameters.get("outlier_weight")
        if not (ow is None or ow == "optimize" or isinstance(ow, (int, float))):
            raise ValueError(f"outlier_weight={ow!r}")
        gmm_state, gmm_cfg = common.gmm_from_two_set_params(x_b, GMM_parameters, device)

    numerical_options = common.default_numerical_options(numerical_options)
    optim_options = common.default_optim_options(optim_options)
    tol = optim_options["convergence_tolerance"]
    supp = numerical_options["support_LDDMM"]
    if supp["scheme"] != "dense":
        raise NotImplementedError(
            f"support_LDDMM scheme {supp['scheme']!r} is not ported yet: it "
            "comes with the grid-support slice; pass {'scheme': 'dense'}")

    x_a = np.asarray(x_a, np.float32)
    lam = registration_parameters["lambda_LDDMM"]
    if lam == "auto":
        raise NotImplementedError(
            "lambda_LDDMM='auto' needs models/calibration.py, which is not "
            "ported yet")
    lcfg = common.build_lddmm_config(registration_parameters, numerical_options, lam)
    psr = DiffPSR(x_a, gmm_state, gmm_cfg, lcfg, device=device)
    evol = {"a0": [], "GMMi": []}
    psr.printstuff = printstuff

    last_fe = None
    for it in range(optim_options["max_iterations"]):
        if printstuff:
            print("ITERATION NUMBER ", it)
        evol["GMMi"].append(gmm_mod.GMMState(*(t.clone() for t in psr.gmm[0])))
        evol["a0"].append(psr.a0.detach().cpu().numpy())

        psr.GMM_opt(max_iterations=optim_options["max_repeat_GMM"], tol=tol)
        if callback_function is not None:
            callback_function(psr, True)
        psr.Reg_opt(tol=tol, nmax=10,
                    carry_memory=numerical_options["carry_memory_LDDMM"])
        if callback_function is not None:
            callback_function(psr, False)

        if it > 1 and abs(psr.FE - last_fe) < tol * abs(last_fe):
            if printstuff:
                print("Difference in Free Energy is below tolerance threshold : optimization is over.")
            break
        last_fe = psr.FE

    if printstuff and it + 1 == optim_options["max_iterations"]:
        print("Reached maximum number of iterations (before reaching convergence threshold).")
    return psr, evol
