"""ICP-based groupwise atlas building (counterpart of
``difficp_tpu/api/icp_atlas.py``; reference ICP_atlas.py:51-305).

K frames (x S structures) are registered to common GMM models whose
parameters (centroids, weights, sigma, outlier odds) are inferred by EM.

registration_parameters["type"] is "rigid", "similarity", "general_affine"
(``AffinePSR``) or "diffeomorphic" with dense, decim, grid (the default) or
custom ``support_LDDMM``; ``lambda_LDDMM="auto"`` takes the harmonic mean of
the calibrations of up to 10 consecutive frame pairs (first structure).
``GMM_parameters["init_components"]`` (ICP_atlas.py:95-203):
  - int N: ad hoc init with N components (re-initialized from the data);
  - ("set", i): point set x[i] as initial centroids;
  - {"set": i, "C": N}: a GMM of N components fitted to x[i] (``gmm.fit``,
    one per structure, start indices drawn from a generator seeded by
    ``seed`` on ``device``);
  - a list of (GMMState, GMMConfig) pairs (one per structure).

:return: (PSR object, evol dict)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from difficp_torch.api import common
from difficp_torch.models import gmm as gmm_mod
from difficp_torch.models.psr import AffinePSR, DiffPSR
from difficp_torch.utils.io import read_point_sets
from difficp_torch.utils.spec import as_tensor, resolve_device


def icp_atlas(
    x0,
    GMM_parameters: dict,
    registration_parameters: dict,
    numerical_options: Optional[dict] = None,
    optim_options: Optional[dict] = None,
    callback_function=None,
    printstuff: bool = True,
    seed: int = 0,
    device=None,
):
    init = GMM_parameters.get("init_components")
    if not (isinstance(init, int)
            or (isinstance(init, tuple) and init[0] == "set")
            or (isinstance(init, dict) and set(init.keys()) == {"set", "C"})
            or isinstance(init, list)):
        raise ValueError("Wrong format for GMM_parameters['init_components']")

    ow = GMM_parameters.get("outlier_weight")
    if not (ow is None or ow == "optimize" or isinstance(ow, (int, float))):
        raise ValueError(f"outlier_weight={ow!r}")
    fixed_sigma = GMM_parameters.get("fixed_sigma")
    if not (fixed_sigma is None or fixed_sigma > 0):
        raise ValueError(f"fixed_sigma={fixed_sigma!r}")

    reg_type = registration_parameters.get("type")
    if reg_type not in common.ALLOWED_REG_TYPES:
        raise ValueError(f"registration_parameters['type'] should be one of "
                         f"{common.ALLOWED_REG_TYPES}")
    is_diff = reg_type == "diffeomorphic"
    if is_diff and not {"lambda_LDDMM", "sigma_LDDMM"}.issubset(registration_parameters):
        raise ValueError("diffeomorphic registration needs lambda_LDDMM and sigma_LDDMM")
    device = resolve_device(device)

    numerical_options = common.default_numerical_options(numerical_options)
    optim_options = common.default_optim_options(optim_options)
    tol = optim_options["convergence_tolerance"]

    nested, k_frames, s_structs, d = read_point_sets(x0)

    ### GMM init modes (ICP_atlas.py:162-203)
    use_outliers = ow is not None
    opt_sigma = fixed_sigma is None
    opt_w = GMM_parameters.get("optimize_weights")
    opt_w = True if opt_w is None else opt_w
    ensure_continuum = bool(GMM_parameters.get("ensure_continuum") or False)
    reinit_mu, reinit_sigma = False, False

    gmm_states, gmm_cfgs = [], []
    if isinstance(init, int):
        for _ in range(s_structs):
            st, cfg = gmm_mod.create(np.zeros((init, d), np.float32), sigma=1.0,
                                     use_outliers=use_outliers, device=device)
            gmm_states.append(st)
            gmm_cfgs.append(cfg)
        reinit_mu, reinit_sigma = True, opt_sigma
    elif isinstance(init, tuple):
        i = init[1]
        for s in range(s_structs):
            st, cfg = gmm_mod.create(np.asarray(nested[i][s], np.float32),
                                     use_outliers=use_outliers, device=device)
            gmm_states.append(st)
            gmm_cfgs.append(cfg)
        reinit_sigma = opt_sigma
    elif isinstance(init, dict):
        i, c = init["set"], init["C"]
        gen = torch.Generator(device=device).manual_seed(seed)
        for s in range(s_structs):
            st, cfg = gmm_mod.fit(as_tensor(nested[i][s], device), c, gen,
                                  use_outliers=use_outliers)
            gmm_states.append(st)
            gmm_cfgs.append(cfg)
    else:
        for st, cfg in init:
            gmm_states.append(gmm_mod.GMMState(*(as_tensor(f, device) for f in st)))
            gmm_cfgs.append(cfg)

    for s in range(s_structs):
        st, cfg = gmm_states[s], gmm_cfgs[s]
        if isinstance(ow, (int, float)):
            st = st._replace(eta0=as_tensor(float(ow), device))
        cfg = cfg._replace(
            optimize_mu=True,
            optimize_sigma=opt_sigma,
            optimize_w=opt_w,
            optimize_eta0=(ow == "optimize"),
            ensure_continuum=ensure_continuum,
            use_outliers=use_outliers,
        )
        if not opt_sigma:
            st = st._replace(sigma=as_tensor(float(fixed_sigma), device))
        gmm_states[s], gmm_cfgs[s] = st, cfg

    ### Build the PSR object
    if is_diff:
        lam = registration_parameters["lambda_LDDMM"]
        if lam == "auto":
            lam = _calibrated_lambda(nested, k_frames, registration_parameters["sigma_LDDMM"],
                                     printstuff, device)
        lcfg = common.build_lddmm_config(registration_parameters, numerical_options, lam)
        psr = DiffPSR(nested, gmm_states, gmm_cfgs, lcfg, device=device)
        supp = numerical_options["support_LDDMM"]
        if supp["scheme"] != "dense":
            psr.set_support_scheme(**supp)
        evol = {"a0": [], "GMMi": []}
    else:
        psr = AffinePSR(nested, gmm_states, gmm_cfgs, common.build_affine_config(reg_type),
                        device=device)
        evol = {"M": [], "t": [], "GMMi": []}

    psr.reinitialize_GMM(do_mu=reinit_mu, do_sigma=reinit_sigma, seed=seed)
    psr.printstuff = printstuff

    ### Alternating loop (ICP_atlas.py:269-298)
    last_fe = None
    for it in range(optim_options["max_iterations"]):
        if printstuff:
            print("ITERATION NUMBER ", it)
        evol["GMMi"].append(gmm_mod.GMMState(*(t.clone() for t in psr.gmm[0])))
        common.snapshot_registration(psr, evol, is_diff)

        if it != 0 or reinit_mu:
            psr.GMM_opt(max_iterations=optim_options["max_repeat_GMM"], tol=tol)
        if callback_function is not None:
            callback_function(psr, True)
        if is_diff:
            psr.Reg_opt(tol=tol, nmax=10,
                        carry_memory=numerical_options["carry_memory_LDDMM"],
                        frame_chunk=numerical_options["frame_chunk_LDDMM"])
        else:
            psr.Reg_opt(tol=tol, nmax=1)
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


def _calibrated_lambda(nested, k_frames, sigma_lddmm, printstuff, device) -> float:
    """lambda_LDDMM="auto" (ICP_atlas.py:131-160): the harmonic mean of the
    calibrations of frame i onto frame i + 1 (first structure) over
    min(K - 1, 10) pairs; a pair that raises or gives a value that is not
    finite and positive is skipped, and RuntimeError if none is left.  A
    kernel launch failure, a CUDA fault or running out of device memory is
    raised, not skipped."""
    from difficp_torch.models import calibration
    from difficp_torch.ops.rhs_self import DEVICE_FAULTS

    if printstuff:
        print("Automatic calibration of lambda_LDDMM (ad hoc, unstable)...")
    lams = []
    for i in range(min(k_frames - 1, 10)):
        try:
            lams.append(calibration.calibrate_lambda_lddmm(
                nested[i][0], nested[i + 1][0], sigma_lddmm, device=device))
        except DEVICE_FAULTS:
            raise
        except Exception as e:  # a failed pair is skipped, as in the JAX package
            if printstuff:
                print(f"    calibration pair {i} failed: {e!r}")
    lams = np.asarray([v for v in lams if np.isfinite(v) and v > 0])
    if lams.size == 0:
        raise RuntimeError(
            "lambda_LDDMM='auto' calibration failed on every frame pair (all "
            "NaN/non-positive/raised). Pass an explicit lambda_LDDMM value.")
    lam = float(1.0 / np.mean(1.0 / lams))
    if printstuff:
        print(f"    lambda_LDDMM = {lam}")
    return lam
