"""Standard (template-based) atlas building (counterpart of
``difficp_tpu/api/standard_atlas.py``; reference standard_atlas.py:60-230):
per-frame Reg_opt and a common Template_opt alternate on the RKHS measure
distance; LDDMM lambda = 2.0, "classic" (the Deformetrica convention).

model_parameters: {"sigma_data" (None: the mean intrinsic scale of the
sets), "noise_std" (a value, or "auto": the harmonic mean of
``calibrate_noise_std`` over up to 10 consecutive frame pairs, first
structure), "sigma_LDDMM", "use_template_weights"}.
initial_template: a frame index, or explicit template points (one array per
structure).

:return: (PSR object, evol dict with per-iteration templates, a0 (and w0),
    as numpy)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from difficp_torch.api import common
from difficp_torch.models import lddmm as lddmm_mod
from difficp_torch.models.psr_standard import DiffPSRStd
from difficp_torch.utils.io import read_point_sets
from difficp_torch.utils.point_sets import intrinsic_scale
from difficp_torch.utils.spec import as_tensor, resolve_device


def standard_atlas(
    x,
    initial_template=0,
    model_parameters: dict = None,
    numerical_options: Optional[dict] = None,
    optim_options: Optional[dict] = None,
    callback_function=None,
    printstuff: bool = True,
    device=None,
):
    model_parameters = dict(model_parameters or {})
    if not {"sigma_data", "noise_std", "sigma_LDDMM"}.issubset(model_parameters):
        raise ValueError("model_parameters needs sigma_data, noise_std and sigma_LDDMM")
    common.set_default(model_parameters, "use_template_weights", False)
    device = resolve_device(device)

    numerical_options = common.default_numerical_options(numerical_options)
    optim_options = common.default_optim_options(optim_options)
    common.set_default(optim_options, "start_by_template_opt", False)
    tol = optim_options["convergence_tolerance"]

    nested, k_frames, s_structs, d = read_point_sets(x)

    if model_parameters["sigma_data"] is None:
        model_parameters["sigma_data"] = sum(
            intrinsic_scale(as_tensor(nested[k][s], device))
            for k in range(k_frames) for s in range(s_structs)) / (k_frames * s_structs)

    if isinstance(initial_template, int):
        initial_template = nested[initial_template]

    noise_std = model_parameters["noise_std"]
    sig = model_parameters["sigma_LDDMM"]
    if noise_std == "auto":
        noise_std = _calibrated_noise_std(nested, k_frames, sig, printstuff, device)

    lcfg = lddmm_mod.make_config(
        sigma=sig, lambd=2.0, version="classic",
        nt=numerical_options["integration_nt_LDDMM"],
        scheme=numerical_options["integration_scheme_LDDMM"],
    )
    psr = DiffPSRStd(nested, initial_template, noise_std, lcfg,
                     data_sigma=model_parameters["sigma_data"],
                     template_weights=model_parameters["use_template_weights"],
                     device=device)
    supp = numerical_options["support_LDDMM"]
    if supp["scheme"] != "dense":
        psr.set_support_scheme(**supp)
    psr.printstuff = printstuff

    evol = {"a0": [], "y0": []}
    if model_parameters["use_template_weights"]:
        evol["w0"] = []

    last_e = None
    for it in range(optim_options["max_iterations"]):
        if printstuff:
            print("ITERATION NUMBER ", it)
        evol["y0"].append([psr.get_template(s) for s in range(psr.S)])
        common.snapshot_registration(psr, evol, True)
        if model_parameters["use_template_weights"]:
            evol["w0"].append([w.detach().cpu().numpy() for w in psr.w0])

        if callback_function is not None:
            callback_function(psr, True)
        if not (it == 1 and optim_options["start_by_template_opt"]):
            if printstuff:
                print("Updating diffeomorphisms (all frames in lockstep).")
            psr.Reg_opt(nmax=1, tol=tol, carry_memory=numerical_options["carry_memory_LDDMM"])
        if callback_function is not None:
            callback_function(psr, False)
        if printstuff:
            print("Updating (common) template.")
        psr.Template_opt(nmax=1, tol=tol)

        if it > 1 and abs(psr.E - last_e) < tol * abs(last_e):
            if printstuff:
                print("Difference in energy is below tolerance threshold : "
                      "optimization is over.")
            break
        last_e = psr.E

    return psr, evol


def _calibrated_noise_std(nested, k_frames, sigma_lddmm, printstuff, device) -> float:
    """noise_std="auto" (standard_atlas.py:60-230 of the JAX package): the
    harmonic mean of ``calibrate_noise_std`` of frame i onto frame i + 1
    (first structure) over min(K - 1, 10) pairs; a pair that raises or gives
    a value that is not finite is skipped, and RuntimeError if none is left.
    A kernel launch failure, a CUDA fault or running out of device memory is
    raised, not skipped."""
    from difficp_torch.models.calibration import calibrate_noise_std
    from difficp_torch.ops.rhs_self import DEVICE_FAULTS

    if printstuff:
        print("Automatic calibration of noise_std (ad hoc)...")
    vals = []
    for i in range(min(k_frames - 1, 10)):
        try:
            vals.append(calibrate_noise_std(nested[i][0], nested[i + 1][0], sigma_lddmm,
                                            device=device))
        except DEVICE_FAULTS:
            raise
        except Exception as e:  # a failed pair is skipped, as in the JAX package
            if printstuff:
                print(f"    calibration pair {i} failed: {e!r}")
    vals = np.asarray([v for v in vals if np.isfinite(v)])
    if vals.size == 0:
        raise RuntimeError(
            "noise_std='auto' calibration failed on every frame pair. Pass an "
            "explicit noise_std value.")
    noise_std = float(1.0 / np.mean(1.0 / vals))
    if printstuff:
        print(f"    noise_std = {noise_std}")
    return noise_std
