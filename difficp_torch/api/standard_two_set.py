"""Standard (template-deforms) two-set registration (counterpart of
``difficp_tpu/api/standard_two_set.py``; reference standard_two_set.py:60-223).

The template xA is deformed onto the fixed data xB under the RKHS measure
distance; LDDMM takes lambda = 2.0 and version "classic", the Deformetrica
convention (standard_two_set.py:139-147).

model_parameters: {"type" ("diffeomorphic", "rigid", "similarity",
"general_affine"), "sigma_data", "noise_std" (default 1), "sigma_LDDMM"};
numerical_options / optim_options as in the other entry points, plus
optim_options["nmax_per_iter"] (default 10).

:return: (PSR object, evol dict with per-iteration templates and a0 (or M and
    t), as numpy)
"""

from __future__ import annotations

from typing import Optional

from difficp_torch.api import common
from difficp_torch.models import affine as affine_mod
from difficp_torch.models import lddmm as lddmm_mod
from difficp_torch.models.psr_standard import AffinePSRStd, DiffPSRStd
from difficp_torch.utils.spec import resolve_device


def standard_two_set(
    x_a,
    x_b,
    model_parameters: dict,
    numerical_options: Optional[dict] = None,
    optim_options: Optional[dict] = None,
    printstuff: bool = True,
    callback_function=None,
    device=None,
):
    is_diff = model_parameters.get("type") == "diffeomorphic"
    need = {"sigma_data", "noise_std", "sigma_LDDMM"} if is_diff else {"type", "sigma_data"}
    if not need.issubset(model_parameters):
        raise ValueError(f"model_parameters needs {sorted(need)}")
    device = resolve_device(device)

    model_parameters = dict(model_parameters)
    common.set_default(model_parameters, "noise_std", 1)
    numerical_options = common.default_numerical_options(numerical_options)
    optim_options = common.default_optim_options(optim_options)
    common.set_default(optim_options, "nmax_per_iter", 10)
    tol = optim_options["convergence_tolerance"]

    if is_diff:
        lcfg = lddmm_mod.make_config(
            sigma=model_parameters["sigma_LDDMM"],
            lambd=2.0,  # Deformetrica convention (standard_two_set.py:144)
            version="classic",
            nt=numerical_options["integration_nt_LDDMM"],
            scheme=numerical_options["integration_scheme_LDDMM"],
        )
        psr = DiffPSRStd(x_b, x_a, model_parameters["noise_std"], lcfg,
                         data_sigma=model_parameters["sigma_data"], device=device)
        supp = numerical_options["support_LDDMM"]
        if supp["scheme"] != "dense":
            psr.set_support_scheme(**supp)
        evol = {"a0": [], "y0": []}
    else:
        acfg = affine_mod.AffineConfig(version=model_parameters["type"], withlogdet=False,
                                       with_t=True)
        psr = AffinePSRStd(x_b, x_a, model_parameters["noise_std"], acfg,
                           data_sigma=model_parameters["sigma_data"], device=device)
        evol = {"M": [], "t": [], "y0": []}

    psr.printstuff = printstuff

    last_e = None
    for it in range(optim_options["max_iterations"]):
        if printstuff:
            print("ITERATION NUMBER ", it)
        evol["y0"].append([psr.get_template(s) for s in range(psr.S)])
        common.snapshot_registration(psr, evol, is_diff)

        psr.Reg_opt(nmax=optim_options["nmax_per_iter"], tol=tol)
        if callback_function is not None:
            callback_function(psr, False)

        if it > 1 and abs(psr.E - last_e) < tol * abs(last_e):
            if printstuff:
                print("Difference in energy is below tolerance threshold : "
                      "optimization is over.")
            break
        last_e = psr.E

    if printstuff and it + 1 == optim_options["max_iterations"]:
        print("Reached maximum number of iterations (before reaching convergence threshold).")
    return psr, evol

