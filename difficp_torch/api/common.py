"""Shared helpers for the api layer (counterpart of
``difficp_tpu/api/common.py``): config-dict defaulting and model construction
from the reference's parameter schema."""

from __future__ import annotations

from typing import Optional

import numpy as np

from difficp_torch.models import gmm as gmm_mod
from difficp_torch.models import lddmm as lddmm_mod
from difficp_torch.ops import backend as backend_mod

ALLOWED_REG_TYPES = ("rigid", "similarity", "general_affine", "diffeomorphic")

# computversion values: the JAX package's and the reference's spellings
# (kernel.py:91-110); "pallas" names the hand-written kernel route here
_COMPUTVERSION_MAP = {
    "auto": None, None: None,
    "dense": "dense", "torch": "dense",
    "blockwise": "blockwise", "keops": "blockwise",
    "pallas": "kernel",
}

DEFAULT_SUPPORT_SCHEME = {"scheme": "grid", "rho": 1.0}


def set_default(dico: dict, key, value):
    """Reference's defaulting helper (ICP_two_set.py:141-143)."""
    if dico.get(key) is None:
        dico[key] = value


def default_numerical_options(numerical_options: Optional[dict]) -> dict:
    """Numerical option defaults shared by every api function
    (ICP_two_set.py:145-153)."""
    opts = dict(numerical_options or {})
    set_default(opts, "support_LDDMM", dict(DEFAULT_SUPPORT_SCHEME))
    set_default(opts, "computversion", "auto")
    set_default(opts, "gradcomponent_LDDMM", False)
    set_default(opts, "integration_scheme_LDDMM", "Euler")
    set_default(opts, "integration_nt_LDDMM", 10)
    if opts.get("backward_precision") is not None:
        raise ValueError(
            "backward_precision has nothing to choose here: the port has one "
            "backward, a direct pair sum with no cancellation floor")
    set_default(opts, "carry_memory_LDDMM", False)
    set_default(opts, "frame_chunk_LDDMM", None)
    apply_computversion(opts["computversion"])
    return opts


def apply_computversion(value):
    """Route the api 'computversion' key to the global backend switch."""
    if value not in _COMPUTVERSION_MAP:
        raise ValueError(
            f"computversion={value!r}: expected one of "
            f"{sorted(str(k) for k in _COMPUTVERSION_MAP)}")
    backend_mod.set_backend(_COMPUTVERSION_MAP[value])


def default_optim_options(optim_options: Optional[dict]) -> dict:
    opts = dict(optim_options or {})
    set_default(opts, "max_iterations", 25)
    set_default(opts, "convergence_tolerance", 1e-3)
    set_default(opts, "max_repeat_GMM", 10)
    return opts


def build_lddmm_config(registration_parameters, numerical_options, lam) -> lddmm_mod.LDDMMConfig:
    return lddmm_mod.make_config(
        sigma=registration_parameters["sigma_LDDMM"],
        lambd=lam,
        gradcomponent=numerical_options["gradcomponent_LDDMM"],
        withlogdet=True,
        nt=numerical_options["integration_nt_LDDMM"],
        scheme=numerical_options["integration_scheme_LDDMM"],
    )


def gmm_from_two_set_params(x_b, gmm_parameters: dict, device):
    """GMM with mu fixed at xB, per ICP_two_set semantics
    (ICP_two_set.py:175-187)."""
    use_outliers = gmm_parameters.get("outlier_weight") is not None
    state, cfg = gmm_mod.create(np.asarray(x_b, np.float32),
                                sigma=gmm_parameters["sigma"],
                                use_outliers=use_outliers, device=device)
    if isinstance(gmm_parameters.get("outlier_weight"), (int, float)):
        state = state._replace(eta0=state.eta0.new_tensor(
            float(gmm_parameters["outlier_weight"])))
    cfg = cfg._replace(
        optimize_mu=False,
        optimize_sigma=bool(gmm_parameters["optimize_sigma"]),
        optimize_w=False,
        optimize_eta0=gmm_parameters.get("outlier_weight") == "optimize",
    )
    return state, cfg
