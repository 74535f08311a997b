"""Bridge to the external Deformetrica package for cross-validation
(counterpart of ``difficp_tpu/api/deformetrica_atlas.py``).

API-compatible re-design of reference diffICP/api/deformetrica_atlas.py:59-225:
write point sets as VTK landmarks, run Deformetrica's
``estimate_deterministic_atlas`` (kernel widths x sqrt(2) to map conventions,
deformetrica_atlas.py:152-153,170), read back the estimated template /
control points / momenta, and replay them through our own shooting inside a
``DiffPSRStd`` -- the reference validated that trajectories then match
Deformetrica's "absolutely perfect" (deformetrica_atlas.py:288-290).

Deformetrica itself is an optional external dependency (not bundled); when
absent this raises a clear ImportError.  ``load_deformetrica_output``
replays a pre-computed Deformetrica output directory without the package
installed (useful for the parity check itself): the warped templates of all
frames come from one shoot with the frames on the leading axis, on the
PSR's device.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np
import torch

from difficp_torch.api import common
from difficp_torch.models import lddmm as lddmm_mod
from difficp_torch.models.psr_standard import DiffPSRStd
from difficp_torch.utils.io import read_point_sets
from difficp_torch.utils.spec import as_tensor, on_cpu
from difficp_torch.utils.vtk_io import read_landmarks, write_landmarks


def load_deformetrica_output(x, outdir: str, sigma_data: float,
                             noise_std: float, sigma_lddmm: float,
                             n_timepoints: int = 11, device=None):
    """Build a DiffPSRStd from a Deformetrica deterministic-atlas output dir
    (template vtk + ControlPoints.txt + Momenta.txt; reference
    deformetrica_atlas.py:189-213) on ``device`` (None: the card)."""
    nested, k_frames, s, d = read_point_sets(x)
    template = read_landmarks(
        os.path.join(
            outdir, "DeterministicAtlas__EstimatedParameters__Template_pointset.vtk"
        ),
        dim=d,
    )
    q0 = np.loadtxt(
        os.path.join(outdir, "DeterministicAtlas__EstimatedParameters__ControlPoints.txt")
    ).astype(np.float32).reshape(-1, d)
    nq = q0.shape[0]
    with open(
        os.path.join(outdir, "DeterministicAtlas__EstimatedParameters__Momenta.txt")
    ) as f:
        lines = [line for n, line in enumerate(f) if n > 1 and line.strip()]
    a0 = np.loadtxt(lines).astype(np.float32).reshape(-1, d)
    a0 = np.stack([a0[nq * i : nq * (i + 1)] for i in range(k_frames)])

    lcfg = lddmm_mod.make_config(sigma=sigma_lddmm, lambd=2.0,
                                 version="classic", scheme="Euler",
                                 nt=n_timepoints - 1)
    psr = DiffPSRStd(nested, template, noise_std, lcfg, data_sigma=sigma_data,
                     device=device)
    psr.set_support_scheme("custom", q0=q0)
    psr.a0 = as_tensor(a0, psr.device)
    # refresh warped templates / energies with the imported state
    with torch.no_grad():
        final, _ = lddmm_mod.shoot(lcfg, psr._frames(psr.q0), psr.a0,
                                   psr._frames(psr.ally0))
    psr.y1 = final.x
    psr.update_datalosses()
    psr.update_E()
    return psr


def deformetrica_atlas(
    x,
    initial_template=0,
    model_parameters: dict = None,
    numerical_options: Optional[dict] = None,
    estimator_options: Optional[dict] = None,
    workdir: str = "saving/last_deformetrica_tmp",
    keep_workdir: bool = False,
    device=None,
):
    """Run Deformetrica's deterministic atlas and wrap the result.

    :return: (DiffPSRStd with imported template/control points/momenta,
        iter_status list, shoot_defo trajectories read from Deformetrica's
        flow output)
    """
    try:
        import deformetrica as dfca
    except ImportError as e:
        raise ImportError(
            "deformetrica_atlas requires the external `deformetrica` package "
            "(pip install deformetrica on a supported platform); "
            "use load_deformetrica_output() to replay an existing output dir."
        ) from e

    model_parameters = dict(model_parameters or {})
    assert {"sigma_data", "noise_std", "sigma_LDDMM"}.issubset(model_parameters)
    numerical_options = dict(numerical_options or {})
    common.set_default(numerical_options, "dense_mode", False)
    common.set_default(numerical_options, "computversion", "torch")
    estimator_options = dict(estimator_options or {})
    common.set_default(estimator_options, "optimization_method_type", "GradientAscent")
    common.set_default(estimator_options, "max_iterations", 500)
    common.set_default(estimator_options, "convergence_tolerance", 1e-7)
    common.set_default(estimator_options, "initial_step_size", 1e-6)

    nested, k_frames, s, d = read_point_sets(x)
    if isinstance(initial_template, int):
        initial_template = nested[initial_template][0]

    datadir = os.path.join(workdir, "data")
    outdir = os.path.join(workdir, "out")
    os.makedirs(datadir, exist_ok=True)

    for k in range(k_frames):
        write_landmarks(
            os.path.join(datadir, f"point_set_{k}.vtk"),
            on_cpu(nested[k][0]),
        )
    write_landmarks(
        os.path.join(datadir, "initial_template.vtk"),
        on_cpu(initial_template),
    )

    dataset_specifications = {
        "dataset_filenames": [
            [{"pointset": os.path.join(datadir, f"point_set_{k}.vtk")}]
            for k in range(k_frames)
        ],
        "subject_ids": [str(i) for i in range(k_frames)],
    }
    template_specifications = {
        "pointset": {
            "deformable_object_type": "pointcloud",
            "kernel_type": numerical_options["computversion"],
            # Deformetrica kernels are exp(-|x|^2/w^2): width = sigma*sqrt(2)
            "kernel_width": model_parameters["sigma_data"] * np.sqrt(2),
            "noise_std": model_parameters["noise_std"],
            "filename": os.path.join(datadir, "initial_template.vtk"),
        }
    }
    iter_status = []

    def estimator_callback(status_dict):
        iter_status.append(status_dict)
        return True

    estimator_options["callback"] = estimator_callback
    model_options = {
        "dimension": d,
        "deformation_kernel_type": numerical_options["computversion"],
        "deformation_kernel_width": model_parameters["sigma_LDDMM"] * np.sqrt(2),
        "dense_mode": numerical_options["dense_mode"],
        "number_of_timepoints": 11,
        "dtype": "float32",
        "gpu_mode": dfca.GpuMode.NONE,
    }

    deformetrica = dfca.Deformetrica(output_dir=outdir, verbosity="INFO")
    deformetrica.estimate_deterministic_atlas(
        template_specifications, dataset_specifications,
        estimator_options=estimator_options, model_options=model_options,
    )

    psr = load_deformetrica_output(
        x, outdir, model_parameters["sigma_data"],
        model_parameters["noise_std"], model_parameters["sigma_LDDMM"],
        n_timepoints=model_options["number_of_timepoints"], device=device,
    )
    shoot_defo = [
        [
            read_landmarks(
                os.path.join(
                    outdir,
                    f"DeterministicAtlas__flow__pointset__subject_{k}__tp_{t}.vtk",
                ),
                dim=d,
            )
            for t in range(model_options["number_of_timepoints"])
        ]
        for k in range(k_frames)
    ]
    if not keep_workdir:
        shutil.rmtree(workdir, ignore_errors=True)
    return psr, iter_status, shoot_defo
