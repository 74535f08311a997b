"""diffICP_multi: groupwise atlas of K spiral point sets with the GMM
inferred by EM (counterpart of ``difficp_tpu/examples/run_multi.py``;
reference examples/diffICP_multi.py).

Run:  python -m difficp_torch.examples.run_multi [--frames 10] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from difficp_torch.api.icp_atlas import icp_atlas
from difficp_torch.examples.spiral import generate_spiral_point_sets
from difficp_torch.utils.spec import resolve_device


def main(k: int = 10, n_iter: int = 25, seed: int = 1234, nk_bounds=(100, 141),
         device=None):
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x0, _, _ = generate_spiral_point_sets(gen, k=k, nk_bounds=nk_bounds, sigma_gmm=0.025,
                                          sigma_lddmm=0.1, lambda_lddmm=1e2)
    psr, evol = icp_atlas(
        x0,
        GMM_parameters={"init_components": ("set", 0),
                        "optimize_weights": True, "outlier_weight": None},
        registration_parameters={"type": "diffeomorphic",
                                 "lambda_LDDMM": 5e2, "sigma_LDDMM": 0.2},
        numerical_options={"support_LDDMM": {"scheme": "grid", "rho": 1.0}},
        optim_options={"max_iterations": n_iter,
                       "convergence_tolerance": 1e-3, "max_repeat_GMM": 25},
        device=device,
    )
    print("final FE:", psr.FE, " sigma:", float(psr.gmm[0].sigma))
    return psr, evol


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    main(k=args.frames, n_iter=args.iters, device=args.device)
