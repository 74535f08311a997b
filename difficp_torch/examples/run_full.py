"""diffICP_full: multi-structure atlas, K frames x S structures (spiral,
circle, bar), each frame warped by ONE diffeomorphism common to its
structures, each structure with its own GMM (counterpart of
``difficp_tpu/examples/run_full.py``; reference examples/diffICP_full.py).

Run:  python -m difficp_torch.examples.run_full [--frames 10] [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import torch

from difficp_torch.api.icp_atlas import icp_atlas
from difficp_torch.examples.spiral import spiral_centroids, warp_by_prior
from difficp_torch.models import gmm as gmm_mod
from difficp_torch.models import lddmm as lddmm_mod
from difficp_torch.utils.spec import resolve_device


def structure_centroids(device=None) -> list:
    """The three structures' generative centroids: a spiral of 20, a circle
    of 12 and a bar of 12 (diffICP_full.py:37-52)."""
    t = torch.linspace(0, 2 * math.pi, 13, device=device)[:-1]
    return [
        spiral_centroids(20, device),
        torch.stack([0.3 + 0.12 * torch.cos(t), 0.35 + 0.12 * torch.sin(t)], 1),
        torch.stack([torch.linspace(0.55, 0.85, 12, device=device),
                     torch.full((12,), 0.25, device=device)], 1),
    ]


def generate_multi_structure_frames(generator: torch.Generator, k: int = 10,
                                    n_bounds=(40, 51), sigma_gmm: float = 0.02,
                                    sigma_lddmm: float = 0.15,
                                    lambda_lddmm: float = 2e2):
    """K frames of S = 3 structures (spiral / circle / bar), drawn on the
    generator's device; all structures of a frame are advected by the same
    random geodesic (the generative model of diffICP_full.py:37-78).  Each
    structure of each frame holds a count of points drawn from
    [n_bounds[0], n_bounds[1]).

    :return: list over frames of lists over structures of (N, D) numpy arrays
    """
    dev = generator.device
    gmms = [gmm_mod.create(mu, sigma=sigma_gmm, device=dev)[0]
            for mu in structure_centroids(dev)]
    lcfg = lddmm_mod.make_config(sigma=sigma_lddmm, lambd=lambda_lddmm,
                                 version="classic", nt=10)
    frames = []
    for _ in range(k):
        ns = torch.randint(n_bounds[0], n_bounds[1], (len(gmms),), generator=generator,
                           device=dev).tolist()
        pts = [gmm_mod.sample(g, generator, n) for g, n in zip(gmms, ns)]
        warped = warp_by_prior(lcfg, torch.cat(pts), generator)
        frames.append([w.cpu().numpy() for w in torch.split(warped, ns)])
    return frames


def main(k: int = 10, n_iter: int = 15, seed: int = 0, n_bounds=(40, 51), device=None):
    device = resolve_device(device)
    frames = generate_multi_structure_frames(
        torch.Generator(device=device).manual_seed(seed), k=k, n_bounds=n_bounds)
    psr, evol = icp_atlas(
        frames,
        GMM_parameters={"init_components": ("set", 0),
                        "optimize_weights": True, "outlier_weight": None},
        registration_parameters={"type": "diffeomorphic",
                                 "lambda_LDDMM": 2e2, "sigma_LDDMM": 0.2},
        numerical_options={"support_LDDMM": {"scheme": "grid", "rho": 1.0}},
        optim_options={"max_iterations": n_iter,
                       "convergence_tolerance": 1e-3, "max_repeat_GMM": 25},
        device=device,
    )
    print("final FE:", psr.FE, " sigmas:", [float(g.sigma) for g in psr.gmm])
    return psr, evol


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    main(k=args.frames, n_iter=args.iters, device=args.device)
