"""Synthetic 'spiral' point sets, the reproducible fixture of the atlas demos
(counterpart of ``difficp_tpu/examples/spiral.py``; reference
diffICP/examples/generate_spiral_point_sets.py:25-71): a fixed 20-centroid
spiral GMM, each set a GMM sample pushed through a random LDDMM deformation
drawn from the Bayesian prior (ridge-regularized).

Drawn from an explicit ``torch.Generator``, on its device.  The draws are
torch's, not ``jax.random``'s: tests that need the JAX package's sets pass
them in as arrays.
"""

from __future__ import annotations

import math

import torch

from difficp_torch.models import gmm as gmm_mod
from difficp_torch.models import lddmm as lddmm_mod


def spiral_centroids(c: int = 20, device=None) -> torch.Tensor:
    """The fixed spiral formula (generate_spiral_point_sets.py:38-40)."""
    t = torch.linspace(0, 2 * math.pi, c + 1, device=device)[:-1]
    return torch.stack((0.5 + 0.4 * (t / 7) * torch.cos(t),
                        0.5 + 0.3 * torch.sin(t)), 1)


def warp_by_prior(lcfg, pts, generator):
    """pts (N, D) shot along a geodesic whose momenta are drawn from the
    prior (random_p "ridge", alpha = 10; above the dense pair limit its
    matrix-free rff_cg form): the arrival points."""
    a0 = lddmm_mod.random_p(lcfg, pts[None], generator, version="ridge", alpha=10.0)
    with torch.no_grad():
        final, _ = lddmm_mod.shoot(lcfg, pts[None], a0)
    return final.q[0]


def generate_spiral_point_sets(generator: torch.Generator, k: int = 10,
                               nk_bounds=(100, 121), sigma_gmm: float = 0.025,
                               sigma_lddmm: float = 0.1, lambda_lddmm: float = 1e2):
    """K spiral point sets, each a GMM sample warped by a random geodesic
    (generate_spiral_point_sets.py:53-71), on the generator's device.

    :return: (list of (N_k, D) numpy arrays, generative GMMState,
        generative LDDMMConfig)
    """
    dev = generator.device
    gmm_state, _ = gmm_mod.create(spiral_centroids(device=dev), sigma=sigma_gmm,
                                  device=dev)
    lcfg = lddmm_mod.make_config(sigma=sigma_lddmm, lambd=lambda_lddmm,
                                 version="classic", nt=10)
    nks = torch.randint(nk_bounds[0], nk_bounds[1], (k,), generator=generator,
                        device=dev).tolist()
    out = []
    for n in nks:
        xb = gmm_mod.sample(gmm_state, generator, n)
        out.append(warp_by_prior(lcfg, xb, generator).cpu().numpy())
    return out, gmm_state, lcfg
