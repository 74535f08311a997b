"""diffICP_basic: one spiral point set registered onto a FIXED spiral GMM,
sigma optimized (counterpart of ``difficp_tpu/examples/run_basic.py``;
reference examples/diffICP_basic.py).

Run:  python -m difficp_torch.examples.run_basic [--iters 20] [--device cpu] [--plot]

``--plot`` (needs matplotlib) draws the GMM, the warped points and the warped
grid into ``run_basic.png`` in the working directory.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from difficp_torch.examples.spiral import generate_spiral_point_sets, spiral_centroids
from difficp_torch.models import gmm, lddmm
from difficp_torch.models.psr import DiffPSR
from difficp_torch.utils.spec import resolve_device


def main(n_iter: int = 20, plot: bool = False, seed: int = 1234, device=None):
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x0, _, _ = generate_spiral_point_sets(gen, k=1, nk_bounds=(100, 101), sigma_gmm=0.025,
                                          sigma_lddmm=0.1, lambda_lddmm=1e2)
    state, _ = gmm.create(spiral_centroids(device=device), sigma=0.1, device=device)
    cfg = gmm.GMMConfig(optimize_mu=False, optimize_sigma=True, optimize_w=False,
                        optimize_eta0=False)
    lcfg = lddmm.make_config(sigma=0.2, lambd=5e2, version="classic", nt=10,
                             scheme="Euler")
    psr = DiffPSR(x0[0], state, cfg, lcfg, device=device)
    psr.set_support_scheme("grid", rho=float(np.sqrt(2.0)))

    for it in range(n_iter):
        print("ITERATION NUMBER ", it)
        psr.GMM_opt()
        psr.Reg_opt(tol=1e-5)
        print(f"  sigma: {float(psr.gmm[0].sigma):.5f}  FE: {psr.FE:.6f}")

    if plot:
        import matplotlib.pyplot as plt

        from difficp_torch.viz.grid import Gridlines
        from difficp_torch.viz.visu import get_bounds, my_scatter, plot_gmm

        x1 = psr.get_warped_data_points()
        bounds = get_bounds(x0[0], psr.gmm[0].mu, relmargin=0.1)
        plot_gmm(psr.gmm[0], bounds=bounds)
        my_scatter(x1, color="red")
        gl = Gridlines(np.linspace(bounds[0], bounds[1], 10),
                       np.linspace(bounds[2], bounds[3], 10))
        gl.register(psr.Registration()).plot(color=(0.8, 0.5, 0.5), linewidth=1)
        plt.savefig("run_basic.png", dpi=120)
        print("saved run_basic.png")
    return psr


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    main(n_iter=args.iters, plot=args.plot, device=args.device)
