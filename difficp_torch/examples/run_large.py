"""Flagship scale demo: two-set diffeomorphic registration at 65k+ points on
one card (counterpart of ``difficp_tpu/examples/run_large.py``).

Dense support (support = all data points): every ODE evaluation is one pass
of the fused self-RHS kernel over M^2 pairs (4.3e9 at M = 65,536), and every
gradient one pass of its backward kernel.

Run:  python -m difficp_torch.examples.run_large --points 65536 --iters 3
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from difficp_torch.models import gmm, lddmm
from difficp_torch.models.psr import DiffPSR
from difficp_torch.utils.spec import resolve_device


def spiral_cloud(n, rng, noise=0.02, dim=2):
    t = rng.uniform(0, 2 * np.pi, size=n).astype(np.float32)
    cols = [0.5 + 0.4 * (t / 7) * np.cos(t), 0.5 + 0.3 * np.sin(t)]
    if dim == 3:
        # helix: the 2D spiral lifted along z
        cols.append(0.5 + 0.25 * (t / (2 * np.pi)))
    pts = np.stack(cols, 1) + noise * rng.normal(size=(n, dim))
    return pts.astype(np.float32)


def warp(x, dim):
    if dim == 2:
        d = np.stack([np.sin(3 * x[:, 1]), np.cos(3 * x[:, 0])], 1)
    else:
        d = np.stack([np.sin(3 * x[:, 1]), np.cos(3 * x[:, 2]),
                      np.sin(3 * x[:, 0])], 1)
    return x + 0.05 * d.astype(np.float32)


def main(n_points=131072, n_iter=3, c_gmm=64, inner=None, ls_steps=25,
         dim=2, device=None, on_iter=None):
    """Run ``n_iter`` outer iterations of GMM_opt(10) + 2 x Reg_opt(nmax=1,
    carry_memory, carry_value).  ``on_iter(it, psr, seconds)`` is called after
    each outer iteration (reporting)."""
    if inner is None:
        inner = 1 if n_points > 100_000 else 2
    rng = np.random.default_rng(0)
    x_a = spiral_cloud(n_points, rng, dim=dim)
    # target: a warped copy (smooth sinusoidal deformation)
    x_b = warp(spiral_cloud(n_points, rng, dim=dim), dim)

    # GMM over the target with C components (sub-sampled centroids)
    mu0 = x_b[rng.integers(0, n_points, c_gmm)]
    psr_device = resolve_device(device)
    state, _ = gmm.create(mu0, sigma=0.05, device=psr_device)
    gcfg = gmm.GMMConfig(optimize_mu=True, optimize_sigma=True,
                         optimize_w=True, optimize_eta0=False)
    lcfg = lddmm.make_config(sigma=0.1, lambd=200.0, version="hybrid",
                             nt=10, scheme="Euler")
    psr = DiffPSR(x_a, state, gcfg, lcfg, device=psr_device)
    psr.printstuff = True

    for it in range(n_iter):
        t0 = time.perf_counter()
        psr.GMM_opt(max_iterations=10, tol=1e-3)
        # several short registration calls per outer iteration, threading the
        # curvature memory and the accepted (loss, grad, arrival) across them;
        # GMM_opt invalidates the carried value (the objective changed)
        for _ in range(2):
            psr.Reg_opt(tol=1e-3, nmax=1, inner=inner, ls_steps=ls_steps,
                        carry_memory=True, carry_value=True)
        seconds = time.perf_counter() - t0
        print(f"iter {it}: {seconds:.1f}s FE={psr.FE:.1f}")
        if on_iter is not None:
            on_iter(it, psr, seconds)
    return psr


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=131072)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--inner", type=int, default=None)
    ap.add_argument("--ls", type=int, default=25,
                    help="line-search eval budget per Reg_opt call")
    ap.add_argument("--dim", type=int, default=2, choices=(2, 3))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    main(n_points=args.points, n_iter=args.iters, inner=args.inner,
         ls_steps=args.ls, dim=args.dim, device=args.device)
