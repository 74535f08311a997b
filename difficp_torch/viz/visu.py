"""Basic visualization helpers: 2D/3D scatter, bounds, GMM heatmap
(counterpart of ``difficp_tpu/viz/visu.py``; reference
diffICP/visualization/visu.py:35-83 and the GMM plotting of GMM.py:554-643,
heatmap and log-likelihood contours).  Matplotlib is imported lazily so that
headless and batch use of the package never touches it.  Point sets may be
arrays or tensors on any device; the GMM's densities are evaluated on the
state's device.
"""

from __future__ import annotations

import numpy as np

from difficp_torch.utils.spec import as_tensor, on_cpu


def get_bounds(*xlist, relmargin: float = 0.2):
    """(xmin, xmax, ymin, ymax) over point sets with a relative margin
    (reference visu.py:35-50)."""
    pts = np.concatenate([on_cpu(x) for x in xlist if len(x) > 0], axis=0)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    gmin = (1 + relmargin) * lo - relmargin * hi
    gmax = (1 + relmargin) * hi - relmargin * lo
    return gmin[0], gmax[0], gmin[1], gmax[1]


def my_scatter(*xlist, **kwargs):
    """Scatter each point set in 2D/3D with cycling colors
    (reference visu.py:55-83)."""
    import matplotlib.pyplot as plt

    d = on_cpu(xlist[0]).shape[1]
    if d not in (2, 3):
        raise ValueError("Can only plot datapoints in 2d and 3d")
    autocolor = "color" not in kwargs
    kwargs.setdefault("linewidth", 3)
    kwargs.setdefault("s", 1)
    for i, x in enumerate(xlist):
        xy = on_cpu(x)
        if autocolor:
            kwargs["color"] = "C" + str(i)
        if len(xy) == 0:
            continue
        if d == 2:
            plt.scatter(xy[:, 0], xy[:, 1], **kwargs)
        else:
            ax = plt.gca()
            ax.scatter(xy[:, 0], xy[:, 1], xy[:, 2], **kwargs)


def plot_gmm(state, *samples, bounds=None, heatmap=True, log_contours=True,
             color=None, cmap="RdBu", heatmap_amplification=-1,
             registration=None, res: int = 200):
    """2D plot of a GMM: centroid markers, likelihood heatmap, log-likelihood
    contours (reference GMM.py:554-643).  Optionally push the density
    forward through a registration (the experimental heatmap warp,
    GMM.py:586-616): the density is sampled on a grid pulled back through
    ``registration.backward``, on the handle's device.
    """
    import matplotlib.pyplot as plt
    import torch

    from difficp_torch.models import gmm as gmm_mod

    if bounds is not None:
        xmin, xmax, ymin, ymax = bounds
    else:
        sets = samples if samples else (state.mu,)
        xmin, xmax, ymin, ymax = get_bounds(*sets)

    gx = np.linspace(xmin, xmax, res, dtype=np.float32)
    gy = np.linspace(ymin, ymax, res, dtype=np.float32)
    xx, yy = np.meshgrid(gx, gy)
    grid = np.stack([xx.ravel(), yy.ravel()], axis=1)

    if registration is not None:
        grid = registration.backward(grid)
    with torch.no_grad():
        ll = gmm_mod.log_likelihoods(state, as_tensor(grid, state.mu.device))
    ll = on_cpu(ll).reshape(res, res)

    if heatmap:
        dens = np.exp(heatmap_amplification * -ll) if heatmap_amplification != -1 \
            else np.exp(ll)
        plt.imshow(
            dens, extent=(xmin, xmax, ymin, ymax), origin="lower",
            cmap=cmap, alpha=0.6, aspect="auto",
        )
    if log_contours:
        plt.contour(
            xx, yy, ll, levels=10,
            colors=None if color is None else color, linewidths=0.7,
        )
    mu = on_cpu(state.mu)
    plt.plot(mu[:, 0], mu[:, 1], "X", color="black", markersize=8)


def plot_gmm_clusters(state, *samples, bounds=None, cluster_colors=None):
    """Cluster-colored scatter: each point drawn in the color of its most
    responsible component, centroids as black crosses (reference GMM.plot_bis,
    GMM.py:647-686)."""
    import matplotlib.pyplot as plt
    import torch

    from difficp_torch.models import gmm as gmm_mod

    if cluster_colors is None:
        cluster_colors = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    for x in samples:
        with torch.no_grad():
            lgam = on_cpu(gmm_mod.log_responsibilities(state, as_tensor(x, state.mu.device)))
        affect = lgam.argmax(axis=1)
        xn = on_cpu(x)
        for c in range(state.mu.shape[0]):
            sel = affect == c
            if sel.any():
                plt.plot(xn[sel, 0], xn[sel, 1], ".",
                         color=cluster_colors[c % len(cluster_colors)], alpha=0.6)
    mu = on_cpu(state.mu)
    plt.plot(mu[:, 0], mu[:, 1], "X", color="black", markersize=10)


def plot_trajectories(psr, k: int = 0, support: bool = False, **kwargs):
    """Plot the shooting trajectories of frame k's points (reference
    MultiPSR.plot_trajectories, PSR.py:310-345)."""
    import matplotlib.pyplot as plt

    kwargs.setdefault("alpha", 0.5)
    kwargs.setdefault("color", "C" + str(k))
    traj = psr.trajectories(k=k, support=support)  # (nt+1, N, D)
    for n in range(traj.shape[1]):
        plt.plot(traj[:, n, 0], traj[:, n, 1], **kwargs)
