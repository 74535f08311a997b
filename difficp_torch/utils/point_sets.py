"""Point-set helpers (counterpart of ``difficp_tpu/utils/point_sets.py``):
the intrinsic scale of a point set and the grid support of
``DiffPSR.set_support_scheme("grid")`` (reference PSR.py:472-482).

``grid_support`` is a numpy copy of the JAX package's, tick for tick, so both
packages build bit-identical grids.  Greedy decimation (``decimate``) comes
with the decim-support slice.
"""

from __future__ import annotations

import numpy as np
import torch

from difficp_torch.ops import backend as _backend


def intrinsic_scale(x, mask=None) -> float:
    """Mean nearest-neighbour distance of the point set, the minimal blur at
    which the set stops being resolvable (reference point_sets.py:13-26).
    Through the backend dispatch: dense below the pair limit, the kmin2
    kernel above it."""
    nn2 = _backend.second_min_sqdist(x, mask)
    val = torch.sqrt(nn2)
    if mask is not None:
        return float(torch.where(mask > 0, val, torch.zeros_like(val)).sum() / mask.sum())
    return float(val.mean())


def grid_support(points, rcover, relmargin=0.1, ticks=None) -> np.ndarray:
    """Rectangular grid of support points covering the data bounding box with
    step rcover (reference PSR.py:472-482; D-dimensional generalization).

    :param points: (N, D) array (or list of arrays) setting the bounds.
    :param ticks: optional explicit list of per-dimension tick arrays.
    :return: (Ngrid, D) float32 array of grid points.
    """
    if ticks is None:
        if isinstance(points, (list, tuple)):
            pts = np.concatenate([np.asarray(p).reshape(-1, np.asarray(p).shape[-1])
                                  for p in points], axis=0)
        else:
            pts = np.asarray(points).reshape(-1, np.asarray(points).shape[-1])
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        mid_lo = (1 + relmargin) * lo - relmargin * hi
        mid_hi = (1 + relmargin) * hi - relmargin * lo
        ticks = [
            np.arange(mid_lo[d] - rcover / 2, mid_hi[d] + rcover / 2, rcover)
            for d in range(pts.shape[1])
        ]
    mesh = np.meshgrid(*ticks, indexing="xy")
    grid = np.stack(mesh, axis=-1).reshape(-1, len(ticks), order="F")
    return np.ascontiguousarray(grid, np.float32)
