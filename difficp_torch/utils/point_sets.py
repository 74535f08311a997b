"""Point-set helpers (counterpart of ``difficp_tpu/utils/point_sets.py``):
the intrinsic scale of a point set, the greedy decimation of
``DiffPSR.set_support_scheme("decim")`` (reference point_sets.py:102-133) and
the grid support of ``set_support_scheme("grid")`` (reference
PSR.py:472-482).

``grid_support`` is a numpy copy of the JAX package's, tick for tick, so both
packages build bit-identical grids.  ``decimate`` runs the port's own copy of
the JAX package's native decimation (``csrc/decimate.cpp``, built with g++ at
first use), so both keep the same indices; a failed build raises.  Its plain
numpy version ``decimate_reference`` (the JAX package's fallback algorithm,
O(N^2) per pick) is what the tests hold it against.
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from difficp_torch.ops import _build
from difficp_torch.ops import backend as _backend

_decimate_bound = False


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


def _decimate_lib():
    global _decimate_bound
    lib = _build.host_library()
    if not _decimate_bound:
        lib.difficp_decimate.restype = ctypes.c_int
        lib.difficp_decimate.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.POINTER(ctypes.c_int32)]
        _decimate_bound = True
    return lib


def _split(kept, n):
    kept = [int(i) for i in kept]
    kept_set = set(kept)
    return kept, [i for i in range(n) if i not in kept_set]


def decimate(x, r) -> tuple[list[int], list[int]]:
    """Greedy cover decimation: a subset such that every point lies within
    radius r of a kept point, picked by repeatedly keeping the point that
    covers the most uncovered points (reference point_sets.py:102-133).
    Host-side, set-up time only, through the native library.

    :return: (kept indices in the order picked, rejected indices)
    """
    pts = np.ascontiguousarray(x, np.float32)
    n, d = pts.shape
    if not 1 <= d <= 3:
        raise ValueError(f"decimate takes points of dimension 1 to 3, got {d}")
    out = np.empty(n, np.int32)
    n_kept = _decimate_lib().difficp_decimate(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, d, ctypes.c_float(float(r)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return _split(out[:n_kept], n)


def decimate_sets(sets, r) -> list[tuple[list[int], list[int]]]:
    """``decimate`` of each point set of ``sets`` at radius r, the sets on
    one host thread each (the native call releases the interpreter lock; a
    frame of 65,536 spiral points at r = 0.05 takes seconds), in order."""
    _decimate_lib()  # built and bound before the threads start
    with ThreadPoolExecutor(max_workers=max(1, min(len(sets), os.cpu_count() or 1))) as ex:
        return list(ex.map(lambda x: decimate(x, r), sets))


def decimate_reference(x, r) -> tuple[list[int], list[int]]:
    """Plain numpy version of ``decimate``: the JAX package's fallback
    algorithm (a dense coverage matrix, O(N^2) per pick)."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    cov = d2 <= r * r
    notcovered = np.arange(n)
    kept = []
    while notcovered.size:
        sub = cov[np.ix_(notcovered, notcovered)]
        gid = int(notcovered[int(sub.sum(axis=0).argmax())])
        kept.append(gid)
        notcovered = notcovered[~cov[gid][notcovered]]
    return _split(kept, n)


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
