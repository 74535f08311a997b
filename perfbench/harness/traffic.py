"""The one generator of the benchmark's inputs: point sets drawn from a seed
by the parameters of a traffic mix (``perfbench/traffic/<mix>.json``).

Frozen copies of the program's generators, so that the program may change
its own: ``spiral_cloud`` and ``warp`` from
``difficp_torch/examples/run_large.py:24-40``, the frames of
``chip_smoke.py:549-559`` (``grid_frames``: every odd frame warped), and the
target set of ``run_large.main`` (a warped second cloud).

A mix's keys: ``frames`` (K), ``points`` (per frame), ``dim`` (2 or 3),
``noise`` (the spiral's normal noise), ``warp_every_odd_frame``,
``target_set`` (draw a warped target cloud of ``points`` after the frames)
and ``data_seed``.  The point sets are drawn once, from ``data_seed``
(``draw``); each registration of a run takes them in an order of its own,
drawn from the run's ``--seed`` and the registration's number
(``permute``): the order of the frames, of the points in each set and of
the start points.  So every seed and every registration gives the same
sets and the same work, in another order, and sums are taken in another
order.
"""

from __future__ import annotations

import numpy as np

KEYS = ("frames", "points", "dim", "noise", "warp_every_odd_frame", "target_set",
        "data_seed")


def spiral_cloud(n, rng, noise=0.02, dim=2):
    t = rng.uniform(0, 2 * np.pi, size=n).astype(np.float32)
    cols = [0.5 + 0.4 * (t / 7) * np.cos(t), 0.5 + 0.3 * np.sin(t)]
    if dim == 3:
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


def draw(mix: dict, start_from: str, start_count: int):
    """(frames, target, starts): K float32 (points, dim) frames, the target
    set or None, and ``start_count`` points drawn from base frame 0
    (``start_from`` "frame0") or the target ("target"), as the sources draw
    their GMM start after the sets; all from the mix's ``data_seed``."""
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic mix lacks {missing}")
    rng = np.random.default_rng([int(mix["data_seed"])])
    n, dim, noise = int(mix["points"]), int(mix["dim"]), float(mix["noise"])
    frames = []
    for i in range(int(mix["frames"])):
        x = spiral_cloud(n, rng, noise=noise, dim=dim)
        frames.append(warp(x, dim) if (mix["warp_every_odd_frame"] and i % 2) else x)
    target = warp(spiral_cloud(n, rng, noise=noise, dim=dim), dim) if mix["target_set"] else None
    src = {"frame0": frames[0], "target": target}[start_from]
    if src is None:
        raise ValueError(f"start points from {start_from!r} need a target set in the mix")
    return frames, target, src[rng.integers(0, src.shape[0], int(start_count))]


def permute(drawn, seed: int, cohort: int):
    """``draw``'s sets in the order of registration ``cohort`` of the run
    with ``seed``."""
    frames, target, starts = drawn
    n = frames[0].shape[0]
    perm = np.random.default_rng([int(seed), int(cohort)])
    frames = [frames[i][perm.permutation(n)] for i in perm.permutation(len(frames))]
    if target is not None:
        target = target[perm.permutation(n)]
    return frames, target, starts[perm.permutation(len(starts))]
