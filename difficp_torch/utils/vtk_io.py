"""Minimal legacy-VTK polydata landmark IO (ASCII); a copy of
``difficp_tpu/utils/vtk_io.py`` (pure numpy), byte-compatible with it: a file
written by either package reads back identically in the other, and float32
coordinates round-trip bit for bit at ``%.10g``.

The reference exchanges point sets with Deformetrica as VTK Landmark files
(reference api/deformetrica_atlas.py:130-145, 189-225).  This is a small
dependency-free reader/writer for that interchange (POINTS section of
legacy ASCII vtk PolyData, plus VERTICES for landmark semantics).
"""

from __future__ import annotations

import numpy as np

from difficp_torch.utils.spec import on_cpu


def write_landmarks(path: str, points, name: str = "landmarks"):
    """``points`` (N, 2) or (N, 3): an array or a tensor on any device."""
    pts = np.asarray(on_cpu(points), np.float64)
    n, d = pts.shape
    if d == 2:  # VTK points are 3D; pad z=0
        pts = np.concatenate([pts, np.zeros((n, 1))], axis=1)
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(f"{name}\nASCII\nDATASET POLYDATA\n")
        f.write(f"POINTS {n} float\n")
        for row in pts:
            f.write(f"{row[0]:.10g} {row[1]:.10g} {row[2]:.10g}\n")
        f.write(f"VERTICES {n} {2 * n}\n")
        for i in range(n):
            f.write(f"1 {i}\n")


def read_landmarks(path: str, dim: int | None = None) -> np.ndarray:
    pts = []
    with open(path) as f:
        lines = iter(f.read().splitlines())
    n = None
    for line in lines:
        tok = line.split()
        if tok[:1] == ["POINTS"]:
            n = int(tok[1])
            vals = []
            while len(vals) < 3 * n:
                vals.extend(float(v) for v in next(lines).split())
            pts = np.asarray(vals, np.float32).reshape(n, 3)
            break
    if n is None:
        raise ValueError(f"no POINTS section in {path}")
    if dim is None:
        dim = 2 if np.allclose(pts[:, 2], 0.0) else 3
    return np.ascontiguousarray(pts[:, :dim])
