"""Deformation-grid visualization: build 2D grid lines and warp them through
a registration to display the diffeomorphism (counterpart of
``difficp_tpu/viz/grid.py``; reference diffICP/visualization/grid.py:11-92:
Gridlines register/shoot/plot, with the speeds at the grid intersections).

The grid's points are shot on the registration handle's device; the lines
are host numpy arrays.
"""

from __future__ import annotations

import numpy as np

from difficp_torch.utils.spec import on_cpu


class Gridlines:
    """Rectangular grid of polylines (reference grid.py:11-30)."""

    def __init__(self, xticks, yticks, points_per_line: int = 100):
        self.xticks = np.asarray(xticks)
        self.yticks = np.asarray(yticks)
        self.points_per_line = points_per_line
        self.lines = []
        if len(self.xticks) and len(self.yticks):
            for x in self.xticks:
                ys = np.linspace(self.yticks.min(), self.yticks.max(), points_per_line)
                self.lines.append(np.stack([np.full_like(ys, x), ys], axis=1))
            for y in self.yticks:
                xs = np.linspace(self.xticks.min(), self.xticks.max(), points_per_line)
                self.lines.append(np.stack([xs, np.full_like(xs, y)], axis=1))

    def get_points(self) -> np.ndarray:
        return np.concatenate(self.lines, axis=0).astype(np.float32)

    @classmethod
    def from_points(cls, points, points_per_line: int):
        points = on_cpu(points)
        gl = cls([], [], points_per_line)
        gl.lines = np.split(points, points.shape[0] // points_per_line, axis=0)
        return gl

    def plot(self, **kwargs):
        import matplotlib.pyplot as plt

        for line in self.lines:
            plt.plot(line[:, 0], line[:, 1], **kwargs)

    def register(self, registration, backward: bool = False) -> "Gridlines":
        """Warp the grid through a registration handle (grid.py:55-68)."""
        pts = self.get_points()
        out = registration.backward(pts) if backward else registration.apply(pts)
        return Gridlines.from_points(out, self.points_per_line)

    def shoot(self, registration, require_v: bool = False, backward: bool = False):
        """Warp the grid at every integration time (grid.py:71-92).

        :return: list of Gridlines (one per time step); with require_v also
            (intersection trajectories, velocity fields at intersections).
        """
        import torch

        from difficp_torch.models import lddmm as lddmm_mod

        _, traj = registration.shoot(self.get_points(), backward=backward, save_traj=True)
        grids = [Gridlines.from_points(traj.x[t], self.points_per_line)
                 for t in range(traj.x.shape[0])]
        if not require_v:
            return grids
        inter = np.stack(np.meshgrid(self.xticks, self.yticks), axis=2)
        inter = inter.reshape(-1, 2).astype(np.float32)
        _, itraj = registration.shoot(inter, backward=backward, save_traj=True)
        with torch.no_grad():
            speeds = [on_cpu(lddmm_mod.v(registration.cfg, itraj.x[t], itraj.q[t],
                                         itraj.p[t], registration.qmask))
                      for t in range(itraj.x.shape[0])]
        inters = [on_cpu(itraj.x[t]) for t in range(itraj.x.shape[0])]
        return grids, inters, speeds
