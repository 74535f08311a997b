#!/usr/bin/env python3
"""The registration handle's backward warp (a shoot from the arrival with
negated momenta) at the grid main path's end state, on one CUDA card.

Run from the repository root:  python3 tools/backward_check.py

chip_smoke.py's grid main path (10 x 65,536 points, grid support, run(2)
and a Reg_opt), then, for the Registration(k) of every frame, the gridlines
of chip_smoke.py's utils_path (64 x 64 ticks, 512 points a line) warped
backward on the kernel route, on the float32 plain (dense) route and on the
float64 plain route: each frame's forward arrival |p1|, the steps at which
the kernel route's state is finite, the float32 routes' distances from
float64 (relative to the largest |coordinate| of the float64 result), the
float64 result's change when a0 is perturbed at float32 rounding (2^-24
relative), and the largest |q|, |p|, |x| at each step (float64; for frame
0 also both float32 routes).  One JSON line a frame."""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main():
    import numpy as np
    import torch
    from difficp_torch.ops import _build
    from difficp_torch.ops import kmin2 as k2, ksum as ks, rhs_cross as rc, rhs_ext as re
    from difficp_torch.ops import rhs_self as rs
    from difficp_torch.models.registration import LDDMMRegistration
    from difficp_torch.viz.grid import Gridlines
    from difficp_torch.viz.visu import get_bounds

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(force=True)
    _build.library()
    counters = {"rhs_self": rs.launches, "rhs_ext": re.launches, "kmin2": k2.launches,
                "ksum": ks.launches, "rhs_cross": rc.launches}
    psr, _ = cs.phase_grid_main_path(counters, rs.orders)
    b = get_bounds(psr.get_data_points(0), relmargin=0.1)
    gl = Gridlines(np.linspace(b[0], b[1], 64), np.linspace(b[2], b[3], 64),
                   points_per_line=512)
    pts = torch.as_tensor(gl.get_points(), device="cuda")
    stats = lambda tr: [[float(tr.q[t].abs().max()), float(tr.p[t].abs().max()),  # noqa: E731
                         float(tr.x[t].abs().max())] for t in range(tr.q.shape[0])]
    for k in range(psr.K):
        reg = psr.Registration(k)
        q, a, m = reg.q0, reg.a0, reg.qmask
        reg64 = LDDMMRegistration(reg.cfg, q.double(), a.double(), m.double())
        _, tk = reg.shoot(pts, backward=True)
        with cs.dense_route():
            _, t32 = reg.shoot(pts, backward=True)
            _, t64 = reg64.shoot(pts, backward=True)
            g = torch.Generator(device="cuda").manual_seed(k)
            ap = a.double() * (1 + 2.0 ** -24 * torch.randn(a.shape, generator=g,
                                                            device="cuda", dtype=torch.float64))
            y64p = reg64._replace(a0=ap).shoot(pts, backward=True)[0].x
            fwd64 = reg64.shoot(None)[0]
        y64 = t64.x[-1]
        fin = [bool(torch.isfinite(tk.x[t]).all() and torch.isfinite(tk.p[t]).all())
               for t in range(tk.x.shape[0])]
        rec = {"frame": k, "max_abs_p1_forward": float(fwd64.p.abs().max()),
               "kernel_finite_by_step": fin,
               "plain32_vs_f64": cs.rel_err(t32.x[-1], y64),
               "kernel_vs_f64": cs.rel_err(tk.x[-1], y64) if all(fin) else None,
               "f64_sensitivity": cs.rel_err(y64p, y64),
               "f64_max_abs_qpx_by_step": stats(t64),
               "kernel_max_abs_qpx_by_step": stats(tk) if k == 0 else None,
               "plain32_max_abs_qpx_by_step": stats(t32) if k == 0 else None}
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
