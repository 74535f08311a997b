#!/usr/bin/env python3
"""An earlier build of the eta = 0 self-RHS kernels (forward, cross forward,
backward) against the current ones, on one CUDA card.

    python3 tools/rhs_self_ab.py time OLD_DIR
    python3 tools/rhs_self_ab.py fe OLD_DIR

OLD_DIR holds the earlier kernels' source and their wrappers from one commit,
for example:

    mkdir -p build/rhs_self_old
    for f in csrc/rhs_self.cu csrc/tile.cuh ops/rhs_self.py ops/rhs_cross.py; do
        git show <commit>:difficp_torch/$f > build/rhs_self_old/$(basename $f)
    done

``rhs_self.cu`` is built with nvcc into OLD_DIR and ``rhs_self.py`` and
``rhs_cross.py`` are imported as modules of their own whose
``_build.library()`` is that build, so the earlier kernels run with their own
entry points (the wrappers of a commit before the row order take none).

``time``: at each shape both kernels run on the same inputs; the line gives the largest
difference of their outputs relative to the largest output of the earlier
one, then CUDA-event medians of 15 launches each in the order earlier,
current, current, earlier.  The current kernels run with the rows' order
computed once beforehand, as the main paths do (once per optimisation); its
time is printed on a line of its own.  Shapes: the dense main path's
65,536^2 forward and backward (d = 2, sigma = 0.1, logdet on), the ring's
65,536^2 cross forward (the whole set as rows and columns), the grid main
path's support (10 frames of the grid support at sigma = 0.05, logdet off)
forward and backward, and 16,384^2 at d = 3 with holes.  Writes
build/rhs_self_ab.json.

``fe``: how the grid main path depends on the self kernels' rounding: the
path as chip_smoke.py drives it (chip_smoke.grid_psr, run(2) and one
stepwise Reg_opt) with the self forward and backward taken by "current",
"earlier" and "perturbed" (the current kernels' outputs scaled by 1 +
2^-22, far below either kernel's error): the FE sequences and their
relative differences, entry by entry.  Writes build/rhs_self_ab_fe.json.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load(old_dir: Path):
    """The earlier (rhs_self, rhs_cross) modules bound to OLD_DIR's build."""
    from difficp_torch.ops import _build

    lib = old_dir / "librhs_self_old.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    str(old_dir / "rhs_self.cu"), "-o", str(lib)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    mods = []
    for name in ("rhs_self", "rhs_cross"):
        spec = importlib.util.spec_from_file_location(f"{name}_old", old_dir / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod._build = types.SimpleNamespace(library=lambda: dll)
        mods.append(mod)
    return mods


def shapes(cs, rs):
    """(name, inputs, the current kernel's call, the earlier kernel's call
    given the earlier modules) of every timed shape, and the dense inputs'
    (q, m) for the row order's timing."""
    import torch
    from difficp_torch.ops import rhs_cross as rc

    q, p, m, a, b, c = cs.make_inputs(65536, 2, False, seed=1)
    x, qg, qs, ps, _ = cs.grid_eta_inputs()
    del x, qg
    g = torch.Generator(device="cuda").manual_seed(3)
    ms = torch.ones(qs.shape[:-1], device="cuda")
    gv, gw = (torch.randn(qs.shape, generator=g, device="cuda") for _ in range(2))
    zero = torch.zeros(qs.shape[:-2], device="cuda")
    q3, p3, m3, a3, b3, c3 = cs.make_inputs(16384, 3, True, seed=16387)
    sig, gsig = cs.SIGMA, cs.GRID_SIGMA
    o1, os_, o3 = rs.row_order(q, m, sig), rs.row_order(qs, ms, gsig), rs.row_order(q3, m3, sig)
    return [
        ("dense forward", (q, p, m, sig, True),
         lambda: rs.rhs_self_fwd(q, p, m, sig, True, order=o1),
         lambda old: old[0].rhs_self_fwd(q, p, m, sig, True)),
        ("dense backward", (q, p, m, a, b, c, sig, True),
         lambda: rs.rhs_self_bwd(q, p, m, a, b, c, sig, True, o1),
         lambda old: old[0].rhs_self_bwd(q, p, m, a, b, c, sig, True)),
        ("ring cross forward", (q, p, m, q, p, m, sig, True),
         lambda: rc.rhs_cross_fwd(q, p, m, q, p, m, sig, True, order=o1),
         lambda old: old[1].rhs_cross_fwd(q, p, m, q, p, m, sig, True)),
        ("grid forward", (qs, ps, ms, gsig, False),
         lambda: rs.rhs_self_fwd(qs, ps, ms, gsig, False, order=os_),
         lambda old: old[0].rhs_self_fwd(qs, ps, ms, gsig, False)),
        ("grid backward", (qs, ps, ms, gv, gw, zero, gsig, False),
         lambda: rs.rhs_self_bwd(qs, ps, ms, gv, gw, zero, gsig, False, os_),
         lambda old: old[0].rhs_self_bwd(qs, ps, ms, gv, gw, zero, gsig, False)),
        ("d = 3 forward", (q3, p3, m3, sig, True),
         lambda: rs.rhs_self_fwd(q3, p3, m3, sig, True, order=o3),
         lambda old: old[0].rhs_self_fwd(q3, p3, m3, sig, True)),
        ("d = 3 backward", (q3, p3, m3, a3, b3, c3, sig, True),
         lambda: rs.rhs_self_bwd(q3, p3, m3, a3, b3, c3, sig, True, o3),
         lambda old: old[0].rhs_self_bwd(q3, p3, m3, a3, b3, c3, sig, True)),
    ], (q, m)


def time_calls(cs, rs, old):
    import torch

    smi = cs.nvidia_smi_line()
    calls, (q, m) = shapes(cs, rs)
    recs = []
    for name, args, new_fn, old_call in calls:
        old_fn = lambda: old_call(old)  # noqa: E731
        a, b = new_fn(), old_fn()
        torch.cuda.synchronize()
        diff = max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b))
        for fn in (old_fn, new_fn):
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        t_old1 = cs.cuda_ms(old_fn, 15)
        t_new1 = cs.cuda_ms(new_fn, 15)
        t_new2 = cs.cuda_ms(new_fn, 15)
        t_old2 = cs.cuda_ms(old_fn, 15)
        rec = dict(call=name, frames=args[0].shape[0], M=args[0].shape[1],
                   d=args[0].shape[2], old_ms=[t_old1, t_old2], new_ms=[t_new1, t_new2],
                   speedup=(t_old1 + t_old2) / (t_new1 + t_new2), rel_diff_new_vs_old=diff,
                   device=smi)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
        del a, b
    order_fn = lambda: rs.row_order(q, m, cs.SIGMA)  # noqa: E731
    order_fn()
    torch.cuda.synchronize()
    rec = dict(call="row order, 65,536 points", ms=cs.cuda_ms(order_fn, 15), device=smi)
    recs.append(rec)
    print(json.dumps(rec), flush=True)
    torch.cuda.empty_cache()
    print(smi)
    return recs


def grid_fe(cs, rs, old):
    import torch

    cur_f, cur_b = rs.rhs_self_fwd, rs.rhs_self_bwd
    scale = 1.0 + 2.0 ** -22

    def old_f(q, p, m, sigma, withlogdet, eta=0.0, order=None):
        return old[0].rhs_self_fwd(q, p, m, sigma, withlogdet, eta)

    def old_b(q, p, m, a, b, c, sigma, withlogdet, order=None):
        return old[0].rhs_self_bwd(q, p, m, a, b, c, sigma, withlogdet)

    def pert_f(*args, **kw):
        return tuple(t * scale for t in cur_f(*args, **kw))

    def pert_b(*args, **kw):
        return tuple(t * scale for t in cur_b(*args, **kw))

    runs = {}
    for name, (fwd, bwd) in (("current", (cur_f, cur_b)), ("earlier", (old_f, old_b)),
                             ("perturbed", (pert_f, pert_b))):
        rs.rhs_self_fwd, rs.rhs_self_bwd = fwd, bwd
        try:
            psr = cs.grid_psr(10, 65536)
            fe0 = psr.FE
            fes = psr.run(2, **cs.GRID_RUN)
            psr.Reg_opt(tol=1e-3, nmax=1, inner=10, ls_steps=12)
            torch.cuda.synchronize()
        finally:
            rs.rhs_self_fwd, rs.rhs_self_bwd = cur_f, cur_b
        runs[name] = {"FE_sequence": [fe0, *map(float, fes), psr.FE],
                      "fe_increase_events": psr.fe_increase_events}
        print(json.dumps({"grid_main_path": name, **runs[name]}), flush=True)
        del psr
        torch.cuda.empty_cache()
    out = {"device": cs.nvidia_smi_line(), "runs": runs, "rel_diff_entries": {}}
    for a, b in (("current", "earlier"), ("perturbed", "current")):
        fa, fb = runs[a]["FE_sequence"], runs[b]["FE_sequence"]
        out["rel_diff_entries"][f"{a}_vs_{b}"] = [abs(x - y) / abs(y) for x, y in zip(fa, fb)]
    print(json.dumps({"rel_diff_entries": out["rel_diff_entries"], "tol": cs.TOL_ROUTE_FE}))
    print(out["device"])
    return out


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("rhs_self_ab: CUDA is not available", file=sys.stderr)
        return 2
    if len(argv) != 2 or argv[0] not in ("time", "fe"):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from difficp_torch.ops import rhs_self as rs

    torch.backends.cuda.matmul.allow_tf32 = False
    old = load(Path(argv[1]).resolve())
    if argv[0] == "time":
        res, name = time_calls(cs, rs, old), "rhs_self_ab.json"
    else:
        res, name = grid_fe(cs, rs, old), "rhs_self_ab_fe.json"
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / name).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
