#!/usr/bin/env python3
"""An earlier build of the direct forward kernels (the any-eta self and cross
forward of rhs_self.cu, the ext forward of rhs_ext.cu) against the current
ones, on one CUDA card.

    python3 tools/fwd_ab.py time OLD_DIR
    python3 tools/fwd_ab.py paths OLD_DIR

OLD_DIR holds the earlier kernels' sources and their wrappers from one
commit, for example:

    mkdir -p build/fwd_old
    for f in csrc/rhs_self.cu csrc/rhs_ext.cu csrc/tile.cuh csrc/wgmma.cuh \\
             ops/rhs_self.py ops/rhs_ext.py ops/rhs_cross.py; do
        git show <commit>:difficp_torch/$f > build/fwd_old/$(basename $f)
    done

(and ``csrc/direct.cuh`` too where that commit has it).  The two ``.cu``
files are built with nvcc into one library in OLD_DIR, and the three
wrappers are imported as modules of their own whose ``_build.library()`` is
that build, so the earlier kernels run with their own entry points.

At each main-path shape both versions run on the same inputs; the line gives
each one's largest error against the float64 plain version, relative to its
largest output (each frame's dcost relative to the sum of its terms'
magnitudes), whether two calls of the current kernel agree bit for bit,
then, in the order earlier, current, current, earlier, each one's median of
15 launches timed with CUDA events (cuda_ms: the wrapper's host time
included) and its median device time (device_ms: the kernel's own, from a
torch.profiler trace), and the earlier's summed times over the current's.
Shapes (chip_smoke.py's, d = 2 unless named): the dense eta path's self
forward (one frame of 8,192 spiral points, sigma = 0.1, eta = 1/200, logdet
on), the grid eta path's (the grid support's 10 x ~380 points, sigma = 0.05,
eta = 1/500, logdet off), the ring eta path's cross forward (8,192 x 8,192,
logdet on), the grid main path's ext forward (10 frames of 65,536 data
points against their support, eta = 0, logdet on), v_field of the grid eta
path's set-up (the support's 10 x ~380 points against 65,536 data points,
eta = 1/500, logdet off), and at d = 3 the self forward at 16,384 helix
points and the ext forward on 3 frames of 65,536 against their grid support.

``paths`` drives chip_smoke.py's grid main path and dense eta path with the
earlier direct forwards and with the current ones in turns (earlier,
current, current, earlier; the eta = 0 table kernels are the current ones
in both), and prints each run's seconds per outer iteration and per
loss+grad, its FE sequence and its launches.  Writes
build/fwd_ab_time.json or build/fwd_ab_paths.json.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load(old_dir: Path):
    """The earlier rhs_self, rhs_cross and rhs_ext modules bound to OLD_DIR's
    build of its two sources."""
    from difficp_torch.ops import _build

    lib = old_dir / "libfwd_old.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    str(old_dir / "rhs_self.cu"), str(old_dir / "rhs_ext.cu"), "-o", str(lib)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    mods = {}
    for name in ("rhs_self", "rhs_cross", "rhs_ext"):
        spec = importlib.util.spec_from_file_location(f"{name}_old", old_dir / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod._build = types.SimpleNamespace(library=lambda: dll)
        mods[name] = mod
    return mods


def calls(cs, rs, rc, re, old):
    """(name, current, earlier, float64 plain, timed) of every shape; each
    call returns its outputs, the last one the per-row dcost partials."""
    import torch

    x, qg, q, p, _ = cs.grid_eta_inputs()
    k, n, m = x.shape[0], x.shape[1], q.shape[1]
    mq = torch.ones((k, m), device="cuda")
    mx = torch.ones((k, n), device="cuda")
    qd, pd_, md, *_ = cs.make_inputs(cs.DENSE_ETA_N, 2, False, seed=5)
    q3, p3, m3, *_ = cs.make_inputs(16384, 3, False, seed=7)
    # the grid main path's ext forward, as chip_smoke.phase_timing_ext makes it
    g = torch.Generator(device="cuda").manual_seed(3)
    qm = qg.cuda() + 0.1 * cs.GRID_SIGMA * torch.randn((k, m, 2), generator=g, device="cuda")
    pm = 0.05 * torch.randn(qm.shape, generator=g, device="cuda")
    # v_field: the support against the data points, the dense momenta there
    qsup = qg.cuda().expand(k, m, 2).contiguous()
    pv = 0.01 * torch.randn(x.shape, generator=g, device="cuda")
    x3, mx3, q3e, p3e, mq3e, *_ = cs.ext_inputs(3, 65536, 3, False, "grid", seed=65539)

    def self_case(mod, qq, pp, mm, sig, wl, eta):
        return lambda: mod.launch_fwd(qq, pp, mm, sig, wl, eta, True)

    def cross_case(mod, qq, pp, mm, sig, wl, eta):
        return lambda: mod.launch_fwd(qq, pp, mm, qq, pp, mm, sig, wl, eta, True)

    def ext_case(mod, xx, mxx, qq, pp, mqq, sig, wl, eta):
        return lambda: mod.launch_fwd(xx, mxx, qq, pp, mqq, sig, wl, eta, eta != 0.0)

    def f64(fn, *args):
        return lambda: fn(*(a.double() if torch.is_tensor(a) else a for a in args))

    out = []
    for name, args in (("dense eta self 8,192^2", (qd, pd_, md, cs.SIGMA, True, cs.DENSE_ETA)),
                       ("grid eta self 10 x M^2", (q, p, mq, cs.GRID_SIGMA, False, cs.GRID_ETA)),
                       ("self d = 3, 16,384^2", (q3, p3, m3, cs.SIGMA, True, cs.DENSE_ETA))):
        out.append((name, "rhs_self_fwd_eta", self_case(rs, *args), self_case(old["rhs_self"], *args),
                    f64(rs.rhs_self_fwd_reference, *args)))
    args = (qd, pd_, md, cs.SIGMA, True, cs.DENSE_ETA)
    out.append(("ring eta cross 8,192^2", "rhs_cross_fwd_eta", cross_case(rc, *args),
                cross_case(old["rhs_cross"], *args),
                f64(rc.rhs_cross_fwd_reference, qd, pd_, md, qd, pd_, md, *args[3:])))
    for name, kernel, args in (
            ("grid main ext 10 x 65,536 x M", "rhs_ext_fwd",
             (x, mx, qm, pm, mq, cs.GRID_SIGMA, True, 0.0)),
            ("v_field 10 x M x 65,536", "rhs_ext_fwd_eta",
             (qsup, mq, x, pv, mx, cs.GRID_SIGMA, False, cs.GRID_ETA)),
            ("ext d = 3, 3 x 65,536 x M", "rhs_ext_fwd",
             (x3, mx3, q3e, p3e, mq3e, cs.GRID_SIGMA, True, 0.0))):
        out.append((name, kernel, ext_case(re, *args), ext_case(old["rhs_ext"], *args),
                    f64(re.rhs_ext_fwd_reference, *args)))
    return out


def errors(cs, got, ref):
    """The largest error of the outputs but dcost relative to their largest
    value, and of each frame's dcost relative to its terms' magnitudes."""
    rel = max(cs.rel_err(a, r) for a, r in zip(got[:-1], ref[:-1]))
    dc, rdc = got[-1].double(), ref[-1]
    dc_rel = float((dc.sum(-1) - rdc.sum(-1)).abs().max()
                   / rdc.abs().sum(-1).max().clamp_min(1e-300))
    return max(rel, dc_rel)


def run(cs, rs, rc, re, old):
    import torch

    smi = cs.nvidia_smi_line()
    recs = []
    for name, kernel, new_fn, old_fn, plain in calls(cs, rs, rc, re, old):
        a, again, b = new_fn(), new_fn(), old_fn()
        torch.cuda.synchronize()
        ref = plain()
        rec = dict(call=name, kernel=kernel, new_rel_err=errors(cs, a, ref),
                   old_rel_err=errors(cs, b, ref),
                   new_bit_identical=all(torch.equal(u, v) for u, v in zip(a, again)))
        del a, again, b, ref
        torch.cuda.empty_cache()
        fns = {"old": old_fn, "new": new_fn}
        for fn in fns.values():
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        ms = {key: [] for key in fns}
        dev = {key: [] for key in fns}
        for key in ("old", "new", "new", "old"):
            ms[key].append(cs.cuda_ms(fns[key], 15))
            dev[key].append(cs.device_ms(fns[key], 15))
        rec.update({f"{key}_ms": t for key, t in ms.items()},
                   **{f"{key}_device_ms": t for key, t in dev.items()},
                   speedup=sum(ms["old"]) / sum(ms["new"]),
                   device_speedup=sum(dev["old"]) / sum(dev["new"]), device=smi)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    print(smi)
    return {"records": recs}


@contextlib.contextmanager
def earlier_forwards(rs, rc, re, old):
    """Inside the block the direct forwards' launches (rhs_self's and
    rhs_cross's any-eta launches, every ext forward launch) go to the
    earlier build, counted in the current modules' counters; the eta = 0
    table kernels stay the current ones."""
    saved = rs.launch_fwd, rc.launch_fwd, re.launch_fwd

    def route(counts, name_of, fn, earlier, use_eta_at):
        def launch(*args, **kw):
            if not args[use_eta_at]:
                return fn(*args, **kw)
            out = earlier(*args, **kw)
            counts[name_of] += 1
            return out
        return launch

    rs.launch_fwd = route(rs.launches, "rhs_self_fwd_eta", saved[0],
                          old["rhs_self"].launch_fwd, 6)
    rc.launch_fwd = route(rc.launches, "rhs_cross_fwd_eta", saved[1],
                          old["rhs_cross"].launch_fwd, 9)

    def ext(*args, **kw):
        out = old["rhs_ext"].launch_fwd(*args, **kw)
        re.launches["rhs_ext_fwd_eta" if args[8] else "rhs_ext_fwd"] += 1
        return out

    re.launch_fwd = ext
    try:
        yield
    finally:
        rs.launch_fwd, rc.launch_fwd, re.launch_fwd = saved


def paths(cs, rs, rc, re, old):
    """The grid main path and the dense eta path as chip_smoke.py drives
    them, with the earlier and the current direct forwards in turns
    (earlier, current, current, earlier): each run's seconds per outer
    iteration and per loss+grad, its loss+grad evaluations, its FE sequence
    and its launches.  chip_smoke's free-energy and end-state holds are
    printed, not enforced: the earlier kernels print their own sequences."""
    import torch
    from difficp_torch.examples import run_large
    from difficp_torch.ops import kmin2 as k2
    from difficp_torch.ops import ksum as ks

    smi = cs.nvidia_smi_line()
    counters = {"rhs_self": rs.launches, "rhs_ext": re.launches, "kmin2": k2.launches,
                "ksum": ks.launches, "rhs_cross": rc.launches}
    seen = []
    emit, hold_fes, hold_end = cs.emit, cs.hold_fes, cs.hold_end_state
    cs.emit = seen.append
    cs.hold_fes = lambda phase, fes, refs, before: None
    cs.hold_end_state = lambda phase, psr, route: None
    recs = []
    try:
        for which in ("old", "new", "new", "old"):
            ctx = earlier_forwards(rs, rc, re, old) if which == "old" else contextlib.nullcontext()
            with ctx:
                seen.clear()
                psr, _ = cs.phase_grid_main_path(counters, rs.orders)
                del psr
                cs.phase_dense_eta_path(counters, run_large)
                torch.cuda.synchronize()
            for r in seen:
                if r.get("phase") not in ("grid_main_path", "dense_eta_path"):
                    continue
                per_iter = r["seconds_per_outer_iteration"]
                run_s = r["run_seconds"] if "run_seconds" in r else sum(per_iter)
                rec = {"kernels": which, "path": r["phase"],
                       "seconds_per_outer_iteration": per_iter,
                       "loss_grad_evals": r["loss_grad_evals"],
                       "seconds_per_loss_grad": run_s / r["loss_grad_evals"],
                       "FE_sequence": r["FE_sequence"], "launches": r["launches"],
                       "device": smi}
                recs.append(rec)
                print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    finally:
        cs.emit, cs.hold_fes, cs.hold_end_state = emit, hold_fes, hold_end
    print(smi)
    return {"paths": recs}


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("fwd_ab: CUDA is not available", file=sys.stderr)
        return 2
    if len(argv) != 2 or argv[0] not in ("time", "paths"):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from difficp_torch.ops import rhs_cross as rc
    from difficp_torch.ops import rhs_ext as re
    from difficp_torch.ops import rhs_self as rs

    torch.backends.cuda.matmul.allow_tf32 = False
    old = load(Path(argv[1]).resolve())
    res = (run if argv[0] == "time" else paths)(cs, rs, rc, re, old)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / f"fwd_ab_{argv[0]}.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
