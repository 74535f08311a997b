#!/usr/bin/env python3
"""An earlier build of the ext backward kernels (dx and dq/dp) against the
current ones, on one CUDA card.

    python3 tools/rhs_ext_ab.py time OLD_DIR

OLD_DIR holds the earlier kernels' source and their wrapper from one commit,
for example:

    mkdir -p build/rhs_ext_old
    for f in csrc/rhs_ext.cu csrc/tile.cuh ops/rhs_ext.py; do
        git show <commit>:difficp_torch/$f > build/rhs_ext_old/$(basename $f)
    done

``rhs_ext.cu`` is built with nvcc into OLD_DIR and ``rhs_ext.py`` is
imported as a module of its own whose ``_build.library()`` is that build, so
the earlier kernels run with their own entry points.

At each shape both versions of each kernel run on the same inputs; the line
gives each one's largest error against the float64 plain version, relative
to its largest output, then CUDA-event medians of 15 launches each in the
order earlier, current, current, earlier.  The current kernels take the
rows' orders computed once beforehand, as the grid main path does: dx the
data's, dq/dp the support's.  The current dx kernel also runs with the data
rows in their own order (an identity order: natural_rel_err, natural_ms)
and on a copy of the data sorted into the data order (an identity order on
that copy: sorted_ms), so that the order's cost in gathered loads and
scattered writes shows apart from its effect on the blocks; at the timed
shapes dx's versions run in the order earlier, current, natural, sorted,
then back.
Shapes: the grid main path's 10 frames of 65,536 spiral points against
their grid support at sigma = 0.05 (moved a little per frame, as along a
trajectory; d = 2, logdet on), and chip_smoke.py's check_ext shapes (3
frames of 16,381 ragged or 65,536 points, grid or masked custom support, d =
2 and 3, logdet on and off).  Writes build/rhs_ext_ab.json.
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
    """The earlier rhs_ext module bound to OLD_DIR's build."""
    from difficp_torch.ops import _build

    lib = old_dir / "librhs_ext_old.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    str(old_dir / "rhs_ext.cu"), "-o", str(lib)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    spec = importlib.util.spec_from_file_location("rhs_ext_old", old_dir / "rhs_ext.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = types.SimpleNamespace(library=lambda: dll)
    return mod


def main_shape(cs):
    """The grid main path's shape, as chip_smoke.phase_timing_ext makes it."""
    import numpy as np
    import torch
    from difficp_torch.utils.point_sets import grid_support

    k, n, d = 10, 65536, 2
    x = torch.as_tensor(np.stack(cs.grid_frames(k, n))).cuda()
    qg = torch.as_tensor(grid_support(x.reshape(-1, d).cpu().numpy(), cs.GRID_SIGMA))
    g = torch.Generator(device="cuda").manual_seed(3)
    q = qg.cuda() + 0.1 * cs.GRID_SIGMA * torch.randn((k, qg.shape[0], d), generator=g,
                                                      device="cuda")
    p = 0.05 * torch.randn(q.shape, generator=g, device="cuda")
    mx = torch.ones((k, n), device="cuda")
    mq = torch.ones(q.shape[:-1], device="cuda")
    gx = torch.randn(x.shape, generator=g, device="cuda")
    gc = torch.randn((k,), generator=g, device="cuda")
    return x, mx, q, p, mq, gx, gc


def shapes(cs):
    """(name, inputs, withlogdet, timed) of every shape: the main shape,
    then the check_ext shapes (timed at d = 3 with the grid support only)."""
    out = [("grid main path", main_shape(cs), True, True)]
    for n, masked in ((16381, True), (65536, False)):
        for d in (2, 3):
            for support in ("grid", "custom"):
                ins = cs.ext_inputs(3, n, d, masked, support, seed=n + d)
                for wl in (True, False):
                    timed = d == 3 and n == 65536 and support == "grid" and wl
                    out.append((f"check_ext N={n} d={d} {support}", ins, wl, timed))
    return out


def run(cs, re, old):
    import torch

    smi = cs.nvidia_smi_line()
    sig = cs.GRID_SIGMA
    recs = []
    for name, (x, mx, q, p, mq, gx, gc), wl, timed in shapes(cs):
        order = re.rhs_self.row_order(q, mq, sig)
        xorder = re.data_order(x, mx, sig)
        natural = torch.arange(x.shape[1], dtype=torch.int32,
                               device=x.device).expand(x.shape[0], -1).contiguous()
        args = (x, mx, gx, q, p, mq, gc, sig, wl)
        # the data rows sorted into the data order (its padding slots left out)
        idx = xorder[xorder >= 0].view(x.shape[0], x.shape[1]).long()
        xs, gxs = (torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))
                   for t in (x, gx))
        sorted_args = (xs, torch.gather(mx, 1, idx), gxs, *args[3:])
        f64 = [t.double() for t in args[:7]] + [sig, wl]
        calls = {
            "rhs_ext_bwd_dx": (lambda: (re.rhs_ext_bwd_dx(*args, xorder),),
                               lambda: (old.rhs_ext_bwd_dx(*args),),
                               (re.rhs_ext_bwd_dx_reference(*f64),),
                               {"natural": lambda: re.rhs_ext_bwd_dx(*args, natural),
                                "sorted": lambda: re.rhs_ext_bwd_dx(*sorted_args, natural)}),
            "rhs_ext_bwd_dqdp": (lambda: re.rhs_ext_bwd_dqdp(*args, order),
                                 lambda: old.rhs_ext_bwd_dqdp(*args),
                                 re.rhs_ext_bwd_dqdp_reference(*f64), {}),
        }
        for kernel, (new_fn, old_fn, ref, more) in calls.items():
            a, b = new_fn(), old_fn()
            torch.cuda.synchronize()
            rec = dict(call=name, kernel=kernel, frames=x.shape[0], N=x.shape[1],
                       M=q.shape[1], d=x.shape[2], withlogdet=wl,
                       new_rel_err=max(cs.rel_err(t, r) for t, r in zip(a, ref)),
                       old_rel_err=max(cs.rel_err(t, r) for t, r in zip(b, ref)))
            if "natural" in more:
                rec["natural_rel_err"] = cs.rel_err(more["natural"](), ref[0])
            if timed:
                fns = {"old": old_fn, "new": new_fn, **more}
                for fn in fns.values():
                    for _ in range(3):
                        fn()
                torch.cuda.synchronize()
                ms = {key: [] for key in fns}
                for key in [*fns, *reversed(fns)]:
                    ms[key].append(cs.cuda_ms(fns[key], 15))
                rec.update({f"{key}_ms": t for key, t in ms.items()},
                           speedup=sum(ms["old"]) / sum(ms["new"]))
            rec["device"] = smi
            recs.append(rec)
            print(json.dumps(rec), flush=True)
            del a, b
        del ref, calls, f64, xs, gxs, sorted_args
        torch.cuda.empty_cache()
    worst = {}
    for r in recs:
        w = worst.setdefault(r["kernel"], {key: 0.0 for key in r if key.endswith("rel_err")})
        for key in w:
            w[key] = max(w[key], r[key])
    print(json.dumps({"worst": worst}), flush=True)
    print(smi)
    return {"records": recs, "worst": worst}


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("rhs_ext_ab: CUDA is not available", file=sys.stderr)
        return 2
    if len(argv) != 2 or argv[0] != "time":
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from difficp_torch.ops import rhs_ext as re

    torch.backends.cuda.matmul.allow_tf32 = False
    old = load(Path(argv[1]).resolve())
    res = run(cs, re, old)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "rhs_ext_ab.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
