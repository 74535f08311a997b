#!/usr/bin/env python3
"""An earlier build of the ksum kernel against the current one, on one CUDA
card.

    python3 tools/ksum_ab.py time OLD_DIR
    python3 tools/ksum_ab.py eta OLD_DIR

OLD_DIR holds the earlier kernel's source and its wrapper from one commit,
for example:

    mkdir -p build/ksum_old
    git show <commit>:difficp_torch/csrc/ksum.cu > build/ksum_old/ksum.cu
    git show <commit>:difficp_torch/csrc/tile.cuh > build/ksum_old/tile.cuh
    git show <commit>:difficp_torch/ops/ksum.py > build/ksum_old/ksum.py

``ksum.cu`` is built with nvcc into OLD_DIR and ``ksum.py`` imported as a
module of its own whose ``_build.library()`` is that build, so the earlier
kernel runs with its own chunking, y splits and C entry.

``time``: at every kernel-sum shape of the main paths (chip_smoke.ksum_calls)
both kernels against each other (largest difference relative to the largest
output), then CUDA-event medians of 15 launches each in the order earlier,
current, current, earlier, beside the bounds.  Writes build/ksum_ab.json.

``eta``: how the eta paths depend on the kernel-sum's rounding.
  - The start: the grid eta path's set-up (10 frames of 65,536 points) and
    the dense eta path's (DENSE_ETA_N points) from DiffPSR's own float32 v2p
    start, with ksum taken by "float64" (the plain version in float64,
    rounded to float32 at its output), "current" and "earlier": v2p's
    right-hand side eta grad_kred(q, q) on the dense support and the start
    momenta, each as its largest difference from the float64 one relative to
    that one's largest entry, and the start's free energy; for the dense
    path also its first GMM_opt's.
  - The grid eta path as chip_smoke.py drives it (chip_smoke.grid_eta_psr,
    whose start is the float64 one, then chip_smoke.grid_eta_run) with ksum
    taken by "current", "earlier", "perturbed" (the current kernel's outputs
    scaled by 1 + 2^-22) and "float64": the FE sequences and their relative
    differences, entry by entry.
  Writes build/ksum_ab_eta.json.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load(old_dir: Path):
    """The earlier ksum module: OLD_DIR/ksum.py bound to OLD_DIR/ksum.cu, built."""
    from difficp_torch.ops import _build

    lib = old_dir / "libksum_old.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(old_dir / "ksum.cu"),
                    "-o", str(lib)], check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    spec = importlib.util.spec_from_file_location("ksum_old", old_dir / "ksum.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = types.SimpleNamespace(library=lambda: dll)
    return mod


def time_calls(cs, ks, pp, old):
    import torch

    smi = cs.nvidia_smi_line()
    recs = []
    for group in ("eta", "ring"):
        for name, xs, ys, tab, sig, self_case in cs.ksum_calls(pp, group):
            new_fn = lambda: ks.ksum(xs, ys, tab, None, sig)  # noqa: E731
            old_fn = lambda: old.ksum(xs, ys, tab, None, sig)  # noqa: E731
            a, b = new_fn(), old_fn()
            torch.cuda.synchronize()
            diff = float((a - b).abs().max() / b.abs().max())
            for fn in (old_fn, new_fn):
                for _ in range(3):
                    fn()
            torch.cuda.synchronize()
            t_old1 = cs.cuda_ms(old_fn, 15)
            t_new1 = cs.cuda_ms(new_fn, 15)
            t_new2 = cs.cuda_ms(new_fn, 15)
            t_old2 = cs.cuda_ms(old_fn, 15)
            nb, nx, ny, ncols, d = (xs.shape[0], xs.shape[1], ys.shape[1], tab.shape[1],
                                    xs.shape[2])
            pairs = nb * (nx * (nx - 1) / 2 if self_case else nx * ny)
            nbytes = 4.0 * nb * (nx * d + ny * d + ncols * ny + ncols * nx)
            bd = cs.ksum_bound(pairs, d, ncols, nbytes, self_pairs=self_case)
            rec = dict(call=name, frames=nb, Nx=nx, Ny=ny, cols=ncols,
                       old_ms=[t_old1, t_old2], new_ms=[t_new1, t_new2],
                       speedup=(t_old1 + t_old2) / (t_new1 + t_new2),
                       rel_diff_new_vs_old=diff, bound_ms=bd["bound_ms"],
                       bound_term=bd["bound_term"], bound_fp32_ms=bd["bound_fp32_ms"],
                       device=smi)
            recs.append(rec)
            print(json.dumps(rec), flush=True)
            del a, b
            torch.cuda.empty_cache()
    print(smi)
    return recs


def rel_max(a, ref):
    return float((a.double() - ref.double()).abs().max() / ref.double().abs().max())


def eta_paths(cs, ks, old):
    import numpy as np
    import torch

    from difficp_torch.examples import run_large
    from difficp_torch.models import gmm, lddmm
    from difficp_torch.models.psr import DiffPSR
    from difficp_torch.ops import backend

    current = ks.ksum
    with cs.float64_ksum(ks):
        float64 = ks.ksum

    def dense_psr():
        rng = np.random.default_rng(0)
        n = cs.DENSE_ETA_N
        x_a = run_large.spiral_cloud(n, rng)
        x_b = run_large.warp(run_large.spiral_cloud(n, rng), 2)
        mu0 = x_b[rng.integers(0, n, 64)]
        state, _ = gmm.create(mu0, sigma=0.05, device="cuda")
        gcfg = gmm.GMMConfig(optimize_mu=True, optimize_sigma=True, optimize_w=True,
                             optimize_eta0=False)
        lcfg = lddmm.make_config(sigma=cs.SIGMA, lambd=200.0, version="logdet", nt=10,
                                 scheme="Euler")
        psr = DiffPSR(x_a, state, gcfg, lcfg, device="cuda")
        psr.printstuff = False
        return psr

    kernels = (("float64", float64), ("current", current), ("earlier", old.ksum))
    out = {"device": cs.nvidia_smi_line(), "start": []}
    for path, make in (("grid_eta", lambda: cs.grid_psr(10, 65536, version="logdet")),
                       ("dense_eta", dense_psr)):
        rec, starts = {"path": path}, {}
        for name, fn in kernels:
            ks.ksum = fn
            try:
                t0 = time.perf_counter()
                psr = make()
                # the right-hand side of the set-up's v2p, on the dense support
                # (the data points; the grid path projects its a0 afterwards)
                grid = psr.support_scheme is not None
                q, m = (psr.x0, psr.xmask) if grid else (psr.q0, psr.qmask)
                rhs = psr.lcfg.eta * backend.grad_kred(q, q, psr.lcfg.sigma, m)
                a0 = psr.a0.clone()
                psr._record_start()
                rec[name] = {"FE_start": float(psr.FE)}
                if not grid:
                    psr.GMM_opt(max_iterations=10, tol=1e-3)
                    rec[name]["FE_first"] = float(psr.FE)
                torch.cuda.synchronize()
                rec[name]["seconds"] = time.perf_counter() - t0
                starts[name] = (rhs, a0)
            finally:
                ks.ksum = current
            del psr
            torch.cuda.empty_cache()
        rhs64, a064 = starts["float64"]
        for name in ("current", "earlier"):
            rhs, a0 = starts[name]
            rec[name]["rhs_rel_diff_vs_float64"] = rel_max(rhs, rhs64)
            rec[name]["a0_rel_diff_vs_float64"] = rel_max(a0, a064)
        print(json.dumps(rec), flush=True)
        out["start"].append(rec)

    # the perturbed current kernel: every output scaled by 1 + 2^-22, far
    # below either kernel's error, to show how far the path's sequence moves
    # for a difference of that size alone
    def perturbed(*args):
        return current(*args) * (1.0 + 2.0 ** -22)

    runs = {}
    for name, fn in (("current", current), ("earlier", old.ksum), ("perturbed", perturbed),
                     ("float64", float64)):
        ks.ksum = fn
        try:
            t0 = time.perf_counter()
            psr = cs.grid_eta_psr(ks)
            torch.cuda.synchronize()
            setup = time.perf_counter() - t0
            fes, run_s, reg_s = cs.grid_eta_run(psr, iters=2)
        finally:
            ks.ksum = current
        runs[name] = {"FE_sequence": fes, "setup_seconds": setup, "run_seconds": run_s,
                      "reg_opt_seconds": reg_s,
                      "fe_increase_events": psr.fe_increase_events}
        print(json.dumps({"grid_eta_path_from_float64_start": name, **runs[name]}),
              flush=True)
        del psr
        torch.cuda.empty_cache()
    out["grid_eta_path_from_float64_start"] = runs
    out["rel_diff_entries"] = {}
    for a, b in (("current", "earlier"), ("current", "float64"), ("earlier", "float64"),
                 ("perturbed", "current")):
        fa, fb = runs[a]["FE_sequence"], runs[b]["FE_sequence"]
        out["rel_diff_entries"][f"{a}_vs_{b}"] = [abs(x - y) / abs(y) for x, y in zip(fa, fb)]
    print(json.dumps({"rel_diff_entries": out["rel_diff_entries"], "tol": cs.TOL_ROUTE_FE}))
    print(out["device"])
    return out


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("ksum_ab: CUDA is not available", file=sys.stderr)
        return 2
    if len(argv) != 2 or argv[0] not in ("time", "eta"):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from difficp_torch.ops import ksum as ks
    from difficp_torch.ops import pair_poly as pp

    torch.backends.cuda.matmul.allow_tf32 = False
    old = load(Path(argv[1]).resolve())
    if argv[0] == "time":
        res, name = time_calls(cs, ks, pp, old), "ksum_ab.json"
    else:
        res, name = eta_paths(cs, ks, old), "ksum_ab_eta.json"
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / name).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
