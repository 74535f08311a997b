#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``difficp_torch``) on one CUDA card.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device     the card's name and power limit (nvidia-smi);
  2. build      nvcc builds the kernels of difficp_torch/csrc from source;
  3. check      each kernel against its plain PyTorch version on the card
                (the plain version evaluated in float64 on the same float32
                inputs), at M = 16,381 (ragged, ~10% masked) and 65,536, d = 2
                and 3, with and without logdet;
  4. timing     each kernel at the main path's shape (M = 65,536, d = 2) with
                CUDA events (median), beside its plain version and its bound;
  5. main path  examples/run_large.main at N = 65,536 points through DiffPSR,
                with the launch counters set to 0 just before and read just
                after; then a small run through the kernel route against the
                dense route on the card;
  6. api        icp_two_set with N_A = N_B = 4,096 points and dense support
                (above the dense pair limit, so through the kernels).
Then the kernels line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero before it.

Exits non-zero without a result when CUDA is unavailable or when the
difficp_torch package is not beside this script.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores and HBM3 bandwidth.  The MUFU (exp2f) issues 16 results per SM per
# clock (CUDA C++ Programming Guide, arithmetic throughput, compute capability
# 9.0) beside 128 FP32 lanes of two operations each, so its rate is 16/256 of
# the float32 peak.  The bound of a kernel is the largest of the function's
# least FP32 work over the first, its exponentials over the MUFU rate, and its
# bytes over the bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_EX2_PER_S = PEAK_FP32_FLOPS * 16 / 256
PEAK_BYTES_PER_S = 3.35e12

# float32 pair sums over up to 65,536 terms, taken in another order than the
# plain version: relative to the largest |plain| output
TOL_FWD = 1e-5
TOL_BWD = 1e-4
# FE of the kernel route vs the dense route on one small run: the bound the
# JAX package uses between two of its own L-BFGS orderings
# (tests/test_psr_basic.py:104)
TOL_ROUTE_FE = 5e-3

SIGMA = 0.1


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(phase, msg):
    emit({"phase": phase, "ok": False, "error": msg})
    sys.exit(1)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Median milliseconds of ``reps`` runs of fn, each timed with CUDA events."""
    import torch

    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def make_inputs(m, d, masked, seed):
    """Spiral-cloud q (the main path's geometry), random p and cotangents."""
    import numpy as np
    import torch
    from difficp_torch.examples.run_large import spiral_cloud

    g = torch.Generator().manual_seed(seed)
    q = torch.as_tensor(spiral_cloud(m, np.random.default_rng(seed), dim=d))[None]
    p = 0.05 * torch.randn((1, m, d), generator=g)
    mask = torch.ones((1, m))
    if masked:
        mask = (torch.rand((1, m), generator=g) > 0.1).float()
    a = torch.randn((1, m, d), generator=g)
    b = torch.randn((1, m, d), generator=g)
    c = torch.randn((1,), generator=g)
    return [t.cuda() for t in (q, p, mask, a, b, c)]


def rel_err(x, ref):
    return float((x.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def phase_check(rs):
    import torch

    worst = {"rhs_self_fwd": [0.0, 0.0], "rhs_self_bwd": [0.0, 0.0]}
    for m, masked in ((16381, True), (65536, False)):
        for d in (2, 3):
            for wl in (True, False):
                q, p, mask, a, b, c = make_inputs(m, d, masked, seed=m + d)
                v, w, dc = rs.rhs_self_fwd(q, p, mask, SIGMA, wl)
                dq, dp = rs.rhs_self_bwd(q, p, mask, a, b, c, SIGMA, wl)
                torch.cuda.synchronize()
                f64 = [t.double() for t in (q, p, mask, a, b, c)]
                rv, rw, rdc = rs.rhs_self_fwd_reference(*f64[:3], SIGMA, wl)
                rq, rp = rs.rhs_self_bwd_reference(*f64, SIGMA, wl)
                torch.cuda.synchronize()
                fwd_rel = max(rel_err(v, rv), rel_err(w, rw))
                dc_rel = float((dc.double().sum() - rdc.sum()).abs()
                               / rdc.abs().sum().clamp_min(1e-300))
                bwd_rel = max(rel_err(dq, rq), rel_err(dp, rp))
                fwd_abs = max(float((x.double() - r).abs().max())
                              for x, r in ((v, rv), (w, rw)))
                bwd_abs = max(float((x.double() - r).abs().max())
                              for x, r in ((dq, rq), (dp, rp)))
                ok = fwd_rel <= TOL_FWD and dc_rel <= TOL_FWD and bwd_rel <= TOL_BWD
                emit({"phase": "check", "M": m, "d": d, "withlogdet": wl,
                      "masked": masked, "fwd_rel_err": fwd_rel,
                      "dcost_rel_err": dc_rel, "bwd_rel_err": bwd_rel,
                      "tol_fwd": TOL_FWD, "tol_bwd": TOL_BWD, "ok": ok})
                if not ok:
                    fail("check", f"kernel disagrees with its plain version at "
                                  f"M={m} d={d} withlogdet={wl}")
                for name, rel, ab in (("rhs_self_fwd", max(fwd_rel, dc_rel), fwd_abs),
                                      ("rhs_self_bwd", bwd_rel, bwd_abs)):
                    worst[name][0] = max(worst[name][0], rel)
                    worst[name][1] = max(worst[name][1], ab)
    return worst


def phase_timing(rs):
    import torch

    m, d = 65536, 2
    q, p, mask, a, b, c = make_inputs(m, d, False, seed=1)
    # work this run's data needs: each unordered pair of unmasked points once
    # (the n diagonal terms, d = 0, are O(n) and left out)
    n = float(mask.sum())
    upairs = n * (n - 1) / 2
    fwd_bytes = 4.0 * m * (2 * d + 1) * 2          # q, p, m in; v, w, dc out
    bwd_bytes = 4.0 * (m * (4 * d + 1) + 1 + m * 2 * d)  # q, p, m, a, b, c in; dq, dp out
    out = {}
    for name, fn, plain, ops, nbytes in (
        ("rhs_self_fwd", lambda: rs.rhs_self_fwd(q, p, mask, SIGMA, True),
         lambda: rs.rhs_self_fwd_reference(q, p, mask, SIGMA, True),
         rs.fwd_ops_per_unordered_pair(d), fwd_bytes),
        ("rhs_self_bwd", lambda: rs.rhs_self_bwd(q, p, mask, a, b, c, SIGMA, True),
         lambda: rs.rhs_self_bwd_reference(q, p, mask, a, b, c, SIGMA, True),
         rs.bwd_ops_per_unordered_pair(d), bwd_bytes),
    ):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ms = cuda_ms(fn, 15)
        plain()
        torch.cuda.synchronize()
        plain_ms = cuda_ms(plain, 3)
        t_fp32 = upairs * ops / PEAK_FP32_FLOPS * 1e3
        t_mufu = upairs / PEAK_EX2_PER_S * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        bound = max(t_fp32, t_mufu, t_bytes)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by="bytes" if t_bytes == bound else "operations",
                         bound_fp32_ms=t_fp32, bound_mufu_ms=t_mufu,
                         bound_bytes_ms=t_bytes, share_of_bound=bound / ms,
                         unordered_pairs=upairs, fp32_ops_per_unordered_pair=ops,
                         gpair_per_s=n * n / (ms * 1e-3) / 1e9)
        emit({"phase": "timing", "kernel": name, "M": m, "d": d, **out[name]})
    return out


def phase_main_path(rs, backend, run_large, timing):
    import torch

    n_points, ls_steps = 65536, 25
    iters = []

    def on_iter(it, psr, seconds):
        torch.cuda.synchronize()
        rec = {"phase": "main_path_iter", "iter": it, "seconds": seconds,
               "FE": psr.FE, "last_reg_evals": psr.last_reg_evals.tolist(),
               "launches": dict(rs.launches)}
        iters.append(rec)
        emit(rec)

    backend.set_backend(None)
    torch.cuda.synchronize()
    for key in rs.launches:
        rs.launches[key] = 0
    t0 = time.perf_counter()
    psr = run_large.main(n_points=n_points, n_iter=2, ls_steps=ls_steps,
                         device="cuda", on_iter=on_iter)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(rs.launches)
    x1 = psr.get_warped_data_points()
    # launches times each kernel's median time from the timing phase: an
    # estimate of the run's time inside the two kernels
    kernel_seconds = sum(launches[k] * timing[k]["ms"] for k in launches) / 1e3
    emit({"phase": "main_path", "n_points": n_points, "ls_steps": ls_steps,
          "seconds": seconds, "FE": psr.FE,
          "fe_increase_events": psr.fe_increase_events, "launches": launches,
          "kernel_seconds_est": kernel_seconds,
          "kernel_share_est": kernel_seconds / seconds})
    if not all(v > 0 for v in launches.values()):
        fail("main_path", f"a kernel of the path never launched: {launches}")
    if not (math.isfinite(psr.FE) and psr.fe_increase_events == 0):
        fail("main_path", "free energy not finite or not monotone")
    if x1.shape != (n_points, 2) or not bool((abs(x1) < 1e6).all()):
        fail("main_path", "warped points have the wrong shape or are not finite")
    if not iters[-1]["FE"] < iters[0]["FE"]:
        fail("main_path", "free energy did not decrease over the run")

    # a small input through both routes on the card: same free energy
    fes = {}
    for mode in ("kernel", "dense"):
        backend.set_backend(mode)
        small = run_large.main(n_points=2000, n_iter=1, c_gmm=16, device="cuda")
        fes[mode] = small.FE
    backend.set_backend(None)
    rel = abs(fes["kernel"] - fes["dense"]) / abs(fes["dense"])
    emit({"phase": "route_agreement", "n_points": 2000, "FE_kernel": fes["kernel"],
          "FE_dense": fes["dense"], "rel_diff": rel, "tol": TOL_ROUTE_FE})
    if rel > TOL_ROUTE_FE:
        fail("route_agreement", "kernel and dense routes disagree")
    return launches


def phase_api(rs, backend, icp_two_set, run_large):
    import numpy as np
    import torch

    n = 4096
    rng = np.random.default_rng(1)
    x_a = run_large.spiral_cloud(n, rng)
    x_b = run_large.warp(run_large.spiral_cloud(n, rng), 2)
    fes = []
    for key in rs.launches:
        rs.launches[key] = 0
    t0 = time.perf_counter()
    psr, _ = icp_two_set(
        x_a, x_b,
        GMM_parameters={"sigma": 0.05, "optimize_sigma": True},
        registration_parameters={"type": "diffeomorphic", "sigma_LDDMM": SIGMA,
                                 "lambda_LDDMM": 200.0},
        numerical_options={"support_LDDMM": {"scheme": "dense"}},
        optim_options={"max_iterations": 2},
        printstuff=False,
        callback_function=lambda p, after_gmm: fes.append(p.FE),
        device="cuda")
    torch.cuda.synchronize()
    backend.set_backend(None)
    rec = {"phase": "api", "n_a": n, "n_b": n, "seconds": time.perf_counter() - t0,
           "FE_sequence": fes, "fe_increase_events": psr.fe_increase_events,
           "launches": dict(rs.launches)}
    emit(rec)
    monotone = all(b <= a + 1e-4 * abs(a) + 1e-6 for a, b in zip(fes, fes[1:]))
    if not (monotone and psr.fe_increase_events == 0 and math.isfinite(psr.FE)):
        fail("api", "free energy not monotone")
    if not all(v > 0 for v in rs.launches.values()):
        fail("api", "icp_two_set did not run through the kernels")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "difficp_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout holding difficp_torch/", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    from difficp_torch.api.icp_two_set import icp_two_set
    from difficp_torch.examples import run_large
    from difficp_torch.ops import _build, backend
    from difficp_torch.ops import rhs_self as rs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    _build.build(force=True)
    _build.library()
    regs = [ln.strip() for ln in _build.build_log.splitlines() if "registers" in ln]
    emit({"phase": "build", "seconds": _build.build_seconds, "ptxas": regs})

    worst = phase_check(rs)
    timing = phase_timing(rs)
    launches = phase_main_path(rs, backend, run_large, timing)
    phase_api(rs, backend, icp_two_set, run_large)

    source = "difficp_torch/csrc/rhs_self.cu"
    replaces = {
        "rhs_self_fwd": ("difficp_tpu/ops/pallas_reductions.py:928",
                         ["difficp_tpu/ops/pallas_reductions.py:1175",
                          "difficp_tpu/ops/pallas_reductions.py:677"]),
        "rhs_self_bwd": ("difficp_tpu/ops/pallas_reductions.py:742",
                         ["difficp_tpu/ops/pallas_reductions.py:1175"]),
    }
    kernels = []
    for name in ("rhs_self_fwd", "rhs_self_bwd"):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces[name][0], "also_replaces": replaces[name][1],
            "launches": launches[name], "max_abs_err": worst[name][1],
            "max_rel_err": worst[name][0], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
