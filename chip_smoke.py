#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``difficp_torch``) on one CUDA card.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each printing JSON lines with its seconds:
  1. device      the card's name and power limit (nvidia-smi);
  2. build       nvcc builds the kernels of difficp_torch/csrc from source,
                 one nvcc per source, all started together (and, for
                 comparison, one nvcc call over all sources is timed);
  3. check       each kernel against its plain PyTorch version on the card
                 (the plain version evaluated in float64 on the same float32
                 inputs): the self RHS at M = 16,381 (ragged, ~10% masked) and
                 65,536; the ext RHS on 3 frames of N = 16,381 (ragged) and
                 65,536 data points against their grid support at sigma = 0.05
                 and a masked custom support; kmin2 on 33 leading frames with
                 duplicated points, both modes; d = 2 and 3, logdet on and off;
  4. timing      each kernel at the shape its main path gives it: first held
                 against its plain version in float64 there (the grid path's
                 10 frames of 65,536 x M for the self and ext kernels, its 110
                 coverage frames for kmin2), then timed with CUDA events
                 (median of 15) beside its plain version, its bound and, where
                 one PyTorch call computes the same function, that call's
                 time;
  5. main path   (dense support) examples/run_large.main at N = 65,536;
                 then a small run through the kernel route against the dense
                 route on the card;
  6. api         icp_two_set with dense support at N_A = N_B = 4,096;
  7. grid main path  bench.py's atlas workload widened to 10 frames of
                 65,536 points with grid support at sigma = 0.05: DiffPSR.run
                 and one stepwise Reg_opt (the coverage pass, kmin2);
  8. grid route agreement  the same workload at 3 x 4,000 points through the
                 kernel route and the dense route;
  9. api grid    icp_two_set and icp_atlas with default numerical options;
 10. profile     a torch.profiler trace of one outer iteration of the grid
                 main path: device-busy share, top CUDA operations, launches,
                 host time between launches.
Each main path is driven with the launch counters set to 0 just before it
and read just after.  Then the kernels line, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}.  Any failure exits non-zero before
it.

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
# kmin2 against its plain version: one rounding of a square
TOL_KMIN2 = 1e-6
# FE of the kernel route vs the dense route on one small run: the bound the
# JAX package uses between two of its own L-BFGS orderings
# (tests/test_psr_basic.py:104)
TOL_ROUTE_FE = 5e-3

SIGMA = 0.1
# the grid-support slice: sigma_LDDMM at which 65,536-point spiral frames
# leave the JAX package's dense route (grid M ~ 342, M (M + N) ~ 2.2e7 pairs)
GRID_SIGMA = 0.05
GRID_RUN = dict(max_em=25, em_tol=1e-3, reg_nmax=10, reg_tol=1e-3, reg_inner=10,
                reg_ls=12)


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


def one_call_build_seconds(_build):
    """Wall seconds of one nvcc call over every source with the build's
    flags (nvcc then compiles them one after another), beside the build's
    one nvcc per source, all started together."""
    out = _build.BUILD_DIR / "one_call_probe.so"
    sources = sorted(_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", *map(str, sources),
                    "-o", str(out)], capture_output=True, check=True)
    seconds = time.perf_counter() - t0
    out.unlink()
    return seconds


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


def abs_err(x, ref):
    return float((x.double() - ref).abs().max())


def reset(*counters):
    for c in counters:
        for key in c:
            c[key] = 0


def bound(pairs, ops, exps, nbytes):
    """The least time of the work: the largest of its FP32 operations over
    the FP32 peak, its exponentials over the MUFU rate and its bytes over
    the memory rate (milliseconds)."""
    t_fp32 = pairs * ops / PEAK_FP32_FLOPS * 1e3
    t_mufu = exps / PEAK_EX2_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    b = max(t_fp32, t_mufu, t_bytes)
    return dict(bound_ms=b, bound_by="bytes" if t_bytes == b else "operations",
                bound_fp32_ms=t_fp32, bound_mufu_ms=t_mufu, bound_bytes_ms=t_bytes)


def grid_frames(k, n, dim=2):
    """bench.py's atlas frames widened: frame i is spiral_cloud(n, rng(i)),
    every odd frame warped."""
    import numpy as np
    from difficp_torch.examples.run_large import spiral_cloud, warp

    frames = []
    for i in range(k):
        x = spiral_cloud(n, np.random.default_rng(i), dim=dim)
        frames.append(warp(x, dim) if i % 2 else x)
    return frames


def grid_psr(k, n):
    """bench.py's atlas workload (bench.py:82-105) at k frames of n points:
    C = 20 GMM components from 20 points of frame 0, hybrid LDDMM at
    sigma = 0.05, nt = 10 Euler, grid support with rho = 1."""
    import numpy as np
    from difficp_torch.models import gmm, lddmm
    from difficp_torch.models.psr import DiffPSR

    x = grid_frames(k, n)
    mu0 = x[0][np.random.default_rng(0).integers(0, n, 20)]
    state, _ = gmm.create(mu0, device="cuda")
    gcfg = gmm.GMMConfig(optimize_mu=True, optimize_sigma=True, optimize_w=True,
                         optimize_eta0=False)
    lcfg = lddmm.make_config(sigma=GRID_SIGMA, lambd=5e2, version="hybrid", nt=10,
                             scheme="Euler")
    psr = DiffPSR(x, state, gcfg, lcfg, device="cuda")
    psr.printstuff = False
    psr.set_support_scheme("grid", rho=1.0)
    return psr


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
        bd = bound(upairs, ops, upairs, nbytes)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, **bd,
                         share_of_bound=bd["bound_ms"] / ms,
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


def ext_inputs(k, n, d, masked, support, seed):
    """k spiral frames of n data points (ragged: ~10% masked and a padded
    tail) with the grid support grid_support gives on them at sigma = 0.05,
    or a masked custom support; random momenta and cotangents."""
    import numpy as np
    import torch
    from difficp_torch.utils.point_sets import grid_support

    g = torch.Generator().manual_seed(seed)
    x = torch.as_tensor(np.stack(grid_frames(k, n, dim=d)))
    mx = torch.ones((k, n))
    if masked:
        mx = (torch.rand((k, n), generator=g) > 0.1).float()
        mx[:, -7:] = 0.0
    if support == "grid":
        q = torch.as_tensor(grid_support(x.reshape(-1, d).numpy(), GRID_SIGMA))
        q = q.expand(k, *q.shape).contiguous()
        mq = torch.ones(q.shape[:-1])
    else:  # custom: 500 points of the data's box, ~20% masked
        lo, hi = x.reshape(-1, d).amin(0), x.reshape(-1, d).amax(0)
        q = lo + (hi - lo) * torch.rand((k, 500, d), generator=g)
        mq = (torch.rand((k, 500), generator=g) > 0.2).float()
    p = 0.05 * torch.randn(q.shape, generator=g) * mq[..., None]
    gx = torch.randn(x.shape, generator=g)
    gc = torch.randn((k,), generator=g)
    return [t.cuda() for t in (x, mx, q, p, mq, gx, gc)]


def phase_check_ext(re, k2):
    """The three ext kernels and kmin2 against their plain versions in
    float64 on the same float32 inputs."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    worst = {name: [0.0, 0.0] for name in
             ("rhs_ext_fwd", "rhs_ext_bwd_dx", "rhs_ext_bwd_dqdp", "kmin2")}

    def note(name, rel, ab):
        worst[name][0] = max(worst[name][0], rel)
        worst[name][1] = max(worst[name][1], ab)

    for n, masked in ((16381, True), (65536, False)):
        for d in (2, 3):
            for support in ("grid", "custom"):
                x, mx, q, p, mq, gx, gc = ext_inputs(3, n, d, masked, support,
                                                     seed=n + d)
                for wl in (True, False):
                    vx, dc = re.rhs_ext_fwd(x, mx, q, p, mq, GRID_SIGMA, wl)
                    dx = re.rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc, GRID_SIGMA, wl)
                    dq, dp = re.rhs_ext_bwd_dqdp(x, mx, gx, q, p, mq, gc, GRID_SIGMA, wl)
                    torch.cuda.synchronize()
                    x8, mx8, q8, p8, mq8, gx8, gc8 = (t.double() for t in
                                                      (x, mx, q, p, mq, gx, gc))
                    rvx, rdc = re.rhs_ext_fwd_reference(x8, mx8, q8, p8, mq8,
                                                        GRID_SIGMA, wl)
                    rdx = re.rhs_ext_bwd_dx_reference(x8, mx8, gx8, q8, p8, mq8, gc8,
                                                      GRID_SIGMA, wl)
                    rdq, rdp = re.rhs_ext_bwd_dqdp_reference(x8, mx8, gx8, q8, p8,
                                                             mq8, gc8, GRID_SIGMA, wl)
                    torch.cuda.synchronize()
                    fwd = rel_err(vx, rvx)
                    dc_rel = float((dc.double().sum(-1) - rdc.sum(-1)).abs().max()
                                   / rdc.abs().sum(-1).max().clamp_min(1e-300))
                    dx_rel = rel_err(dx, rdx)
                    dqdp_rel = max(rel_err(dq, rdq), rel_err(dp, rdp))
                    ok = (fwd <= TOL_FWD and dc_rel <= TOL_FWD and dx_rel <= TOL_BWD
                          and dqdp_rel <= TOL_BWD)
                    emit({"phase": "check_ext", "frames": 3, "N": n, "M": q.shape[1],
                          "support": support, "d": d, "withlogdet": wl,
                          "masked": masked, "fwd_rel_err": fwd, "dcost_rel_err": dc_rel,
                          "dx_rel_err": dx_rel, "dqdp_rel_err": dqdp_rel,
                          "tol_fwd": TOL_FWD, "tol_bwd": TOL_BWD, "ok": ok})
                    if not ok:
                        fail("check_ext", f"an ext kernel disagrees with its plain "
                                          f"version at N={n} d={d} {support} "
                                          f"withlogdet={wl}")
                    note("rhs_ext_fwd", max(fwd, dc_rel), abs_err(vx, rvx))
                    note("rhs_ext_bwd_dx", dx_rel, abs_err(dx, rdx))
                    note("rhs_ext_bwd_dqdp", dqdp_rel,
                         max(abs_err(dq, rdq), abs_err(dp, rdp)))

    # kmin2: 33 leading frames (3 x 11, as the coverage pass of 3 frames at
    # nt = 10 sends them), duplicated points, both modes
    rng = np.random.default_rng(5)
    for d in (2, 3):
        for exclude_self, (n, m) in ((False, (16381, 500)), (True, (4096, 4096))):
            y = rng.uniform(size=(3, 11, m, d))
            y[..., m // 2:m // 2 + 100, :] = y[..., :100, :]
            x = y if exclude_self else rng.uniform(size=(3, 11, n, d))
            if not exclude_self:
                x[..., :50, :] = y[..., 200:250, :]  # distance 0 to a y
            my = (rng.uniform(size=(3, 11, m)) > 0.1).astype(np.float64)
            x, y, my = (torch.tensor(t, dtype=torch.float32, device="cuda")
                        for t in (x, y, my))
            m1, m2 = k2.kmin2(x, y, my, exclude_self)
            r1, r2 = k2.kmin2_reference(x.double(), y.double(), my.double(), exclude_self)
            torch.cuda.synchronize()
            fin = torch.isfinite(r1) & torch.isfinite(r2)
            same_inf = bool(((torch.isinf(m1.double()) == torch.isinf(r1))
                             & (torch.isinf(m2.double()) == torch.isinf(r2))).all())
            rel = max(float(((a.double() - b).abs() / b.abs().clamp_min(1e-30))[fin].max())
                      for a, b in ((m1, r1), (m2, r2)))
            ab = max(abs_err(a[fin], b[fin]) for a, b in ((m1, r1), (m2, r2)))
            ok = same_inf and rel <= TOL_KMIN2
            emit({"phase": "check_kmin2", "frames": [3, 11], "N": n, "M": m, "d": d,
                  "exclude_self": exclude_self, "ties": int((m1 == m2).sum()),
                  "rel_err": rel, "tol": TOL_KMIN2, "ok": ok})
            if not ok:
                fail("check_kmin2", f"kmin2 disagrees with its plain version at d={d} "
                                    f"exclude_self={exclude_self}")
            note("kmin2", rel, ab)
    emit({"phase": "check_ext_done", "seconds": time.perf_counter() - t0})
    return worst


def phase_timing_ext(rs, re, k2):
    """Each new kernel at the grid main path's shape (K = 10, N = 65,536,
    the run's grid M, d = 2); kmin2 at the coverage pass's (nt + 1) K
    frames.  Each kernel of the grid path, the self kernels on the support
    included, is first held against its plain version in float64 on the same
    inputs.  Then CUDA events, median of 15."""
    import numpy as np
    import torch
    from difficp_torch.utils.point_sets import grid_support

    t0 = time.perf_counter()
    k, n, d, nt = 10, 65536, 2, 10
    x = torch.as_tensor(np.stack(grid_frames(k, n))).cuda()
    qg = torch.as_tensor(grid_support(x.reshape(-1, d).cpu().numpy(), GRID_SIGMA))
    m = qg.shape[0]
    g = torch.Generator(device="cuda").manual_seed(3)
    # the support of each frame moved a little, as along a trajectory
    q = qg.cuda() + 0.1 * GRID_SIGMA * torch.randn((k, m, d), generator=g, device="cuda")
    p = 0.05 * torch.randn(q.shape, generator=g, device="cuda")
    mx = torch.ones((k, n), device="cuda")
    mq = torch.ones((k, m), device="cuda")
    gx = torch.randn(x.shape, generator=g, device="cuda")
    gc = torch.randn((k,), generator=g, device="cuda")
    gv = torch.randn(q.shape, generator=g, device="cuda")
    gw = torch.randn(q.shape, generator=g, device="cuda")
    # the work this run's data needs: every unmasked (x, q) pair once
    pairs = float((mx.sum(-1) * mq.sum(-1)).sum())
    side_x, side_q = 4.0 * k * n, 4.0 * k * m
    # the coverage pass: nt + 1 time steps of every frame, each moved a little
    xs = [(x + 0.1 * GRID_SIGMA * torch.randn((nt + 1, k, n, d), generator=g,
                                              device="cuda")).reshape(-1, n, d),
          (q + 0.1 * GRID_SIGMA * torch.randn((nt + 1, k, m, d), generator=g,
                                              device="cuda")).reshape(-1, m, d),
          mq.expand(nt + 1, k, m).reshape(-1, m).contiguous()]
    cov_pairs = float(xs[0].shape[0]) * n * m
    sig = GRID_SIGMA

    worst = {}

    def hold(name, got, ref, tol, dcost=None, **shape):
        rel = max(rel_err(a, r) for a, r in zip(got, ref))
        ab = max(abs_err(a, r) for a, r in zip(got, ref))
        rec = {"phase": "check_main_shape", "kernel": name, **shape}
        if dcost is not None:
            # each frame's dcost against the sum of its terms' magnitudes
            dc, rdc = dcost
            dc_rel = float((dc.double().sum(-1) - rdc.sum(-1)).abs().max()
                           / rdc.abs().sum(-1).max().clamp_min(1e-300))
            rec["dcost_rel_err"] = dc_rel
            rel = max(rel, dc_rel)
        ok = rel <= tol
        emit({**rec, "rel_err": rel, "abs_err": ab, "tol": tol, "ok": ok})
        if not ok:
            fail("check_main_shape", f"{name} disagrees with its plain version "
                                     f"at the grid path's shape {shape}")
        old = worst.get(name, (0.0, 0.0))
        worst[name] = [max(old[0], rel), max(old[1], ab)]

    f64 = [t.double() for t in (x, mx, q, p, mq, gx, gc, gv, gw)]
    x8, mx8, q8, p8, mq8, gx8, gc8, gv8, gw8 = f64
    shape = {"frames": k, "N": n, "M": m, "d": d}
    # logdet off is the grid path's mode (and a zero dcost cotangent for the
    # self backward); logdet on covers the rest of each kernel
    for wl in (True, False):
        got = rs.rhs_self_fwd(q, p, mq, sig, wl)
        ref = rs.rhs_self_fwd_reference(q8, p8, mq8, sig, wl)
        hold("rhs_self_fwd", got[:2], ref[:2], TOL_FWD, (got[2], ref[2]),
             withlogdet=wl, **shape)
        cot, cot8 = (gc, gc8) if wl else (torch.zeros_like(gc), torch.zeros_like(gc8))
        hold("rhs_self_bwd", rs.rhs_self_bwd(q, p, mq, gv, gw, cot, sig, wl),
             rs.rhs_self_bwd_reference(q8, p8, mq8, gv8, gw8, cot8, sig, wl),
             TOL_BWD, withlogdet=wl, **shape)
        vx, dc = re.rhs_ext_fwd(x, mx, q, p, mq, sig, wl)
        rvx, rdc = re.rhs_ext_fwd_reference(x8, mx8, q8, p8, mq8, sig, wl)
        hold("rhs_ext_fwd", [vx], [rvx], TOL_FWD, (dc, rdc), withlogdet=wl, **shape)
        hold("rhs_ext_bwd_dx", [re.rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc, sig, wl)],
             [re.rhs_ext_bwd_dx_reference(x8, mx8, gx8, q8, p8, mq8, gc8, sig, wl)],
             TOL_BWD, withlogdet=wl, **shape)
        hold("rhs_ext_bwd_dqdp", re.rhs_ext_bwd_dqdp(x, mx, gx, q, p, mq, gc, sig, wl),
             re.rhs_ext_bwd_dqdp_reference(x8, mx8, gx8, q8, p8, mq8, gc8, sig, wl),
             TOL_BWD, withlogdet=wl, **shape)
    del f64, x8, mx8, q8, p8, mq8, gx8, gc8, gv8, gw8, got, ref, vx, dc, rvx, rdc
    # kmin2 over all (nt + 1) K frames in one launch; its float64 plain version
    # one time step (K frames) at a time, to bound its memory
    m1, m2 = k2.kmin2(*xs)
    refs = [k2.kmin2_reference(*(t[s:s + k].double() for t in xs))
            for s in range(0, xs[0].shape[0], k)]
    r1, r2 = (torch.cat([r[i] for r in refs]) for i in (0, 1))
    del refs
    # relative to each distance: a plain rel_err over the largest would hide
    # the small ones the coverage check reads
    rel = max(float(((a.double() - b).abs() / b.abs().clamp_min(1e-30)).max())
              for a, b in ((m1, r1), (m2, r2)))
    ab = max(abs_err(a, b) for a, b in ((m1, r1), (m2, r2)))
    ok = rel <= TOL_KMIN2
    emit({"phase": "check_main_shape", "kernel": "kmin2", "frames": xs[0].shape[0],
          "N": n, "M": m, "d": d, "rel_err": rel, "abs_err": ab, "tol": TOL_KMIN2,
          "ok": ok})
    if not ok:
        fail("check_main_shape", "kmin2 disagrees with its plain version at the "
                                 "coverage pass's shape")
    worst["kmin2"] = [rel, ab]
    del m1, m2, r1, r2
    torch.cuda.empty_cache()

    def library_kmin2():
        dist = torch.cdist(xs[0], xs[1])
        return torch.topk(dist, 2, dim=-1, largest=False)

    cases = (
        ("rhs_ext_fwd", lambda: re.rhs_ext_fwd(x, mx, q, p, mq, sig, True),
         lambda: re.rhs_ext_fwd_reference(x, mx, q, p, mq, sig, True),
         None, pairs, re.fwd_ops_per_pair(d), pairs,
         side_x * (d + 1) + side_q * (2 * d + 1) + side_x * d + 4.0 * k),
        ("rhs_ext_bwd_dx", lambda: re.rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc, sig, True),
         lambda: re.rhs_ext_bwd_dx_reference(x, mx, gx, q, p, mq, gc, sig, True),
         None, pairs, re.dx_ops_per_pair(d), pairs,
         side_x * (2 * d + 1) + side_q * (2 * d + 1) + 4.0 * k + side_x * d),
        ("rhs_ext_bwd_dqdp",
         lambda: re.rhs_ext_bwd_dqdp(x, mx, gx, q, p, mq, gc, sig, True),
         lambda: re.rhs_ext_bwd_dqdp_reference(x, mx, gx, q, p, mq, gc, sig, True),
         None, pairs, re.dqdp_ops_per_pair(d), pairs,
         side_x * (2 * d + 1) + side_q * (2 * d + 1) + 4.0 * k + side_q * 2 * d),
        ("kmin2", lambda: k2.kmin2(*xs), lambda: k2.kmin2_reference(*xs),
         library_kmin2, cov_pairs, k2.ops_per_pair(d), 0.0,
         4.0 * xs[0].shape[0] * (n * d + m * (d + 1) + 2 * n)),
    )
    out = {}
    for name, fn, plain, library, npairs, ops, exps, nbytes in cases:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ms = cuda_ms(fn, 15)
        plain()
        torch.cuda.synchronize()
        plain_ms = cuda_ms(plain, 3)
        library_ms = None
        if library is not None:
            library()
            torch.cuda.synchronize()
            library_ms = cuda_ms(library, 3)
        bd = bound(npairs, ops, exps, nbytes)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bd,
                         share_of_bound=bd["bound_ms"] / ms, pairs=npairs,
                         fp32_ops_per_pair=ops, bytes=nbytes,
                         frames=xs[0].shape[0] if name == "kmin2" else k, N=n, M=m,
                         gpair_per_s=npairs / (ms * 1e-3) / 1e9)
        emit({"phase": "timing", "kernel": name, "d": d, **out[name]})
    torch.cuda.empty_cache()
    emit({"phase": "timing_ext_done", "seconds": time.perf_counter() - t0})
    return out, worst


def phase_grid_main_path(counters):
    """bench.py's atlas workload at 10 x 65,536 points with grid support:
    DiffPSR.run(2) and one stepwise Reg_opt with its coverage pass.  Where
    its time goes is read from the trace of the profile phase."""
    import torch

    k, n = 10, 65536
    reset(*counters.values())
    t0 = time.perf_counter()
    psr = grid_psr(k, n)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    fe0 = psr.FE
    t1 = time.perf_counter()
    fes = psr.run(2, **GRID_RUN)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    psr.Reg_opt(tol=1e-3, nmax=1, inner=10, ls_steps=12)
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t2
    seconds = time.perf_counter() - t0
    launches = {name: dict(c) for name, c in counters.items()}
    flat = {key: v for c in launches.values() for key, v in c.items()}
    x1 = psr.x1
    fe_seq = [fe0, *map(float, fes), psr.FE]
    rec = {"phase": "grid_main_path", "frames": k, "n_points": n,
           "grid_M": int(psr.q0.shape[1]), "sigma_lddmm": GRID_SIGMA,
           "setup_seconds": setup, "run_seconds": run_s,
           "seconds_per_outer_iteration": run_s / 2, "reg_opt_seconds": reg_s,
           "seconds": seconds, "FE_sequence": fe_seq,
           "fe_increase_events": psr.fe_increase_events,
           "uncovered": psr.last_reg_stats["uncovered"].cpu().tolist(),
           "last_reg_evals": psr.last_reg_evals.cpu().tolist(),
           "launches": flat}
    emit(rec)
    if not all(v > 0 for v in flat.values()):
        fail("grid_main_path", f"a kernel of the path never launched: {flat}")
    monotone = all(b <= a + 1e-4 * abs(a) + 1e-6 for a, b in zip(fe_seq, fe_seq[1:]))
    if not (all(map(math.isfinite, fe_seq)) and monotone
            and psr.fe_increase_events == 0):
        fail("grid_main_path", "free energy not finite or not monotone")
    if not fe_seq[-1] < fe_seq[0]:
        fail("grid_main_path", "free energy did not decrease over the run")
    if tuple(x1.shape) != (k, n, 2) or not bool(torch.isfinite(x1).all()):
        fail("grid_main_path", "warped points have the wrong shape or are not finite")
    return psr, flat


def phase_grid_route_agreement(backend):
    import torch

    t0 = time.perf_counter()
    fes = {}
    for mode in ("kernel", "dense"):
        backend.set_backend(mode)
        try:
            psr = grid_psr(3, 4000)
            psr.run(2, **GRID_RUN)
            psr.Reg_opt(tol=1e-3, nmax=1, inner=10, ls_steps=12)
            torch.cuda.synchronize()
        finally:
            backend.set_backend(None)
        fes[mode] = psr.FE
    rel = abs(fes["kernel"] - fes["dense"]) / abs(fes["dense"])
    emit({"phase": "grid_route_agreement", "frames": 3, "n_points": 4000,
          "grid_M": int(psr.q0.shape[1]), "FE_kernel": fes["kernel"],
          "FE_dense": fes["dense"], "rel_diff": rel, "tol": TOL_ROUTE_FE,
          "seconds": time.perf_counter() - t0})
    if rel > TOL_ROUTE_FE:
        fail("grid_route_agreement", "kernel and dense routes disagree")


def phase_api_grid(counters, icp_two_set, icp_atlas):
    """icp_two_set and icp_atlas with default numerical_options (grid
    support, rho = 1) on the card."""
    import numpy as np
    import torch
    from difficp_torch.examples.run_large import spiral_cloud, warp

    n = 16384
    rng = np.random.default_rng(2)
    x_a = spiral_cloud(n, rng)
    x_b = warp(spiral_cloud(n, rng), 2)
    reg = {"type": "diffeomorphic", "sigma_LDDMM": GRID_SIGMA, "lambda_LDDMM": 5e2}
    for name, call in (
        ("icp_two_set", lambda cb: icp_two_set(
            x_a, x_b, GMM_parameters={"sigma": 0.05, "optimize_sigma": True},
            registration_parameters=reg, optim_options={"max_iterations": 2},
            printstuff=False, callback_function=cb, device="cuda")),
        ("icp_atlas", lambda cb: icp_atlas(
            grid_frames(4, n), GMM_parameters={"init_components": 20},
            registration_parameters=reg, optim_options={"max_iterations": 2},
            printstuff=False, callback_function=cb, device="cuda")),
    ):
        fes = []
        reset(*counters.values())
        t0 = time.perf_counter()
        psr, _ = call(lambda p, after_gmm: fes.append(p.FE))
        torch.cuda.synchronize()
        flat = {key: v for c in counters.values() for key, v in c.items()}
        emit({"phase": "api_grid", "entry": name, "n_points": n,
              "frames": psr.K, "support": psr.support_scheme,
              "grid_M": int(psr.q0.shape[1]),
              "seconds": time.perf_counter() - t0, "FE_sequence": fes,
              "fe_increase_events": psr.fe_increase_events, "launches": flat})
        monotone = all(b <= a + 1e-4 * abs(a) + 1e-6 for a, b in zip(fes, fes[1:]))
        if not (monotone and psr.fe_increase_events == 0 and math.isfinite(psr.FE)):
            fail("api_grid", f"{name}: free energy not monotone")
        if psr.support_scheme != "grid" or not all(
                flat[key] > 0 for key in ("rhs_ext_fwd", "rhs_ext_bwd_dx",
                                          "rhs_ext_bwd_dqdp", "kmin2")):
            fail("api_grid", f"{name} did not take the grid kernel route: {flat}")


def phase_profile(psr, counters):
    """A torch.profiler trace (CPU and CUDA activities) of one outer
    iteration of the grid main path.  One untraced iteration runs first: its
    wall time shows what the tracing costs the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psr.run(1, **GRID_RUN)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    reset(*counters.values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        psr.run(1, **GRID_RUN)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                      if e.device_type == DeviceType.CUDA), key=lambda t: t[0])
    if not kernels:
        fail("profile", "the trace holds no device activity")
    host = [e for e in events if e.device_type == DeviceType.CPU]
    lo = min(e.time_range.start for e in host)
    hi = max(max(e.time_range.end for e in host), kernels[-1][1])
    busy, gaps, end = 0.0, [], None
    for s0, s1, _ in kernels:
        if end is None or s0 >= end:
            if end is not None:
                gaps.append(s0 - end)
            busy += s1 - s0
            end = s1
        elif s1 > end:
            busy += s1 - end
            end = s1
    by_name = {}
    for s0, s1, name in kernels:
        tot, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (s1 - s0), cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    window_us = hi - lo
    gaps.sort()
    # one loss+grad evaluation is nt dq/dp launches (Euler)
    evals = counters["rhs_ext"]["rhs_ext_bwd_dqdp"] / psr.lcfg.nt
    rec = {"phase": "profile", "window_ms": window_us / 1e3, "wall_ms": wall_ms,
           "untraced_wall_ms": untraced_ms,
           "device_busy_ms": busy / 1e3, "device_busy_share": busy / window_us,
           "device_idle_share": 1.0 - busy / window_us,
           "busy_share_of_untraced_wall": busy / 1e3 / untraced_ms,
           "kernel_launches": len(kernels), "loss_grad_evals": evals,
           "launches_per_loss_grad": len(kernels) / max(evals, 1),
           "host_gap_total_ms": sum(gaps) / 1e3,
           "host_gap_median_us": gaps[len(gaps) // 2] if gaps else 0.0,
           "host_gap_p90_us": gaps[int(0.9 * len(gaps))] if gaps else 0.0,
           "top_cuda_ops": [{"name": name[:90], "ms": tot / 1e3, "count": cnt}
                            for name, (tot, cnt) in top]}
    emit(rec)
    if not 0.0 < rec["device_busy_share"] <= 1.0:
        fail("profile", "device-busy share out of range")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "difficp_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout holding difficp_torch/", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    from difficp_torch.api.icp_atlas import icp_atlas
    from difficp_torch.api.icp_two_set import icp_two_set
    from difficp_torch.examples import run_large
    from difficp_torch.ops import _build, backend
    from difficp_torch.ops import kmin2 as k2
    from difficp_torch.ops import rhs_ext as re
    from difficp_torch.ops import rhs_self as rs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    _build.build(force=True)
    _build.library()
    regs = [ln.strip() for ln in _build.build_log.splitlines() if "registers" in ln]
    emit({"phase": "build", "seconds": _build.build_seconds,
          "one_call_seconds": one_call_build_seconds(_build), "ptxas": regs})

    counters = {"rhs_self": rs.launches, "rhs_ext": re.launches, "kmin2": k2.launches}
    t0 = time.perf_counter()
    worst = phase_check(rs)
    emit({"phase": "check_done", "seconds": time.perf_counter() - t0})
    worst.update(phase_check_ext(re, k2))
    t0 = time.perf_counter()
    timing = phase_timing(rs)
    emit({"phase": "timing_done", "seconds": time.perf_counter() - t0})
    timing_ext, worst_main = phase_timing_ext(rs, re, k2)
    timing.update(timing_ext)
    for name, (rel, ab) in worst_main.items():
        worst[name] = [max(worst[name][0], rel), max(worst[name][1], ab)]
    t0 = time.perf_counter()
    dense_launches = phase_main_path(rs, backend, run_large, timing)
    emit({"phase": "main_path_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    phase_api(rs, backend, icp_two_set, run_large)
    emit({"phase": "api_done", "seconds": time.perf_counter() - t0})
    psr, grid_launches = phase_grid_main_path(counters)
    phase_grid_route_agreement(backend)
    phase_api_grid(counters, icp_two_set, icp_atlas)
    t0 = time.perf_counter()
    phase_profile(psr, counters)
    emit({"phase": "profile_done", "seconds": time.perf_counter() - t0})

    pr = "difficp_tpu/ops/pallas_reductions.py"
    sources = {"rhs_self": "difficp_torch/csrc/rhs_self.cu",
               "rhs_ext": "difficp_torch/csrc/rhs_ext.cu",
               "kmin2": "difficp_torch/csrc/kmin2.cu"}
    replaces = {
        "rhs_self_fwd": (sources["rhs_self"], f"{pr}:928", [f"{pr}:1175", f"{pr}:677"]),
        "rhs_self_bwd": (sources["rhs_self"], f"{pr}:742", [f"{pr}:1175"]),
        "rhs_ext_fwd": (sources["rhs_ext"], f"{pr}:271", [f"{pr}:1623"]),
        "rhs_ext_bwd_dx": (sources["rhs_ext"], f"{pr}:1961", [f"{pr}:1669"]),
        "rhs_ext_bwd_dqdp": (sources["rhs_ext"], f"{pr}:1961", [f"{pr}:1744"]),
        "kmin2": (sources["kmin2"], f"{pr}:2065", [f"{pr}:2015"]),
    }
    kernels = []
    for name, (source, rep, also) in replaces.items():
        t = timing[name]
        launches_by_path = {"grid_main_path": grid_launches[name]}
        if name in dense_launches:
            launches_by_path["dense_main_path"] = dense_launches[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": rep,
            "also_replaces": also, "launches": grid_launches[name],
            "launches_by_path": launches_by_path, "max_abs_err": worst[name][1],
            "max_rel_err": worst[name][0], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms")})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
