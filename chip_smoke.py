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
                 65,536, also with its rows shuffled, and dq at the dense
                 path's geometry within 1e-5; the ext RHS on 3 frames of
                 N = 16,381 (ragged) and
                 65,536 data points against their grid support at sigma = 0.05
                 and a masked custom support; kmin2 on 33 leading frames with
                 duplicated points, both modes; d = 2 and 3, logdet on and off;
  4. timing      each kernel at the shape its main path gives it: first held
                 against its plain version in float64 there (the grid path's
                 10 frames of 65,536 x M for the self and ext kernels, its 110
                 coverage frames for kmin2), then timed with CUDA events
                 (median of 15) beside its plain version, its bound and, where
                 one PyTorch call computes the same function, that call's
                 time; the self kernels at the dense and the grid path's
                 shapes; for the table kernels (self, cross, ext dx and
                 dq/dp) the bound is the lower of the function's least work
                 and their table route's own, each printed beside it;
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
                 main path, cut to one L-BFGS step (reg_nmax = 1):
                 device-busy share, top CUDA operations, launches, host time
                 between launches;
 11. check eta   the gradcomponent (eta != 0) slice's kernels against their
                 plain versions in float64: the generic kernel-sum (ksum) at
                 3, 6, 9, 20 and 121 columns (d = 2) and 333 (d = 3), masked,
                 several frames, a shared y and a split y axis, and at its
                 tile edges (1, 8, 128, 129 columns; 15, 16, 17 rows); the ETA
                 instances of the self and ext forward kernels; the ETA
                 instances at eta = 0 against the eta = 0 kernels (self:
                 within 1e-5, ext: bit for bit);
 12. timing eta  each of them at the shapes the two eta paths give it, first
                 held against its float64 plain version there, then timed
                 beside its plain version and its bound;
 13. grid eta path  the grid main path with gradcomponent_LDDMM (version
                 "logdet", eta = 1/500), from start momenta computed with the
                 kernel-sum's float64 plain version, so that the sequence it
                 prints depends on the kernels only along the trajectory;
                 at its end the objective and its gradient through ksum
                 against those through the float64 plain version;
 14. dense eta path  examples/run_large.py's configuration with version
                 "logdet" (eta = 1/200) at N = 8,192, driven as
                 run_large.main drives DiffPSR; before it, the stability of
                 its start (v2p's momenta for a zero field, one shoot) at
                 8,192, 16,384 and 32,768 points, in float32 on the kernels
                 and in float64 on their plain versions, which sets that size;
 15. eta route agreement  the grid eta workload at 3 x 8,000 points through
                 the kernel route and the dense route (one outer
                 iteration and a stepwise Reg_opt); and the generated
                 backward's float32 error at the grid path's geometry against
                 float64 dense autograd (the poly-precision line);
 16. api eta     icp_two_set and icp_atlas with gradcomponent_LDDMM=True,
                 one iteration each;
 17. profile eta a torch.profiler trace of one outer iteration of the grid
                 eta path, cut to 5 EM steps and one L-BFGS step of 4 inner
                 iterations, with the host operators by their own CPU time;
 18. check cross the cross forward kernel (rows against a different column
                 set: rhs_cross_fwd, and its ETA instance) against its plain
                 version in float64, distinct sets of 16,384 and 65,536 points
                 with holes, d = 2 and 3, rows also shuffled; its ETA
                 instance at eta = 0 within 1e-5, its self entry bit for bit;
 19. timing cross each instance at its ring path's shape, held against its
                 plain version there, then timed beside it and its bound; the
                 same for ksum at every kernel-sum of both ring paths (the
                 generated cross backward's two tables, the cross
                 Hamiltonian's three);
 20. ring twoset path  the point-sharded two-set registration
                 (parallel/twoset.py over parallel/ring.py) at world size 1
                 over NCCL on run_large's problem at 65,536 points: two
                 make_twoset_step calls against the single-device alternation
                 (EM + lddmm.optimize) at the same budgets, the start loss and
                 gradient against the dense path's, seconds per step and per
                 loss+grad, exact launch counts;
 21. ring eta path  the same with version "logdet" at 8,192 points, one
                 step from the momenta DiffPSR.initialize_a0 gives (zero
                 momenta carry the gradcomponent field, whose shoot diverges
                 on these clouds).
Each main path is driven with the launch counters set to 0 just before it
and read just after; the paths print the free energies of earlier runs bit
for bit or fail, and the eta = 0 paths stay within 5e-3 of those the direct
self kernels printed.  Then the kernels line, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}.  Any failure exits non-zero before
it.

Exits non-zero without a result when CUDA is unavailable or when the
difficp_torch package is not beside this script.
"""

from __future__ import annotations

import contextlib
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
# dense TF32 on the tensor cores (NVIDIA data sheet): the kernel-sum's
# products run there
PEAK_TF32_FLOPS = 495e12

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
# the eta = 0 kernels
ETA0_KERNELS = ("rhs_self_fwd", "rhs_self_bwd", "rhs_ext_fwd", "rhs_ext_bwd_dx",
               "rhs_ext_bwd_dqdp", "kmin2")
# the ext backward's table kernels and their tables (ops/rhs_ext.py)
EXT_BWD_TABLES = {"rhs_ext_bwd_dx": "dx", "rhs_ext_bwd_dqdp": "dqdp"}
# The eta = 0 paths' free energies: *_DIRECT as this script printed them with
# the direct (FP32-pipe) self kernels, *_BEFORE as it printed them first with
# the table kernels on the tensor cores, which sum in another order; the grid
# path also GRID_FE_DIRECT_EXT_BWD, as it printed it with the self kernels on
# the tensor cores and the ext backward (dx, dq/dp) still direct.  Each path
# is held bit for bit to *_BEFORE and within TOL_ROUTE_FE of the others, the
# grid path over their first three entries (its start and its two outer
# iterations): its fourth, one stepwise Reg_opt later, moves 6.2e-3 when the
# self table kernels' outputs are scaled by 1 + 2^-22, as far as two kernels
# differ there (8.7e-3; tools/rhs_self_ab.py fe), so it measures the line
# search, not the kernels.  The kernels along that path are held at its end
# instead (hold_end_state).
GRID_FE_DIRECT = [22501056.0, -1347914.25, -1391784.75]
GRID_FE_DIRECT_EXT_BWD = [22501056.0, -1347946.625, -1391633.875, -1413118.75]
GRID_FE_BEFORE = [22501056.0, -1347924.625, -1392195.5, -1414159.75]
DENSE_FE_DIRECT = [-134942.6875, -135171.546875]
DENSE_FE_BEFORE = [-134947.359375, -135175.125]
# dq of the eta = 0 backward at the dense main path's geometry (a spiral of
# 65,536 points, sigma = 0.1), relative to its largest entry: the JAX
# package's bar for its table-form backward on registration geometry
# (BASELINE.md:111-121)
TOL_DQ_REGISTRATION = 1e-5
# the gradcomponent slice: eta = 1 / lambda of the grid path (lambda = 500) and
# of run_large's configuration (lambda = 200)
GRID_ETA = 1.0 / 500.0
DENSE_ETA = 1.0 / 200.0
# the dense eta path's size: the largest power of two at which its start shoot
# stays bounded in float32 (phase dense_eta_start; from 16,384 points on it
# diverges in float32, and at 32,768 in float64 too)
DENSE_ETA_N = 8192
# the generated backward expands delta powers into raw monomials; above this
# error at the grid path's geometry it is logged as a fault inherited from the
# JAX package
POLY_ERR_LOG = 1e-2
# the eta paths launch ksum, whose tensor-core products sum in another order
# than the FP32-pipe kernel before them: their free energies are held within
# TOL_ROUTE_FE of the sequences that kernel printed (*_FP32_KSUM) and bit for
# bit to the sequences the tensor-core kernel printed first (*_BEFORE).
# The grid eta path starts from momenta computed with the kernel-sum's float64
# plain version (grid_eta_psr): v2p's float32 CG ridge solve on 10 x 65,536
# points turns the kernel-sum's rounding into start momenta 6.3 (FP32-pipe
# kernel) and 11.8 (tensor-core kernel) times the largest entry of that start
# away from it, so from its own float32 start each kernel would run another
# problem.  From the float64 start only its first free energy (one outer
# iteration) is held across kernel-sums, against the FP32-pipe kernel's and
# the float64 plain version's (GRID_ETA_FE_FLOAT64_KSUM): the tensor-core
# kernel with its outputs scaled by 1 + 2^-22 moves the second and third by
# 4.1e-3 and 1.3e-2, as far as the two kernels differ there (4.5e-3, 1.2e-2),
# and the FP32-pipe kernel is 5.1e-3 from the float64 plain version at the
# second (tools/ksum_ab.py eta): those entries are set by the optimizer's
# sensitivity, not by the kernel-sum's accuracy.  The kernel-sum along the
# trajectory is held instead at the path's end (hold_end_state)
GRID_ETA_FE_FP32_KSUM = [-1340070.25]
GRID_ETA_FE_FLOAT64_KSUM = [-1340057.25]
DENSE_ETA_FE_FP32_KSUM = [-16924.4140625] * 3 + [-16957.8828125] * 3
# the eta paths' start momenta come from v2p, whose CG ridge solve multiplies
# by the eta = 0 self forward (kred): with the table kernel their sequences
# moved (first entries 2.8e-4 from the float64 kernel-sum's and 9.6e-5 from
# the FP32-pipe kernel-sum's references) and were recorded again
GRID_ETA_FE_BEFORE = [-1339679.0, -1442487.75, -1484406.875]
DENSE_ETA_FE_BEFORE = ([-16926.025390625] + [-16926.04296875] * 2
                       + [-16959.234375] * 3)
# the point-sharded two-set path (parallel/): run_large's problem, at world
# size 1 on the card; each step em_iters EM steps and one L-BFGS pass, the
# curvature memory carried
RING_N = 65536
# at eta != 0 the start is v2p's momenta for a zero field (as DiffPSR's), whose
# float32 shoot stays bounded up to the dense eta path's size (zero momenta
# carry the gradcomponent field, whose shoot diverges on these clouds)
RING_ETA_N = DENSE_ETA_N
RING_STEP = dict(em_iters=5, reg_nmax=1, reg_inner=20, reg_ls=25, tol=1e-3)
# the two-set free energies against the single-device alternation's: the
# bound tests/test_parallel_twoset.py sets between the JAX package's sharded
# and single-device runs; at eta = 0 the start loss (the same float32 sums in
# other orders) and the start gradient (the generated backward's float32
# error, the bar of ROADMAP.md section 3), relative to the largest entry.  At
# eta != 0 v2p's start is ill-conditioned in float32 (the loss of either route
# is off by ~1e-3 against float64 there), and those two are printed only.
TOL_RING_FE = 1e-2
TOL_RING_START = (1e-4, 1e-2)


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


def ksum_ptxas(log):
    """{"D=d NT=n": [registers, spill-store bytes]} of each instance of the
    ksum kernel, from ptxas's report in the build log."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '.*ksum_kernelILi(\d)ELi(\d+)E", ln)
        if m:
            name = f"D={m.group(1)} NT={m.group(2)}"
            out[name] = [None, None]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            out[name][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name][0] = int(m.group(1))
            name = None
    return out


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


def monotone(fes):
    """Each free energy at most the one before it, within the slack of the
    FE oracle (psr.update_FE)."""
    return all(b <= a + 1e-4 * abs(a) + 1e-6 for a, b in zip(fes, fes[1:]))


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


def grid_psr(k, n, version="hybrid"):
    """bench.py's atlas workload (bench.py:82-105) at k frames of n points:
    C = 20 GMM components from 20 points of frame 0, LDDMM ("hybrid", or
    "logdet" for the gradcomponent model) at sigma = 0.05, lambda = 500,
    nt = 10 Euler, grid support with rho = 1."""
    import numpy as np
    from difficp_torch.models import gmm, lddmm
    from difficp_torch.models.psr import DiffPSR

    x = grid_frames(k, n)
    mu0 = x[0][np.random.default_rng(0).integers(0, n, 20)]
    state, _ = gmm.create(mu0, device="cuda")
    gcfg = gmm.GMMConfig(optimize_mu=True, optimize_sigma=True, optimize_w=True,
                         optimize_eta0=False)
    lcfg = lddmm.make_config(sigma=GRID_SIGMA, lambd=5e2, version=version, nt=10,
                             scheme="Euler")
    psr = DiffPSR(x, state, gcfg, lcfg, device="cuda")
    psr.printstuff = False
    psr.set_support_scheme("grid", rho=1.0)
    return psr


def phase_check(rs):
    """The self kernels against their plain versions in float64 on the same
    float32 inputs, at M = 16,381 (ragged, ~10% masked) and 65,536, d = 2 and
    3, logdet on and off; each input also with its rows shuffled (a random
    permutation; the outputs permuted back are held likewise and compared
    with the unshuffled ones); and dq at the dense main path's geometry
    (65,536 spiral points, d = 2, sigma = 0.1) within TOL_DQ_REGISTRATION."""
    import torch

    worst = {"rhs_self_fwd": [0.0, 0.0], "rhs_self_bwd": [0.0, 0.0]}
    g = torch.Generator(device="cuda").manual_seed(7)
    for m, masked in ((16381, True), (65536, False)):
        for d in (2, 3):
            for wl in (True, False):
                q, p, mask, a, b, c = make_inputs(m, d, masked, seed=m + d)
                f64 = [t.double() for t in (q, p, mask, a, b, c)]
                rv, rw, rdc = rs.rhs_self_fwd_reference(*f64[:3], SIGMA, wl)
                rq, rp = rs.rhs_self_bwd_reference(*f64, SIGMA, wl)
                perm = torch.randperm(m, generator=g, device="cuda")
                inv = torch.argsort(perm)
                runs = {}
                for name, rows in (("natural", slice(None)), ("shuffled", perm)):
                    ins = [t[:, rows].contiguous() for t in (q, p, mask, a, b)]
                    out = (*rs.rhs_self_fwd(*ins[:3], SIGMA, wl),
                           *rs.rhs_self_bwd(*ins, c, SIGMA, wl))
                    back = slice(None) if name == "natural" else inv
                    runs[name] = [t[:, back] for t in out]
                torch.cuda.synchronize()
                rec = {"phase": "check", "M": m, "d": d, "withlogdet": wl, "masked": masked}
                ok = True
                for name, (v, w, dc, dq, dp) in runs.items():
                    fwd_rel = max(rel_err(v, rv), rel_err(w, rw))
                    dc_rel = float((dc.double().sum() - rdc.sum()).abs()
                                   / rdc.abs().sum().clamp_min(1e-300))
                    dq_rel = rel_err(dq, rq)
                    bwd_rel = max(dq_rel, rel_err(dp, rp))
                    fwd_abs = max(abs_err(v, rv), abs_err(w, rw))
                    bwd_abs = max(abs_err(dq, rq), abs_err(dp, rp))
                    ok = ok and fwd_rel <= TOL_FWD and dc_rel <= TOL_FWD and bwd_rel <= TOL_BWD
                    if m == 65536 and d == 2:
                        ok = ok and dq_rel <= TOL_DQ_REGISTRATION
                    rec[name] = {"fwd_rel_err": fwd_rel, "dcost_rel_err": dc_rel,
                                 "dq_rel_err": dq_rel, "bwd_rel_err": bwd_rel}
                    for kernel, rel, ab in (("rhs_self_fwd", max(fwd_rel, dc_rel), fwd_abs),
                                            ("rhs_self_bwd", bwd_rel, bwd_abs)):
                        worst[kernel][0] = max(worst[kernel][0], rel)
                        worst[kernel][1] = max(worst[kernel][1], ab)
                rec["shuffled_vs_natural_rel_diff"] = max(
                    rel_err(x, y.double()) for x, y in zip(runs["shuffled"], runs["natural"]))
                emit({**rec, "tol_fwd": TOL_FWD, "tol_bwd": TOL_BWD,
                      "tol_dq_registration": TOL_DQ_REGISTRATION if m == 65536 and d == 2
                      else None, "ok": ok})
                if not ok:
                    fail("check", f"kernel disagrees with its plain version at "
                                  f"M={m} d={d} withlogdet={wl}")
                del runs, f64, rv, rw, rdc, rq, rp
    torch.cuda.empty_cache()
    return worst


def route_bound(pairs, d, tensor_flops):
    """The eta = 0 table kernels' own bound over the pairs they take (ms):
    the largest of the exponentials over the MUFU rate, the padded table's
    3xTF32 products (tensor_flops a pair: ops/rhs_self.py and
    ops/rhs_ext.py tensor_flops_per_pair) over the TF32 peak and the
    FP32-pipe remainder (ops/ksum.py fp32_ops_per_pair) over the FP32
    peak."""
    from difficp_torch.ops import ksum as ks

    terms = {"mufu": pairs / PEAK_EX2_PER_S * 1e3,
             "tensor": pairs * tensor_flops / PEAK_TF32_FLOPS * 1e3,
             "fp32": pairs * ks.fp32_ops_per_pair(d) / PEAK_FP32_FLOPS * 1e3}
    by = max(terms, key=terms.get)
    return dict(bound_route_ms=terms[by], bound_route_by=by)


TABLE_BOUND_KEYS = ("bound_least_work_ms", "bound_least_work_by", "bound_route_ms",
                    "bound_route_by")


def table_bound(least, pairs, d, tensor_flops):
    """The bound of an eta = 0 table kernel: the lower of the function's least
    work on the FP32 pipe (``least``, from bound) and the table route's own
    (route_bound over ``pairs``; the bytes bound beneath both), as bound_ms;
    each beside it (bound_least_work_ms, bound_route_ms)."""
    rb = route_bound(pairs, d, tensor_flops)
    out = dict(least, **rb, bound_least_work_ms=least["bound_ms"],
               bound_least_work_by=least["bound_by"])
    route = max(rb["bound_route_ms"], least["bound_bytes_ms"])
    if route < least["bound_ms"]:
        out.update(bound_ms=route,
                   bound_by="bytes" if route == least["bound_bytes_ms"] else "operations")
    return out


def phase_timing(rs):
    """The self kernels at the dense main path's shape (M = 65,536, d = 2,
    logdet on) and at the grid main path's (its support: 10 frames of the
    grid support at sigma = 0.05, logdet off and a zero dcost cotangent, as
    the ext RHS runs them), each with the rows' order computed once
    beforehand, as the paths do: CUDA events (median of 15) beside the plain
    version and the bound (table_bound: the lower of the function's least
    work and the table route's own); and the row order's own time at the
    dense shape."""
    import torch

    d = 2
    q, p, mask, a, b, c = make_inputs(65536, d, False, seed=1)
    x, _, qs, ps, g = grid_eta_inputs()
    del x
    ms_ = torch.ones(qs.shape[:-1], device="cuda")
    gv, gw = (torch.randn(qs.shape, generator=g, device="cuda") for _ in range(2))
    zero = torch.zeros(qs.shape[:-2], device="cuda")
    out = {}
    for shape, (q_, p_, m_, a_, b_, c_, sig, wl) in (
            ("dense", (q, p, mask, a, b, c, SIGMA, True)),
            ("grid", (qs, ps, ms_, gv, gw, zero, GRID_SIGMA, False))):
        order = rs.row_order(q_, m_, sig)
        nb, m = q_.shape[0], q_.shape[1]
        # work this run's data needs: each unordered pair of unmasked points
        # once (the n diagonal terms, d = 0, are O(n) and left out); the
        # route's ordered pairs
        n = m_.sum(-1)
        upairs = float((n * (n - 1) / 2).sum())
        opairs = float((n * n).sum())
        fwd_bytes = 4.0 * nb * m * (2 * d + 1) * 2  # q, p, m in; v, w, dc out
        # q, p, m, a, b, c in; dq, dp out
        bwd_bytes = 4.0 * (nb * m * (4 * d + 1) + nb + nb * m * 2 * d)
        for name, fn, plain, ops, nbytes, backward in (
            ("rhs_self_fwd",
             lambda: rs.rhs_self_fwd(q_, p_, m_, sig, wl, order=order),
             lambda: rs.rhs_self_fwd_reference(q_, p_, m_, sig, wl),
             rs.fwd_ops_per_unordered_pair(d), fwd_bytes, False),
            ("rhs_self_bwd",
             lambda: rs.rhs_self_bwd(q_, p_, m_, a_, b_, c_, sig, wl, order),
             lambda: rs.rhs_self_bwd_reference(q_, p_, m_, a_, b_, c_, sig, wl),
             rs.bwd_ops_per_unordered_pair(d), bwd_bytes, True),
        ):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            ms = cuda_ms(fn, 15)
            plain()
            torch.cuda.synchronize()
            plain_ms = cuda_ms(plain, 3)
            bd = table_bound(bound(upairs, ops, upairs, nbytes), opairs, d,
                             rs.tensor_flops_per_pair(d, backward))
            key = name if shape == "dense" else f"{name}_grid"
            out[key] = dict(shape=f"{nb} x {m} x {m}", withlogdet=wl, ms=ms,
                            plain_ms=plain_ms, library_ms=None, **bd,
                            share_of_bound=bd["bound_ms"] / ms,
                            share_of_route_bound=bd["bound_route_ms"] / ms,
                            unordered_pairs=upairs, fp32_ops_per_unordered_pair=ops,
                            gpair_per_s=opairs / (ms * 1e-3) / 1e9)
            emit({"phase": "timing", "kernel": name, "d": d, **out[key]})
    order_fn = lambda: rs.row_order(q, mask, SIGMA)  # noqa: E731
    order_fn()
    torch.cuda.synchronize()
    out["row_order_ms"] = cuda_ms(order_fn, 15)
    emit({"phase": "timing", "call": "row_order", "M": q.shape[1],
          "ms": out["row_order_ms"]})
    torch.cuda.empty_cache()
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
    reset(rs.launches, rs.orders)
    t0 = time.perf_counter()
    psr = run_large.main(n_points=n_points, n_iter=2, ls_steps=ls_steps,
                         device="cuda", on_iter=on_iter)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(rs.launches)
    # rows' orders: one per optimisation (and per shoot outside one), never
    # one per ODE step: at most one per loss+grad
    orders = rs.orders["row_order"]
    evals = launches["rhs_self_bwd"] / psr.lcfg.nt
    x1 = psr.get_warped_data_points()
    # launches times each kernel's median time from the timing phase: an
    # estimate of the run's time inside the two kernels
    path = ("rhs_self_fwd", "rhs_self_bwd")
    launches = {k: launches[k] for k in path}
    kernel_seconds = sum(launches[k] * timing[k]["ms"] for k in path) / 1e3
    emit({"phase": "main_path", "n_points": n_points, "ls_steps": ls_steps,
          "seconds": seconds, "FE": psr.FE,
          "fe_increase_events": psr.fe_increase_events, "launches": launches,
          "loss_grad_evals": evals, "row_orders": orders,
          "kernel_seconds_est": kernel_seconds,
          "kernel_share_est": kernel_seconds / seconds})
    if not all(v > 0 for v in launches.values()):
        fail("main_path", f"a kernel of the path never launched: {launches}")
    if not 0 < orders <= evals:
        fail("main_path", f"{orders} row orders for {evals} loss+grad evaluations")
    if not (math.isfinite(psr.FE) and psr.fe_increase_events == 0):
        fail("main_path", "free energy not finite or not monotone")
    if x1.shape != (n_points, 2) or not bool((abs(x1) < 1e6).all()):
        fail("main_path", "warped points have the wrong shape or are not finite")
    if not iters[-1]["FE"] < iters[0]["FE"]:
        fail("main_path", "free energy did not decrease over the run")
    hold_fes("main_path", [rec["FE"] for rec in iters], {"direct": DENSE_FE_DIRECT},
             DENSE_FE_BEFORE)

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
    if not (monotone(fes) and psr.fe_increase_events == 0 and math.isfinite(psr.FE)):
        fail("api", "free energy not monotone")
    if not all(rs.launches[k] > 0 for k in ("rhs_self_fwd", "rhs_self_bwd")):
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
    the run's grid M, d = 2; dq/dp with the support's order and dx with the
    data rows' order computed once beforehand, as the path does); kmin2 at
    the coverage pass's (nt + 1) K frames.  Each kernel of the grid path, the
    self kernels on the support included, is first held against its plain
    version in float64 on the same inputs.  Then CUDA events, median of 15,
    beside the bound: the function's least work, for dx and dq/dp the lower
    of that and their table route's own (table_bound)."""
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
    # the support's and the data rows' orders, once per optimisation on the path
    order = rs.row_order(q, mq, GRID_SIGMA)
    xorder = re.data_order(x, mx, GRID_SIGMA)
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
        hold("rhs_ext_bwd_dx", [re.rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc, sig, wl, xorder)],
             [re.rhs_ext_bwd_dx_reference(x8, mx8, gx8, q8, p8, mq8, gc8, sig, wl)],
             TOL_BWD, withlogdet=wl, **shape)
        hold("rhs_ext_bwd_dqdp", re.rhs_ext_bwd_dqdp(x, mx, gx, q, p, mq, gc, sig, wl, order),
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
        ("rhs_ext_bwd_dx",
         lambda: re.rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc, sig, True, xorder),
         lambda: re.rhs_ext_bwd_dx_reference(x, mx, gx, q, p, mq, gc, sig, True),
         None, pairs, re.dx_ops_per_pair(d), pairs,
         side_x * (2 * d + 1) + side_q * (2 * d + 1) + 4.0 * k + side_x * d),
        ("rhs_ext_bwd_dqdp",
         lambda: re.rhs_ext_bwd_dqdp(x, mx, gx, q, p, mq, gc, sig, True, order),
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
        if name in EXT_BWD_TABLES:
            bd = table_bound(bd, npairs, d, re.tensor_flops_per_pair(d, EXT_BWD_TABLES[name]))
            bd["share_of_route_bound"] = bd["bound_route_ms"] / ms
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bd,
                         share_of_bound=bd["bound_ms"] / ms, pairs=npairs,
                         fp32_ops_per_pair=ops, bytes=nbytes,
                         frames=xs[0].shape[0] if name == "kmin2" else k, N=n, M=m,
                         gpair_per_s=npairs / (ms * 1e-3) / 1e9)
        emit({"phase": "timing", "kernel": name, "d": d, **out[name]})
    torch.cuda.empty_cache()
    emit({"phase": "timing_ext_done", "seconds": time.perf_counter() - t0})
    return out, worst


def phase_grid_main_path(counters, orders):
    """bench.py's atlas workload at 10 x 65,536 points with grid support:
    DiffPSR.run(2) and one stepwise Reg_opt with its coverage pass.  Where
    its time goes is read from the trace of the profile phase.  ``orders``:
    the count of rows' orders computed (rhs_self.orders)."""
    import torch

    k, n = 10, 65536
    reset(*counters.values(), orders)
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
    flat = {key: v for c in launches.values() for key, v in c.items()
            if key in ETA0_KERNELS}
    x1 = psr.x1
    fe_seq = [fe0, *map(float, fes), psr.FE]
    evals = flat["rhs_self_bwd"] / psr.lcfg.nt
    n_orders = orders["row_order"]
    rec = {"phase": "grid_main_path", "frames": k, "n_points": n,
           "grid_M": int(psr.q0.shape[1]), "sigma_lddmm": GRID_SIGMA,
           "setup_seconds": setup, "run_seconds": run_s,
           "seconds_per_outer_iteration": run_s / 2, "reg_opt_seconds": reg_s,
           "seconds": seconds, "FE_sequence": fe_seq,
           "fe_increase_events": psr.fe_increase_events,
           "uncovered": psr.last_reg_stats["uncovered"].cpu().tolist(),
           "last_reg_evals": psr.last_reg_evals.cpu().tolist(),
           "launches": flat, "loss_grad_evals": evals, "row_orders": n_orders}
    emit(rec)
    if not all(v > 0 for v in flat.values()):
        fail("grid_main_path", f"a kernel of the path never launched: {flat}")
    if not 0 < n_orders <= evals:
        fail("grid_main_path", f"{n_orders} row orders for {evals} loss+grad evaluations")
    if not (all(map(math.isfinite, fe_seq)) and monotone(fe_seq)
            and psr.fe_increase_events == 0):
        fail("grid_main_path", "free energy not finite or not monotone")
    if not fe_seq[-1] < fe_seq[0]:
        fail("grid_main_path", "free energy did not decrease over the run")
    if tuple(x1.shape) != (k, n, 2) or not bool(torch.isfinite(x1).all()):
        fail("grid_main_path", "warped points have the wrong shape or are not finite")
    hold_fes("grid_main_path", fe_seq, {"direct": GRID_FE_DIRECT,
                                        "direct_ext_bwd": GRID_FE_DIRECT_EXT_BWD[:3]},
             GRID_FE_BEFORE)
    hold_end_state("grid_main_end_state", psr, float64_table_kernels)
    return psr, flat


@contextlib.contextmanager
def float64_table_kernels():
    """The eta = 0 table kernels (rhs_self.rhs_self_fwd and rhs_self_bwd,
    rhs_ext.rhs_ext_bwd_dx and rhs_ext_bwd_dqdp) taken by their plain
    versions in float64, rounded to float32 at their outputs, inside the
    block; these calls launch no kernel."""
    from difficp_torch.ops import rhs_ext as re
    from difficp_torch.ops import rhs_self as rs

    kernels = (rs.rhs_self_fwd, rs.rhs_self_bwd, re.rhs_ext_bwd_dx, re.rhs_ext_bwd_dqdp)

    def plain_fwd(q, p, m, sigma, withlogdet, eta=0.0, order=None):
        return tuple(t.float() for t in rs.rhs_self_fwd_reference(
            q.double(), p.double(), m.double(), sigma, withlogdet, eta))

    def plain_bwd(q, p, m, a, b, c, sigma, withlogdet, order=None):
        return tuple(t.float() for t in rs.rhs_self_bwd_reference(
            *(t.double() for t in (q, p, m, a, b, c)), sigma, withlogdet))

    def plain_dx(*args, xorder=None):
        args = args[:9]  # without the data rows' order
        return re.rhs_ext_bwd_dx_reference(*(t.double() for t in args[:7]), *args[7:]).float()

    def plain_dqdp(*args, order=None):
        args = args[:9]  # without the support's order
        return tuple(t.float() for t in re.rhs_ext_bwd_dqdp_reference(
            *(t.double() for t in args[:7]), *args[7:]))

    rs.rhs_self_fwd, rs.rhs_self_bwd = plain_fwd, plain_bwd
    re.rhs_ext_bwd_dx, re.rhs_ext_bwd_dqdp = plain_dx, plain_dqdp
    try:
        yield
    finally:
        rs.rhs_self_fwd, rs.rhs_self_bwd, re.rhs_ext_bwd_dx, re.rhs_ext_bwd_dqdp = kernels


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
        flat = {key: v for c in counters.values() for key, v in c.items()
                if key in ETA0_KERNELS}
        emit({"phase": "api_grid", "entry": name, "n_points": n,
              "frames": psr.K, "support": psr.support_scheme,
              "grid_M": int(psr.q0.shape[1]),
              "seconds": time.perf_counter() - t0, "FE_sequence": fes,
              "fe_increase_events": psr.fe_increase_events, "launches": flat})
        if not (monotone(fes) and psr.fe_increase_events == 0 and math.isfinite(psr.FE)):
            fail("api_grid", f"{name}: free energy not monotone")
        if psr.support_scheme != "grid" or not all(
                flat[key] > 0 for key in ("rhs_ext_fwd", "rhs_ext_bwd_dx",
                                          "rhs_ext_bwd_dqdp", "kmin2")):
            fail("api_grid", f"{name} did not take the grid kernel route: {flat}")


def phase_profile(psr, counters, phase="profile", evals_of=None, run_kw=GRID_RUN,
                  host_ops=False):
    """A torch.profiler trace (CPU and CUDA activities) of one outer
    iteration of a grid main path.  One untraced iteration runs first: its
    wall time shows what the tracing costs the host.  ``evals_of(counters)``
    gives the loss+grad evaluations of the traced iteration (by default nt
    dq/dp launches each); ``run_kw`` are the outer iteration's arguments;
    ``host_ops`` adds the host operators by their own CPU time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psr.run(1, **run_kw)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3
    reset(*counters.values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        psr.run(1, **run_kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                      if e.device_type == DeviceType.CUDA), key=lambda t: t[0])
    if not kernels:
        fail(phase, "the trace holds no device activity")
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
    evals = (counters["rhs_ext"]["rhs_ext_bwd_dqdp"] / psr.lcfg.nt if evals_of is None
             else evals_of(counters))
    rec = {"phase": phase, "window_ms": window_us / 1e3, "wall_ms": wall_ms,
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
    if host_ops:
        # where the host's time goes: operators by their own CPU time
        by_op = {}
        for e in host:
            tot, cnt = by_op.get(e.name, (0.0, 0))
            by_op[e.name] = (tot + e.self_cpu_time_total, cnt + 1)
        rec["top_host_ops"] = [{"name": name[:90], "self_ms": tot / 1e3, "count": cnt}
                               for name, (tot, cnt) in sorted(by_op.items(),
                                                              key=lambda kv: -kv[1][0])[:12]]
    emit(rec)
    if not 0.0 < rec["device_busy_share"] <= 1.0:
        fail(phase, "device-busy share out of range")


# ---------------------------------------------------------------------------
# the gradcomponent (eta != 0) slice
# ---------------------------------------------------------------------------

def ksum_inputs(k, nx, ny, d, ncols, seed, shared=False, self_case=False):
    """Rows on spiral frames, columns on their grid support or (self_case)
    the rows themselves; a ragged column mask; a random payload table."""
    import numpy as np
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.as_tensor(np.stack(grid_frames(k, nx, dim=d)))
    if self_case:
        y = x
    else:
        y = torch.as_tensor(np.stack(grid_frames(1 if shared else k, ny, dim=d)))
        if shared:
            y = y[0]
    my = (torch.rand(y.shape[:-1], generator=g) > 0.1).float()
    t = torch.randn((*y.shape[:-2], ncols, y.shape[-2]), generator=g)
    return [a.cuda() for a in (x, y, my, t)]


def phase_check_eta(rs, re, ks):
    """ksum and the ETA forward instances against their plain versions in
    float64 on the same float32 inputs; the ETA instances at eta = 0 against
    the eta = 0 kernels: the self forward's (the table kernel, which sums in
    another order) within TOL_FWD, the ext forward's bit for bit."""
    import torch

    t0 = time.perf_counter()
    worst = {name: [0.0, 0.0] for name in ("ksum", "rhs_self_fwd_eta", "rhs_ext_fwd_eta")}

    def note(name, rel, ab):
        worst[name][0] = max(worst[name][0], rel)
        worst[name][1] = max(worst[name][1], ab)

    def check_ksum(d, ncols, nx, ny, kw):
        x, y, my, t = ksum_inputs(3, nx, ny, d, ncols, seed=ncols + nx, **kw)
        got = ks.ksum(x, y, t, my, GRID_SIGMA)
        torch.cuda.synchronize()
        ref = ks.ksum_reference(x.double(), y.double(), t.double(), my.double(), GRID_SIGMA)
        rel, ab = rel_err(got, ref), abs_err(got, ref)
        ok = rel <= TOL_FWD
        emit({"phase": "check_ksum", "frames": 3, "Nx": nx, "Ny": ny, "d": d,
              "cols": ncols, "y_cols_per_split": ks.splitting(3, nx, ny, ncols), **kw,
              "rel_err": rel, "tol": TOL_FWD, "ok": ok})
        if not ok:
            fail("check_ksum", f"ksum disagrees with its plain version at d={d} "
                               f"cols={ncols} Nx={nx} Ny={ny} {kw}")
        note("ksum", rel, ab)

    cases = [(2, c, {}) for c in (3, 6, 9, 20, 121)] + [(3, 333, {}), (2, 20, {"shared": True}),
                                                         (2, 121, {"self_case": True})]
    for d, ncols, kw in cases:
        # 3 frames of 4,001 rows against 6,007 columns, and a split y axis:
        # 3 frames of 380 rows against 40,000 columns
        for nx, ny in ((4001, 6007), (380, 40000)):
            check_ksum(d, ncols, nx, nx if kw.get("self_case") else ny, kw)
    # the tensor-core kernel's tile edges: tables of 1, 8, 128 and 129 columns
    # (n-tiles of 8, chunks of at most 128) against x sides of 15, 16 and 17
    # rows (16 a warp), 6,007 columns (not a multiple of the 64-column tile)
    for ncols in (1, 8, 128, 129):
        for nx in (15, 16, 17):
            check_ksum(2, ncols, nx, 6007, {})
    identical = True
    for n, masked in ((16381, True), (65536, False)):
        for d in (2, 3):
            for wl in (True, False):
                q, p, mask, *_ = make_inputs(n, d, masked, seed=n + d)
                v, w, dc = rs.rhs_self_fwd(q, p, mask, SIGMA, wl, DENSE_ETA)
                x, mx, qs, ps, mq, *_ = ext_inputs(3, n, d, masked, "grid", seed=n + d)
                vx, dcx = re.rhs_ext_fwd(x, mx, qs, ps, mq, GRID_SIGMA, wl, GRID_ETA)
                torch.cuda.synchronize()
                rv, rw, rdc = rs.rhs_self_fwd_reference(q.double(), p.double(),
                                                        mask.double(), SIGMA, wl, DENSE_ETA)
                rvx, rdcx = re.rhs_ext_fwd_reference(
                    *(a.double() for a in (x, mx, qs, ps, mq)), GRID_SIGMA, wl, GRID_ETA)
                torch.cuda.synchronize()
                self_rel = max(rel_err(v, rv), rel_err(w, rw))
                ext_rel = rel_err(vx, rvx)
                dc_rel = max(float((a.double().sum(-1) - r.sum(-1)).abs().max()
                                   / r.abs().sum(-1).max().clamp_min(1e-300))
                             for a, r in ((dc, rdc), (dcx, rdcx)))
                # the ETA instances at eta = 0 against the eta = 0 kernels
                self0 = rs.launch_fwd(q, p, mask, SIGMA, wl, 0.0, False)
                self0_eta = rs.launch_fwd(q, p, mask, SIGMA, wl, 0.0, True)
                self_at_0 = max(rel_err(a, b.double()) for a, b in zip(self0_eta[:2], self0[:2]))
                same = all(torch.equal(a, b) for a, b in zip(
                    re.launch_fwd(x, mx, qs, ps, mq, GRID_SIGMA, wl, 0.0, False),
                    re.launch_fwd(x, mx, qs, ps, mq, GRID_SIGMA, wl, 0.0, True)))
                identical = identical and same
                ok = max(self_rel, ext_rel, dc_rel, self_at_0) <= TOL_FWD and same
                emit({"phase": "check_eta_fwd", "N": n, "d": d, "withlogdet": wl,
                      "masked": masked, "self_rel_err": self_rel, "ext_rel_err": ext_rel,
                      "dcost_rel_err": dc_rel, "tol": TOL_FWD,
                      "self_eta_instance_at_0_rel_diff": self_at_0,
                      "ext_eta_instance_at_0_bit_identical": same, "ok": ok})
                if not ok:
                    fail("check_eta_fwd", f"an ETA forward kernel disagrees with its plain "
                                          f"version at N={n} d={d} withlogdet={wl}")
                note("rhs_self_fwd_eta", max(self_rel, dc_rel),
                     max(abs_err(v, rv), abs_err(w, rw)))
                note("rhs_ext_fwd_eta", max(ext_rel, dc_rel), abs_err(vx, rvx))
    emit({"phase": "check_eta_done", "seconds": time.perf_counter() - t0,
          "ext_eta_instance_at_0_bit_identical": identical})
    return worst


def ksum_bound(pairs, d, ncols, nbytes, self_pairs=False):
    """The bound of a kernel-sum on its tensor-core route: the largest of its
    exponentials over the MUFU rate, its 3 x 2 ncols TF32 FLOP a row and pair
    (the three products float32 accuracy takes) over the TF32 peak, the
    FP32-pipe remainder (distance, scale, split: ops/ksum.py) over the FP32
    peak, and its bytes over the memory rate.  A self sum (x = y) takes each
    unordered pair once: its distance, split and exponential shared by both
    rows, its products one a row.  bound_fp32_ms: the bound of the FP32-pipe
    route (every multiply-add there, ops_per_pair), the one PRs 3 and 4
    printed."""
    from difficp_torch.ops import ksum as ks

    rows = 2 if self_pairs else 1
    fp32_route = bound(pairs, ks.ops_per_pair(d, rows * ncols), pairs, nbytes)
    terms = {"tensor": pairs * rows * ks.tensor_flops_per_pair(ncols) / PEAK_TF32_FLOPS,
             "mufu": pairs / PEAK_EX2_PER_S,
             "fp32_pipe": pairs * ks.fp32_ops_per_pair(d) / PEAK_FP32_FLOPS,
             "bytes": nbytes / PEAK_BYTES_PER_S}
    by = max(terms, key=terms.get)
    return dict(bound_ms=terms[by] * 1e3, bound_by="bytes" if by == "bytes" else "operations",
                bound_term=by, **{f"bound_{k}_ms": v * 1e3 for k, v in terms.items()},
                bound_fp32_ms=fp32_route["bound_ms"])


def grid_eta_inputs():
    """The grid eta path's geometry: 10 frames of 65,536 spiral points x,
    their grid support qg at sigma = 0.05, a jittered per-frame support q,
    its momenta p, and the generator that drew them."""
    import numpy as np
    import torch
    from difficp_torch.utils.point_sets import grid_support

    k, n, d = 10, 65536, 2
    x = torch.as_tensor(np.stack(grid_frames(k, n))).cuda()
    qg = torch.as_tensor(grid_support(x.reshape(-1, d).cpu().numpy(), GRID_SIGMA))
    g = torch.Generator(device="cuda").manual_seed(11)
    q = qg.cuda() + 0.1 * GRID_SIGMA * torch.randn((k, qg.shape[0], d), generator=g,
                                                    device="cuda")
    p = 0.05 * torch.randn(q.shape, generator=g, device="cuda")
    return x, qg, q, p, g


def ring_ksum_widths(pp, eta):
    """(label, columns) of the ring's kernel-sums at this eta, as pair_poly
    builds their tables: the generated cross backward's row and column
    directions, the cross Hamiltonian's value and its two gradient
    directions (read off one small CPU evaluation of each)."""
    import torch
    from difficp_torch.ops import ksum as ks

    widths, real = [], ks.ksum

    def spy(x, y, table, my, sigma):
        widths.append(table.shape[-2])
        return real(x, y, table, my, sigma)

    g = torch.Generator().manual_seed(0)
    q, p, gv, gg = (torch.randn((1, 40, 2), generator=g) for _ in range(4))
    m, gc = torch.ones((1, 40)), torch.ones((1,))
    ks.ksum = spy
    try:
        pp.rhs_cross_bwd_poly(q, p, m, q, p, m, gv, gg, gc, SIGMA, eta)
        pp.hamiltonian_cross_poly(q, p, m, q, p, m, SIGMA, eta)
        pp.hamiltonian_cross_poly(q, p, m, q, p, m, SIGMA, eta, grad_sides=("row", "col"))
    finally:
        ks.ksum = real
    labels = ("backward, row direction", "backward, column direction", "Hamiltonian value",
              "Hamiltonian, row gradient", "Hamiltonian, column gradient")
    return list(zip(labels, widths))


def ksum_calls(pp, group):
    """(name, x, y, table, sigma, self) of every kernel-sum shape a main path
    gives ksum, with the path's geometry and a random table of the path's
    width.  group "eta": the grid eta path (10 frames of 65,536 points on
    their grid support, d = 2, sigma = 0.05), the dense eta path (one frame
    of DENSE_ETA_N spiral points, sigma = 0.1) and the generated self
    forward's 20-column symmetric table at _SYM_MIN_M = 32,768 points, where
    that route starts (no path here reaches it, PERF.md).  group "ring": the
    ring paths at world size 1 (the whole set as rows and as columns, a
    cross sum over ordered pairs), RING_N points at eta = 0 and RING_ETA_N at
    DENSE_ETA."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(13)

    def table(ncols, cols):
        return torch.randn((cols.shape[0], ncols, cols.shape[1]), generator=g,
                           device="cuda")

    if group == "eta":
        x, _, q, _, _ = grid_eta_inputs()
        qd = make_inputs(DENSE_ETA_N, 2, False, seed=5)[0]
        qs = make_inputs(pp._SYM_MIN_M, 2, False, seed=6)[0]
        return [
            ("grid ext forward", x, q, table(9, q), GRID_SIGMA, False),
            ("grid self backward", q, q, table(121, q), GRID_SIGMA, True),
            ("grid ext dx", x, q, table(20, q), GRID_SIGMA, False),
            ("grid ext dq/dp", q, x, table(20, x), GRID_SIGMA, False),
            ("dense self backward", qd, qd, table(121, qd), SIGMA, True),
            ("dense Hamiltonian", qd, qd, table(6, qd), SIGMA, True),
            ("dense symmetric self forward", qs, qs, table(20, qs), SIGMA, True),
        ]
    calls = []
    for n, eta, path in ((RING_N, 0.0, "ring"), (RING_ETA_N, DENSE_ETA, "ring eta")):
        xr = make_inputs(n, 2, False, seed=n)[0]
        for label, ncols in ring_ksum_widths(pp, eta):
            calls.append((f"{path} {label}", xr, xr, table(ncols, xr), SIGMA, False))
    return calls


def time_ksum_calls(ks, calls, worst):
    """Each call first held against its plain version in float64 on the same
    inputs (TOL_FWD), then timed with CUDA events (median of 15) beside its
    plain version (median of 3) and its bound.  Bytes: each input read once,
    each output written once."""
    import torch

    shapes = []
    for name, xs, ys, tab, sig, self_case in calls:
        got = ks.ksum(xs, ys, tab, None, sig)
        torch.cuda.synchronize()
        ref = ks.ksum_reference(xs.double(), ys.double(), tab.double(), None, sig)
        rel, ab = rel_err(got, ref), abs_err(got, ref)
        del got, ref
        torch.cuda.empty_cache()
        ok = rel <= TOL_FWD
        nb, nx, ny, ncols, d = xs.shape[0], xs.shape[1], ys.shape[1], tab.shape[1], xs.shape[2]
        emit({"phase": "check_main_shape", "kernel": "ksum", "call": name, "frames": nb,
              "Nx": nx, "Ny": ny, "cols": ncols, "rel_err": rel, "abs_err": ab,
              "tol": TOL_FWD, "ok": ok})
        if not ok:
            fail("check_main_shape", f"ksum disagrees with its plain version at {name}")
        worst["ksum"] = [max(worst["ksum"][0], rel), max(worst["ksum"][1], ab)]
        fn = lambda: ks.ksum(xs, ys, tab, None, sig)  # noqa: E731
        plain = lambda: ks.ksum_reference(xs, ys, tab, None, sig)  # noqa: E731
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ms = cuda_ms(fn, 15)
        plain()
        torch.cuda.synchronize()
        plain_ms = cuda_ms(plain, 3)
        nbytes = 4.0 * nb * (nx * d + ny * d + ncols * ny + ncols * nx)
        pairs = nb * (nx * (nx - 1) / 2 if self_case else nx * ny)
        bd = ksum_bound(pairs, d, ncols, nbytes, self_pairs=self_case)
        rec = dict(call=name, frames=nb, Nx=nx, Ny=ny, cols=ncols, ms=ms,
                   plain_ms=plain_ms, library_ms=None, **bd,
                   share_of_bound=bd["bound_ms"] / ms,
                   y_cols_per_split=ks.splitting(nb, nx, ny, ncols),
                   gpair_per_s=nb * nx * ny / (ms * 1e-3) / 1e9)
        shapes.append(rec)
        emit({"phase": "timing", "kernel": "ksum", **rec})
    torch.cuda.empty_cache()
    return shapes


def phase_timing_eta(rs, re, ks, pp):
    """Each eta kernel at the shapes the two eta paths give it: first held
    against its plain version in float64 on the same inputs, then timed with
    CUDA events (median of 15) beside its plain version and its bound.
    Grid eta path: 10 frames of 65,536 points on their grid support (M), d =
    2, sigma = 0.05, eta = 1/500.  Dense eta path: one frame of DENSE_ETA_N
    spiral points, sigma = 0.1, eta = 1/200.  ksum's shapes: ksum_calls."""
    import torch

    t0 = time.perf_counter()
    k, n, d, nd = 10, 65536, 2, DENSE_ETA_N
    x, qg, q, p, g = grid_eta_inputs()
    m = qg.shape[0]
    mq = torch.ones((k, m), device="cuda")
    ones_x = torch.ones((k, n), device="cuda")
    qd, pd_, md, *_ = make_inputs(nd, d, False, seed=5)
    worst = {"ksum": [0.0, 0.0], "rhs_self_fwd_eta": [0.0, 0.0],
             "rhs_ext_fwd_eta": [0.0, 0.0]}
    shapes = time_ksum_calls(ks, ksum_calls(pp, "eta"), worst)

    out = {}
    # the ETA self forward: the grid path's support (logdet off, the ext RHS's
    # self part), the dense path's self forward (logdet on) and its
    # Hamiltonian gradient (logdet off)
    for label, (qq, pp, mm, sig, eta, wl) in (
            ("grid support", (q, p, mq, GRID_SIGMA, GRID_ETA, False)),
            ("dense self forward", (qd, pd_, md, SIGMA, DENSE_ETA, True)),
            ("dense Hamiltonian gradient", (qd, pd_, md, SIGMA, DENSE_ETA, False))):
        got = rs.rhs_self_fwd(qq, pp, mm, sig, wl, eta)
        ref = rs.rhs_self_fwd_reference(qq.double(), pp.double(), mm.double(), sig, wl, eta)
        torch.cuda.synchronize()
        rel = max(rel_err(a, r) for a, r in zip(got[:2], ref[:2]))
        ab = max(abs_err(a, r) for a, r in zip(got[:2], ref[:2]))
        emit({"phase": "check_main_shape", "kernel": "rhs_self_fwd_eta", "call": label,
              "frames": qq.shape[0], "M": qq.shape[1], "rel_err": rel, "abs_err": ab,
              "tol": TOL_FWD, "ok": rel <= TOL_FWD})
        if rel > TOL_FWD:
            fail("check_main_shape", f"rhs_self_fwd_eta disagrees at the {label} shape")
        worst["rhs_self_fwd_eta"] = [max(worst["rhs_self_fwd_eta"][0], rel),
                                     max(worst["rhs_self_fwd_eta"][1], ab)]
        fn = lambda: rs.rhs_self_fwd(qq, pp, mm, sig, wl, eta)  # noqa: E731
        plain = lambda: rs.rhs_self_fwd_reference(qq, pp, mm, sig, wl, eta)  # noqa: E731
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ms = cuda_ms(fn, 15)
        plain()
        torch.cuda.synchronize()
        plain_ms = cuda_ms(plain, 3)
        nb, mpts = qq.shape[0], qq.shape[1]
        upairs = float((mm.sum(-1) * (mm.sum(-1) - 1) / 2).sum())
        nbytes = 4.0 * nb * mpts * ((2 * d + 1) + (2 * d + 1))
        bd = bound(upairs, rs.fwd_eta_ops_per_unordered_pair(d, wl), upairs, nbytes)
        rec = dict(call=label, frames=nb, M=mpts, ms=ms, plain_ms=plain_ms, library_ms=None,
                   **bd, share_of_bound=bd["bound_ms"] / ms)
        out.setdefault("rhs_self_fwd_eta", []).append(rec)
        emit({"phase": "timing", "kernel": "rhs_self_fwd_eta", **rec})
    # the ETA ext forward: v_field of the grid eta path's set-up (the grid
    # support's 10 x M points against the 65,536 data points of each frame,
    # logdet off, an all-ones data mask)
    qsup = qg.cuda().expand(k, m, d).contiguous()
    ones_q = torch.ones((k, m), device="cuda")
    # the momenta of the dense support at the data points
    pv = 0.01 * torch.randn(x.shape, generator=g, device="cuda")
    got = re.rhs_ext_fwd(qsup, ones_q, x, pv, ones_x, GRID_SIGMA, False, GRID_ETA)
    ref = re.rhs_ext_fwd_reference(qsup.double(), ones_q.double(), x.double(), pv.double(),
                                   ones_x.double(), GRID_SIGMA, False, GRID_ETA)
    torch.cuda.synchronize()
    rel, ab = rel_err(got[0], ref[0]), abs_err(got[0], ref[0])
    emit({"phase": "check_main_shape", "kernel": "rhs_ext_fwd_eta", "call": "v_field",
          "frames": k, "N": m, "M": n, "rel_err": rel, "abs_err": ab, "tol": TOL_FWD,
          "ok": rel <= TOL_FWD})
    if rel > TOL_FWD:
        fail("check_main_shape", "rhs_ext_fwd_eta disagrees at the v_field shape")
    worst["rhs_ext_fwd_eta"] = [max(worst["rhs_ext_fwd_eta"][0], rel),
                                max(worst["rhs_ext_fwd_eta"][1], ab)]
    del got, ref
    fn = lambda: re.rhs_ext_fwd(qsup, ones_q, x, pv, ones_x, GRID_SIGMA, False, GRID_ETA)  # noqa: E731
    plain = lambda: re.rhs_ext_fwd_reference(qsup, ones_q, x, pv, ones_x, GRID_SIGMA,  # noqa: E731
                                             False, GRID_ETA)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ms = cuda_ms(fn, 15)
    plain()
    torch.cuda.synchronize()
    plain_ms = cuda_ms(plain, 3)
    pairs = float(k * m * n)
    nbytes = 4.0 * k * (m * (d + 1) + n * (2 * d + 1) + m * d)
    bd = bound(pairs, re.fwd_eta_ops_per_pair(d, False), pairs, nbytes)
    out["rhs_ext_fwd_eta"] = [dict(call="v_field", frames=k, N=m, M=n, ms=ms,
                                   plain_ms=plain_ms, library_ms=None, **bd,
                                   share_of_bound=bd["bound_ms"] / ms)]
    emit({"phase": "timing", "kernel": "rhs_ext_fwd_eta", **out["rhs_ext_fwd_eta"][0]})
    out["ksum"] = shapes
    torch.cuda.empty_cache()
    emit({"phase": "timing_eta_done", "seconds": time.perf_counter() - t0})
    return out, worst


ETA_KERNELS = ("rhs_self_fwd_eta", "rhs_ext_fwd_eta", "ksum")


def flat_counts(counters):
    return {key: v for c in counters.values() for key, v in c.items()}


def rel_diff_fes(fes, ref):
    """The largest relative difference, entry by entry, of two FE sequences
    (inf when their lengths differ or ref is missing)."""
    if ref is None or len(fes) != len(ref):
        return math.inf
    return max(abs(a - b) / abs(b) for a, b in zip(fes, ref))


def hold_fes(phase, fes, refs, before):
    """A path's free energies within TOL_ROUTE_FE (relative, entry by entry)
    of each reference sequence over that sequence's length (refs: name ->
    leading entries held), and bit for bit the sequence this script recorded
    first with the current kernels (before)."""
    rel = {name: rel_diff_fes(fes[:len(ref)], ref) for name, ref in refs.items()}
    same = fes == before
    emit({"phase": phase + "_fe", "FE_sequence": fes, "references": refs,
          "rel_diff": rel, "tol": TOL_ROUTE_FE, "FE_equals_earlier_runs": same})
    for name, ref in refs.items():
        if rel[name] > TOL_ROUTE_FE:
            fail(phase, f"FE sequence {fes} is not within {TOL_ROUTE_FE} of {name} {ref}")
    if not same:
        fail(phase, f"FE sequence {fes} is not the recorded earlier {before}")


def loss_grad(psr):
    """The registration objective Reg_opt descends, at psr's momenta a0 and
    its current targets: the loss per frame and its gradient (K, M, D)."""
    import torch

    from difficp_torch.models import lddmm
    from difficp_torch.models.psr import _frame_quad_dataloss

    ext = psr.support_scheme is not None
    dataloss = _frame_quad_dataloss(psr.y, psr._sig2_vector(), psr.xmask, psr.ptw)
    lossfn = lddmm._make_lossfn_aux(psr.lcfg, dataloss, psr.q0, psr.x0 if ext else None,
                                    psr.qmask, psr.xmask if ext else None)
    p = psr.a0.detach().clone().requires_grad_(True)
    loss, _ = lossfn(p)
    (grad,) = torch.autograd.grad(loss.sum(), p)
    return loss.detach(), grad


def hold_end_state(phase, psr, float64_route):
    """The kernels along a grid path's trajectory: the objective and its
    gradient at the path's end (its last momenta and targets) through the
    kernels and inside ``float64_route()`` (a context that takes some of them
    by their float64 plain versions), held within TOL_ROUTE_FE (the loss per
    frame relative to itself, the gradient relative to its largest entry)."""
    import torch

    loss, grad = loss_grad(psr)
    with float64_route():
        loss64, grad64 = loss_grad(psr)
    torch.cuda.synchronize()
    rel_loss = float(((loss.double() - loss64.double()).abs() / loss64.double().abs()).max())
    rel_grad = rel_err(grad, grad64)
    emit({"phase": phase, "loss": loss.tolist(), "loss_float64": loss64.tolist(),
          "loss_rel_diff": rel_loss, "grad_rel_diff": rel_grad, "tol": TOL_ROUTE_FE})
    if not (rel_loss <= TOL_ROUTE_FE and rel_grad <= TOL_ROUTE_FE):
        fail(phase, f"the objective or its gradient is not within {TOL_ROUTE_FE} of the "
                    "float64 route's")


@contextlib.contextmanager
def float64_ksum(ks):
    """ks.ksum taken by its plain version in float64 (rounded to float32 at
    its output) inside the block; these calls launch no kernel."""
    kernel = ks.ksum

    def plain(x, y, table, my, sigma):
        return ks.ksum_reference(x.double(), y.double(), table.double(),
                                 None if my is None else my.double(), sigma).float()

    ks.ksum = plain
    try:
        yield
    finally:
        ks.ksum = kernel


def grid_eta_psr(ks):
    """The grid eta path's DiffPSR: grid_psr(10, 65,536) with version
    "logdet", its start momenta (v2p on the dense support, then the
    projection onto the grid) computed with the kernel-sum's float64 plain
    version, the same whichever kernel-sum runs the path after it."""
    with float64_ksum(ks):
        return grid_psr(10, 65536, version="logdet")


def grid_eta_run(psr):
    """The grid eta path after its set-up: run(2) and one stepwise Reg_opt.
    The FE sequence (the two iterations', then the Reg_opt's), and the
    seconds of each."""
    import torch

    t1 = time.perf_counter()
    fes = psr.run(2, **GRID_RUN)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    psr.Reg_opt(tol=1e-3, nmax=1, inner=10, ls_steps=12)
    torch.cuda.synchronize()
    return [*map(float, fes), psr.FE], run_s, time.perf_counter() - t2


def phase_grid_eta_path(counters, ks):
    """The grid main path with the gradcomponent model (version "logdet",
    eta = 1/500): DiffPSR set-up (grid_eta_psr), run(2) and one stepwise
    Reg_opt."""
    import torch

    k, n, nt = 10, 65536, 10
    reset(*counters.values())
    t0 = time.perf_counter()
    psr = grid_eta_psr(ks)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    setup_counts = flat_counts(counters)
    # run() records the start momenta's free energy first (its oracle compares
    # the first iteration with it), then the iterations'
    fe_seq, run_s, reg_s = grid_eta_run(psr)
    flat = flat_counts(counters)
    # loss+grad evaluations: one any-eta self forward per step of each shoot;
    # the start's shoot and the coverage pass add one shoot each without a
    # gradient, with the generated ext forward (nt ksum) in each; the set-up's
    # kernel-sums are the float64 plain version's
    evals = (flat["rhs_self_fwd_eta"] - 2 * nt) / nt
    per_eval = {"rhs_self_fwd_eta": nt, "ksum": 4 * nt}
    expected_ksum = 4 * nt * evals + 2 * nt + setup_counts["ksum"]
    rec = {"phase": "grid_eta_path", "frames": k, "n_points": n,
           "grid_M": int(psr.q0.shape[1]), "sigma_lddmm": GRID_SIGMA, "eta": psr.lcfg.eta,
           "setup_seconds": setup, "run_seconds": run_s,
           "seconds_per_outer_iteration": run_s / 2, "reg_opt_seconds": reg_s,
           "seconds": time.perf_counter() - t0, "FE_sequence": fe_seq,
           "fe_increase_events": psr.fe_increase_events,
           "uncovered": psr.last_reg_stats["uncovered"].cpu().tolist(),
           "setup_launches": setup_counts, "launches": flat, "loss_grad_evals": evals,
           "expected_per_loss_grad": per_eval,
           "ksum_launches_as_expected": flat["ksum"] == expected_ksum}
    emit(rec)
    if not all(flat[key] > 0 for key in ETA_KERNELS):
        fail("grid_eta_path", f"a kernel of the path never launched: {flat}")
    if not (all(map(math.isfinite, fe_seq)) and monotone(fe_seq)
            and psr.fe_increase_events == 0):
        fail("grid_eta_path", "free energy not finite or not monotone")
    if not fe_seq[-1] < fe_seq[0]:
        fail("grid_eta_path", "free energy did not decrease over the run")
    if tuple(psr.x1.shape) != (k, n, 2) or not bool(torch.isfinite(psr.x1).all()):
        fail("grid_eta_path", "warped points have the wrong shape or are not finite")
    hold_fes("grid_eta_path", fe_seq, {"fp32_ksum": GRID_ETA_FE_FP32_KSUM,
                                           "float64_ksum": GRID_ETA_FE_FLOAT64_KSUM},
                 GRID_ETA_FE_BEFORE)
    hold_end_state("grid_eta_end_state", psr, lambda: float64_ksum(ks))
    return psr, flat


def shoot_float64(rs, q, a, m, cfg, nt):
    """An Euler shoot of nt steps from (q, a) in float64 through the self
    forward's plain version: the largest |q1|, |p1| and the cost."""
    qt, pt, cost = q.double(), a.double(), 0.0
    for _ in range(nt):
        v, w, dc = rs.rhs_self_fwd_reference(qt, pt, m.double(), cfg.sigma, cfg.withlogdet,
                                             cfg.eta)
        qt, pt, cost = qt + v / nt, pt + w / nt, cost + float(dc.sum()) / nt
    return {"max_abs_q1": float(qt.abs().max()), "max_abs_p1": float(pt.abs().max()),
            "cost": cost}


def v2p_float64(ks, q, m, cfg, alpha=1e-4, tol=1e-6, maxiter=500):
    """v2p's start momenta for a zero field in float64 on the card through the
    kernel-sum's plain version: the right-hand side eta grad_kred(q, q), then
    the CG ridge solve (K + alpha I) a0 = rhs with solvers.kridge_solve_cg's
    stopping rule."""
    import torch

    u = 1.0 / (cfg.sigma * cfg.sigma)

    def ksum(table):
        return ks.ksum_reference(q, q, table.transpose(-1, -2).contiguous(), m,
                                 cfg.sigma).transpose(-1, -2)

    a = ksum(torch.cat([torch.ones_like(q[..., :1]), q], -1))
    rhs = -cfg.eta * u * (q * a[..., :1] - a[..., 1:])
    x, r = torch.zeros_like(rhs), rhs.clone()
    d, rr = r.clone(), float((r * r).sum())
    stop = tol * tol * float((rhs * rhs).sum())
    for _ in range(maxiter):
        if rr <= stop:
            break
        ad = ksum(d) + alpha * d
        step = rr / float((d * ad).sum())
        x, r = x + step * d, r - step * ad
        rr_new = float((r * r).sum())
        d, rr = r + (rr_new / rr) * d, rr_new
    return x


def phase_dense_eta_start(rs, pp, ks):
    """The dense eta path's start at 8,192, 16,384 and 32,768 spiral points:
    v2p's momenta for a zero field (the CG ridge solve above the pair
    limit) and one shoot from them on the kernel route (largest |q1|, |p1|
    and the cost); the same in float64 through the plain versions (nt = 10,
    and nt = 40 for a finer Euler step), and the float32 momenta shot in
    float64; and the self forward at the start,
    the generated one (the route from 32,768 points on) and the ETA kernel,
    against the float64 plain version.  tests/eta_start_jax.py prints the
    same readings for the JAX package.  Fails if the path's own size does
    not stay bounded."""
    import numpy as np
    import torch
    from difficp_torch.examples.run_large import spiral_cloud
    from difficp_torch.models import lddmm

    t0 = time.perf_counter()
    cfg = lddmm.make_config(sigma=SIGMA, lambd=200.0, version="logdet", nt=10,
                            scheme="Euler")
    for n in (8192, 16384, 32768):
        q = torch.as_tensor(spiral_cloud(n, np.random.default_rng(0)))[None].cuda()
        m = torch.ones(q.shape[:-1], device="cuda")
        a0 = lddmm.v2p(cfg, q, torch.zeros_like(q), rcond=1e-3, qmask=m)
        with torch.no_grad():
            final, _ = lddmm.shoot(cfg, q, a0, None, m)
        ref = rs.rhs_self_fwd_reference(q.double(), a0.double(), m.double(), SIGMA, False,
                                        cfg.eta)
        gen_v, gen_gq, _ = pp.rhs_self_fwd_poly(q - ks.mm_center(q, m), a0, m, SIGMA,
                                                cfg.eta, False)
        dv, dw, _ = rs.rhs_self_fwd(q, a0, m, SIGMA, False, cfg.eta)
        a64 = v2p_float64(ks, q.double(), m.double(), cfg)
        shoots64 = {nt: shoot_float64(rs, q, a64, m, cfg, nt) for nt in (10, 40)}
        # the float32 start momenta shot in float64: the solve or the shoot
        shoot64_of_a0 = shoot_float64(rs, q, a0, m, cfg, cfg.nt)
        torch.cuda.synchronize()
        q1, p1 = float(final.q.abs().max()), float(final.p.abs().max())
        stable = math.isfinite(q1) and q1 < 10.0
        emit({"phase": "dense_eta_start", "N": n, "max_abs_a0": float(a0.abs().max()),
              "max_abs_q1": q1, "max_abs_p1": p1, "cost": float(final.cost[0]),
              "stable": stable, "max_abs_v0": float(ref[0].abs().max()),
              "float64": {"max_abs_a0": float(a64.abs().max()),
                          "a0_float32_rel_diff": rel_err(a0, a64),
                          "shoot_nt": shoots64,
                          "shoot_of_float32_a0": shoot64_of_a0},
              "generated_fwd_rel_err": {"vq": rel_err(gen_v, ref[0]),
                                        "-Gq": rel_err(-gen_gq, ref[1])},
              "direct_fwd_rel_err": {"vq": rel_err(dv, ref[0]), "-Gq": rel_err(dw, ref[1])},
              "seconds": time.perf_counter() - t0})
        if n == DENSE_ETA_N and not stable:
            fail("dense_eta_start", f"the start shoot at N={n} does not stay bounded")
        del q, m, a0, final, ref, gen_v, gen_gq, dv, dw, a64
        torch.cuda.empty_cache()
    emit({"phase": "dense_eta_start_done", "seconds": time.perf_counter() - t0})


def phase_dense_eta_path(counters, run_large):
    """examples/run_large.py's configuration with version "logdet" (eta =
    1/200), driven as run_large.main drives DiffPSR: N = DENSE_ETA_N (cut
    from the JAX example's 131,072: from 16,384 points on the start shoot
    diverges, phase dense_eta_start), C = 64, sigma = 0.1, nt = 10 Euler,
    dense support, 2 outer iterations of GMM_opt(10) + 2 x Reg_opt(nmax=1,
    carry_memory, carry_value), line-search budget 25."""
    import numpy as np
    import torch
    from difficp_torch.models import gmm, lddmm
    from difficp_torch.models.psr import DiffPSR

    n_points, n_iter, ls_steps, inner = DENSE_ETA_N, 2, 25, 2
    reset(*counters.values())
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    x_a = run_large.spiral_cloud(n_points, rng)
    x_b = run_large.warp(run_large.spiral_cloud(n_points, rng), 2)
    mu0 = x_b[rng.integers(0, n_points, 64)]
    state, _ = gmm.create(mu0, sigma=0.05, device="cuda")
    gcfg = gmm.GMMConfig(optimize_mu=True, optimize_sigma=True, optimize_w=True,
                         optimize_eta0=False)
    lcfg = lddmm.make_config(sigma=SIGMA, lambd=200.0, version="logdet", nt=10,
                             scheme="Euler")
    psr = DiffPSR(x_a, state, gcfg, lcfg, device="cuda")
    psr.printstuff = False
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    setup_counts = flat_counts(counters)
    # the first GMM_opt records the start momenta's free energy first (the
    # oracle compares the first step with it)
    fes, iters = [], []
    for it in range(n_iter):
        t1 = time.perf_counter()
        psr.GMM_opt(max_iterations=10, tol=1e-3)
        fes.append(psr.FE)
        for _ in range(2):
            psr.Reg_opt(tol=1e-3, nmax=1, inner=inner, ls_steps=ls_steps,
                        carry_memory=True, carry_value=True)
            fes.append(psr.FE)
        torch.cuda.synchronize()
        iters.append(time.perf_counter() - t1)
    flat = flat_counts(counters)
    # each loss+grad: nt self forwards and the Hamiltonian's gradient on the
    # any-eta kernel; nt generated backwards and the Hamiltonian's value on
    # ksum.  The start's shoot adds nt self forwards and one Hamiltonian value.
    per_eval = {"rhs_self_fwd_eta": lcfg.nt + 1, "ksum": lcfg.nt + 1}
    evals = (flat["rhs_self_fwd_eta"] - lcfg.nt) / per_eval["rhs_self_fwd_eta"]
    rec = {"phase": "dense_eta_path", "n_points": n_points, "eta": lcfg.eta,
           "setup_seconds": setup, "seconds_per_outer_iteration": iters,
           "seconds": time.perf_counter() - t0, "FE_sequence": fes,
           "fe_increase_events": psr.fe_increase_events, "setup_launches": setup_counts,
           "launches": flat, "loss_grad_evals": evals,
           "expected_per_loss_grad": per_eval,
           "ksum_launches_as_expected":
               flat["ksum"] == per_eval["ksum"] * evals + 1 + setup_counts["ksum"]}
    emit(rec)
    if not all(flat[key] > 0 for key in ("ksum", "rhs_self_fwd_eta", "rhs_self_fwd")):
        fail("dense_eta_path", f"a kernel of the path never launched: {flat}")
    if not (all(map(math.isfinite, fes)) and monotone(fes)
            and psr.fe_increase_events == 0 and fes[-1] < fes[0]):
        fail("dense_eta_path", "free energy not finite, not monotone or not lower")
    x1 = psr.get_warped_data_points()
    if x1.shape != (n_points, 2) or not bool(np.isfinite(x1).all()):
        fail("dense_eta_path", "warped points have the wrong shape or are not finite")
    hold_fes("dense_eta_path", fes, {"fp32_ksum": DENSE_ETA_FE_FP32_KSUM},
                 DENSE_ETA_FE_BEFORE)
    return flat


def phase_eta_route_agreement(backend, counters):
    """The grid eta workload at 3 x 8,000 points through the kernel route
    (N < 32,768 a frame: the ETA ext forward, not the generated one) and the
    dense route, run(1) and one stepwise Reg_opt: the same free energy
    within TOL_ROUTE_FE."""
    import torch

    t0 = time.perf_counter()
    fes, launches = {}, {}
    for mode in ("kernel", "dense"):
        backend.set_backend(mode)
        reset(*counters.values())
        try:
            psr = grid_psr(3, 8000, version="logdet")
            psr.run(1, **GRID_RUN)
            psr.Reg_opt(tol=1e-3, nmax=1, inner=10, ls_steps=12)
            torch.cuda.synchronize()
        finally:
            backend.set_backend(None)
        fes[mode] = psr.FE
        launches[mode] = flat_counts(counters)
    rel = abs(fes["kernel"] - fes["dense"]) / abs(fes["dense"])
    emit({"phase": "eta_route_agreement", "frames": 3, "n_points": 8000,
          "grid_M": int(psr.q0.shape[1]), "FE_kernel": fes["kernel"],
          "FE_dense": fes["dense"], "rel_diff": rel, "tol": TOL_ROUTE_FE,
          "launches_kernel_route": launches["kernel"],
          "seconds": time.perf_counter() - t0})
    if rel > TOL_ROUTE_FE:
        fail("eta_route_agreement", "kernel and dense routes disagree")
    if not all(launches["kernel"][key] > 0 for key in ETA_KERNELS):
        fail("eta_route_agreement", f"the kernel route skipped a kernel: {launches['kernel']}")


def phase_poly_precision(rs, re, tr):
    """The ext RHS at the grid path's geometry (3 frames x 8,000 spiral
    points, their grid support, sigma = 0.05, eta = 1/500), float32 on the
    kernel route against float64 dense autograd on the card: the largest
    error of each output and gradient relative to its largest magnitude,
    routed (the ETA forward kernels below 32,768 points, the generated
    backward) and with the generated ext forward forced."""
    import numpy as np
    import torch
    from difficp_torch.utils.point_sets import grid_support

    k, n, d = 3, 8000, 2
    x = torch.as_tensor(np.stack(grid_frames(k, n))).cuda()
    q = torch.as_tensor(grid_support(x.reshape(-1, d).cpu().numpy(), GRID_SIGMA)).cuda()
    q = q.expand(k, *q.shape).contiguous()
    g = torch.Generator(device="cuda").manual_seed(2)
    p = 0.05 * torch.randn(q.shape, generator=g, device="cuda")
    mq, mx = torch.ones(q.shape[:-1], device="cuda"), torch.ones(x.shape[:-1], device="cuda")
    cots = [torch.randn(q.shape, generator=g, device="cuda") for _ in range(2)] + [
        torch.randn((k,), generator=g, device="cuda"),
        torch.randn(x.shape, generator=g, device="cuda")]
    t64 = [a.double().requires_grad_(True) for a in (q, p, x)]
    out = tr.lddmm_rhs_ext(*t64, GRID_SIGMA, GRID_ETA, True, mq.double(), mx.double())
    ref = [o.detach() for o in out] + list(torch.autograd.grad(
        sum((o * c.double()).sum() for o, c in zip(out, cots)), t64))
    names = ["vq", "-Gq", "dcost", "vx", "dq", "dp", "dx"]
    labels = ("routed", "generated_ext_forward")
    rec = {"phase": "poly_precision", "frames": k, "N": n, "M": q.shape[1],
           "sigma": GRID_SIGMA, "eta": GRID_ETA}
    keep = rs._POLY_FWD_MIN_M
    try:
        for label, gate in zip(labels, (keep, 1)):
            rs._POLY_FWD_MIN_M = gate
            t = [a.clone().requires_grad_(True) for a in (q, p, x)]
            o = re.RHSExt.apply(*t, mq, mx, GRID_SIGMA, True, GRID_ETA)
            grads = torch.autograd.grad(sum((a * c).sum() for a, c in zip(o, cots)), t)
            got = [a.detach() for a in o] + list(grads)
            rec[label] = {nm: rel_err(a, r) for nm, a, r in zip(names, got, ref)}
    finally:
        rs._POLY_FWD_MIN_M = keep
    worst = max(max(rec[label].values()) for label in labels)
    rec["max_rel_err"] = worst
    rec["above_log_threshold"] = worst > POLY_ERR_LOG
    emit(rec)
    if not math.isfinite(worst):
        fail("poly_precision", "non-finite error")
    return rec


def phase_api_eta(counters, icp_two_set, icp_atlas):
    """icp_two_set and icp_atlas (two frames) with gradcomponent_LDDMM=True
    (default grid support) on the card, at 16,384 points a frame: the
    smallest power of two at which the grid's M (M + N) pairs leave the
    dense route."""
    import numpy as np
    import torch
    from difficp_torch.examples.run_large import spiral_cloud, warp

    n = 16384
    rng = np.random.default_rng(2)
    x_a = spiral_cloud(n, rng)
    x_b = warp(spiral_cloud(n, rng), 2)
    reg = {"type": "diffeomorphic", "sigma_LDDMM": GRID_SIGMA, "lambda_LDDMM": 5e2}
    num = {"gradcomponent_LDDMM": True}
    for name, call in (
        ("icp_two_set", lambda cb: icp_two_set(
            x_a, x_b, GMM_parameters={"sigma": 0.05, "optimize_sigma": True},
            registration_parameters=reg, numerical_options=num,
            optim_options={"max_iterations": 1}, printstuff=False, callback_function=cb,
            device="cuda")),
        ("icp_atlas", lambda cb: icp_atlas(
            grid_frames(2, n), GMM_parameters={"init_components": 20},
            registration_parameters=reg, numerical_options=num,
            optim_options={"max_iterations": 1}, printstuff=False, callback_function=cb,
            device="cuda")),
    ):
        fes = []
        reset(*counters.values())
        t0 = time.perf_counter()
        psr, _ = call(lambda p, after_gmm: fes.append(p.FE))
        torch.cuda.synchronize()
        flat = flat_counts(counters)
        emit({"phase": "api_eta", "entry": name, "n_points": n, "frames": psr.K,
              "support": psr.support_scheme, "grid_M": int(psr.q0.shape[1]),
              "eta": psr.lcfg.eta, "seconds": time.perf_counter() - t0,
              "FE_sequence": fes, "fe_increase_events": psr.fe_increase_events,
              "launches": flat})
        if not (monotone(fes) and psr.fe_increase_events == 0
                and math.isfinite(psr.FE)):
            fail("api_eta", f"{name}: free energy not monotone")
        if psr.lcfg.eta == 0.0 or not all(flat[key] > 0 for key in ETA_KERNELS):
            fail("api_eta", f"{name} did not take the eta kernel route: {flat}")

# ---------------------------------------------------------------------------
# the point-sharded two-set slice (parallel/): the cross forward kernel
# ---------------------------------------------------------------------------

def cross_inputs(n, d, seed):
    """Rows on a spiral cloud and columns on a warped copy of another one,
    each with random momenta and a mask with ~10% holes."""
    import numpy as np
    import torch
    from difficp_torch.examples.run_large import spiral_cloud, warp

    g = torch.Generator().manual_seed(seed)
    qr = torch.as_tensor(spiral_cloud(n, np.random.default_rng(seed), dim=d))
    qc = torch.as_tensor(warp(spiral_cloud(n, np.random.default_rng(seed + 1), dim=d), d))
    pr, pc = (0.05 * torch.randn((n, d), generator=g) for _ in range(2))
    mr, mc = ((torch.rand((n,), generator=g) > 0.1).float() for _ in range(2))
    return [t[None].cuda() for t in (qr, pr, mr, qc, pc, mc)]


def phase_check_cross(rs, rc):
    """The cross forward kernel (#10, eta = 0) and its ETA instance (#11)
    against their plain versions in float64 on the same float32 inputs,
    distinct row and column sets of 16,384 and 65,536 points with holes, d =
    2 and 3, the eta = 0 kernel also with its rows shuffled (the outputs
    permuted back); the ETA instance at eta = 0 against the eta = 0 kernel
    within TOL_FWD, and the cross entry with a set as its own columns against
    the self entry, bit for bit."""
    import torch

    t0 = time.perf_counter()
    worst = {"rhs_cross_fwd": [0.0, 0.0], "rhs_cross_fwd_eta": [0.0, 0.0]}
    identical = True
    g = torch.Generator(device="cuda").manual_seed(8)
    for n in (16384, 65536):
        for d in (2, 3):
            args = cross_inputs(n, d, seed=n + d)
            f64 = [t.double() for t in args]
            perm = torch.randperm(n, generator=g, device="cuda")
            inv = torch.argsort(perm)
            shuffled = [t[:, perm].contiguous() for t in args[:3]] + list(args[3:])
            for name, eta, rows in (("rhs_cross_fwd", 0.0, "natural"),
                                    ("rhs_cross_fwd", 0.0, "shuffled"),
                                    ("rhs_cross_fwd_eta", DENSE_ETA, "natural")):
                for wl in ((True, False) if n == 16384 else (True,)):
                    ins = args if rows == "natural" else shuffled
                    v, w, dc = rc.rhs_cross_fwd(*ins, SIGMA, wl, eta)
                    if rows == "shuffled":
                        v, w, dc = v[:, inv], w[:, inv], dc[:, inv]
                    torch.cuda.synchronize()
                    rv, rw, rdc = rc.rhs_cross_fwd_reference(*f64, SIGMA, wl, eta)
                    torch.cuda.synchronize()
                    rel = max(rel_err(v, rv), rel_err(w, rw))
                    dc_rel = float((dc.double().sum() - rdc.sum()).abs()
                                   / rdc.abs().sum().clamp_min(1e-300))
                    ok = rel <= TOL_FWD and dc_rel <= TOL_FWD
                    emit({"phase": "check_cross", "kernel": name, "rows": rows, "M": n, "N": n,
                          "d": d, "eta": eta, "withlogdet": wl, "rel_err": rel,
                          "dcost_rel_err": dc_rel, "tol": TOL_FWD, "ok": ok})
                    if not ok:
                        fail("check_cross", f"{name} disagrees with its plain version at "
                                            f"M=N={n} d={d} withlogdet={wl} rows {rows}")
                    worst[name][0] = max(worst[name][0], rel, dc_rel)
                    worst[name][1] = max(worst[name][1], abs_err(v, rv), abs_err(w, rw))
            del f64, v, w, dc, rv, rw, rdc
            qr, pr, mr = args[:3]
            at_0 = max(rel_err(a, b.double()) for a, b in zip(
                rc.launch_fwd(*args, SIGMA, True, 0.0, True)[:2],
                rc.launch_fwd(*args, SIGMA, True, 0.0, False)[:2]))
            self_same = all(torch.equal(a, b) for eta, use in ((0.0, False), (DENSE_ETA, True))
                            for a, b in zip(rs.launch_fwd(qr, pr, mr, SIGMA, True, eta, use),
                                            rc.launch_fwd(qr, pr, mr, qr, pr, mr, SIGMA, True,
                                                          eta, use)))
            emit({"phase": "check_cross_identity", "N": n, "d": d,
                  "eta_instance_at_0_rel_diff": at_0, "tol": TOL_FWD,
                  "self_entry_bit_identical": self_same})
            identical = identical and at_0 <= TOL_FWD and self_same
    torch.cuda.empty_cache()
    emit({"phase": "check_cross_done", "seconds": time.perf_counter() - t0,
          "identities_hold": identical})
    if not identical:
        fail("check_cross", "the ETA instance at eta = 0 or the self entry departs from the "
                            "eta = 0 cross kernel")
    return worst


def phase_timing_cross(rc, pp):
    """Each cross instance at the shape its ring path gives it (world size 1:
    the whole set as rows and columns; #10 at RING_N points, logdet on, #11
    at RING_ETA_N), first held against its float64 plain version there, then
    timed with CUDA events (median of 15) beside its plain version and its
    bound (the function's least work per ordered pair, at eta = 0 the lower
    of that and the table route's own: table_bound); then ksum at every
    kernel-sum shape of the two ring paths (ksum_calls)."""
    import torch
    from difficp_torch.ops import rhs_self as rs

    t0 = time.perf_counter()
    out, worst = {}, {}
    for name, n, eta in (("rhs_cross_fwd", RING_N, 0.0),
                         ("rhs_cross_fwd_eta", RING_ETA_N, DENSE_ETA)):
        d = 2
        q, p, mask, *_ = make_inputs(n, d, False, seed=n)
        args = (q, p, mask, q, p, mask)
        got = rc.rhs_cross_fwd(*args, SIGMA, True, eta)
        torch.cuda.synchronize()
        ref = rc.rhs_cross_fwd_reference(*(t.double() for t in args), SIGMA, True, eta)
        rel = max(rel_err(a, r) for a, r in zip(got[:2], ref[:2]))
        worst[name] = [rel, max(abs_err(a, r) for a, r in zip(got[:2], ref[:2]))]
        emit({"phase": "check_main_shape", "kernel": name, "M": n, "N": n, "d": d,
              "rel_err": rel, "tol": TOL_FWD, "ok": rel <= TOL_FWD})
        if rel > TOL_FWD:
            fail("check_main_shape", f"{name} disagrees at the ring path's shape")
        del got, ref
        # the rows' order once beforehand, as the ring's shoot computes it
        order = rs.row_order(q, mask, SIGMA) if eta == 0.0 else None
        fn = lambda: rc.rhs_cross_fwd(*args, SIGMA, True, eta, order)  # noqa: E731
        plain = lambda: rc.rhs_cross_fwd_reference(*args, SIGMA, True, eta)  # noqa: E731
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ms = cuda_ms(fn, 15)
        plain()
        torch.cuda.synchronize()
        plain_ms = cuda_ms(plain, 3)
        # the work this run's data needs: every (unmasked row, unmasked
        # column) pair once; rows and columns read once, outputs written once
        pairs = float(mask.sum()) ** 2
        ops = (rc.cross_fwd_ops_per_pair(d) if eta == 0.0
               else rc.cross_fwd_eta_ops_per_pair(d, True))
        nbytes = 4.0 * n * (2 * d + 1) * 3
        bd = bound(pairs, ops, pairs, nbytes)
        if eta == 0.0:
            bd = table_bound(bd, pairs, d, rs.tensor_flops_per_pair(d, False))
        out[name] = dict(M=n, N=n, d=d, ms=ms, plain_ms=plain_ms, library_ms=None, **bd,
                         share_of_bound=bd["bound_ms"] / ms, pairs=pairs,
                         fp32_ops_per_pair=ops, gpair_per_s=pairs / (ms * 1e-3) / 1e9)
        emit({"phase": "timing", "kernel": name, **out[name]})
    torch.cuda.empty_cache()
    # the ring paths' kernel-sums: the generated cross backward's two tables
    # and the cross Hamiltonian's three, at both ring paths' shapes
    from difficp_torch.ops import ksum as ks

    worst["ksum"] = [0.0, 0.0]
    out["ksum"] = time_ksum_calls(ks, ksum_calls(pp, "ring"), worst)
    emit({"phase": "timing_cross_done", "seconds": time.perf_counter() - t0})
    return out, worst


def twoset_problem(n, version):
    """examples/run_large.py's problem at n points: a spiral cloud registered
    onto a GMM of C = 64 components over a warped copy (sigma 0.05), LDDMM
    sigma = 0.1, lambda = 200, nt = 10 Euler, dense support."""
    import numpy as np
    import torch
    from difficp_torch.examples.run_large import spiral_cloud, warp
    from difficp_torch.models import gmm, lddmm

    rng = np.random.default_rng(0)
    x_a = spiral_cloud(n, rng)
    x_b = warp(spiral_cloud(n, rng), 2)
    state, _ = gmm.create(x_b[rng.integers(0, n, 64)], sigma=0.05, device="cuda")
    gcfg = gmm.GMMConfig(optimize_mu=True, optimize_sigma=True, optimize_w=True,
                         optimize_eta0=False)
    lcfg = lddmm.make_config(sigma=SIGMA, lambd=200.0, version=version, nt=10,
                             scheme="Euler")
    return torch.as_tensor(x_a), state, gcfg, lcfg


def em_targets(gcfg, st, x1, mask, em_iters):
    """The E/M steps a two-set step opens with: the GMM state, the targets y,
    the free-energy offset and the weights gammaT."""
    from difficp_torch.models import gmm

    for _ in range(em_iters):
        st = gmm.em_step(st, x1, mask, gcfg).state
    out = gmm.em_step(st, x1, mask, gcfg, skip_m=True)
    return st, out.y, out.cfe, out.gamt


def alternation_step(gcfg, lcfg, q0, mask, st, a, x1, alpha, memory):
    """One step of the single-device alternation at the two-set step's
    budgets (tests/test_parallel_twoset.py:157-175): EM, then lddmm.optimize
    on the dense path (one frame), the curvature memory carried."""
    from difficp_torch.models import lddmm

    st, y, cfe, ptw = em_targets(gcfg, st, x1, mask, RING_STEP["em_iters"])
    sig2 = st.sigma ** 2

    def dataloss(pts):
        return (((mask * ptw)[:, None] * (pts[0] - y) ** 2).sum() / (2.0 * sig2))[None]

    res = lddmm.optimize(lcfg, dataloss, q0[None], a[None], None, mask[None], None,
                         nmax=RING_STEP["reg_nmax"], tol=RING_STEP["tol"],
                         inner=RING_STEP["reg_inner"],
                         max_linesearch_steps=RING_STEP["reg_ls"], alpha0=alpha,
                         memory0=memory)
    fe = float(cfe + res.trajl[0] + res.datal[0])
    return st, res.p0[0], res.final.q[0], fe, res.alpha, res.memory


def phase_ring_path(phase, n, version, steps, counters, kernel, start_tol=None):
    """The point-sharded two-set registration at world size 1 over NCCL on
    run_large's problem at n points: ``steps`` make_twoset_step calls (the
    launch counters set to 0 just before, read just after), then the same
    budgets through the single-device alternation; the loss and gradient of
    the ring and of the dense path at the first step's start (held to
    ``start_tol``, (loss, gradient), when given), and the seconds of a ring
    loss+grad.  At eta = 0 the momenta start at zero, as in
    the JAX package's two-set tests; at eta != 0 zero momenta carry the
    gradcomponent field, whose shoot diverges on these clouds, so they start
    where DiffPSR.initialize_a0 starts them (v2p's momenta for a zero field)
    with the points shot from there."""
    import torch
    import torch.distributed as dist
    from difficp_torch.models import lddmm
    from difficp_torch.parallel import (init_distributed, make_sharded_reg_loss,
                                        make_twoset_step, shard_twoset, zero_twoset_memory)

    t0 = time.perf_counter()
    x_a, gstate, gcfg, lcfg = twoset_problem(n, version)
    group, size, _ = init_distributed("cuda")
    try:
        backend_name = dist.get_backend(group)
        q0, mask = shard_twoset(group, x_a, torch.ones(n), device="cuda")
        step = make_twoset_step(gcfg, lcfg, group, carry_memory=True, **RING_STEP)
        a_start, x_start = torch.zeros_like(q0), q0
        if lcfg.eta != 0.0:
            with torch.no_grad():
                a_start = lddmm.v2p(lcfg, q0[None], torch.zeros_like(q0)[None], rcond=1e-3,
                                    qmask=mask[None])[0]
                x_start = lddmm.shoot(lcfg, q0[None], a_start[None], None, mask[None])[0].q[0]
        torch.cuda.synchronize()
        reset(*counters.values())
        st, a, x1, al, mem = gstate, a_start, x_start, 0.0, zero_twoset_memory(q0)
        fes, step_s = [], []
        for _ in range(steps):
            t1 = time.perf_counter()
            out = step(st, q0, a, x1, mask, al, mem)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            st, a, x1, al, mem = out.gmm, out.a0, out.x1, out.alpha, out.memory
            fes.append(float(out.fe))
        flat = flat_counts(counters)

        # the start of the first step: the ring's loss and gradient against
        # the dense path's on the same EM targets; a ring loss+grad timed
        st1, y, _, ptw = em_targets(gcfg, gstate, x_start, mask, RING_STEP["em_iters"])
        sig2 = st1.sigma ** 2
        ring_loss = make_sharded_reg_loss(lcfg, group)

        def ring_vg():
            p = a_start.clone().requires_grad_(True)
            loss = ring_loss(p, q0, y, ptw, mask, sig2)
            return loss.detach(), torch.autograd.grad(loss, p)[0]

        def dense_vg():
            p = a_start[None].clone().requires_grad_(True)
            final, _ = lddmm.shoot(lcfg, q0[None], p, None, mask[None])
            quad = ((mask * ptw)[:, None] * (final.q[0] - y) ** 2).sum() / (2.0 * sig2)
            loss = lddmm.trajloss(lcfg, q0[None], p, final.cost, mask[None])[0] + quad
            return loss.detach(), torch.autograd.grad(loss, p)[0][0]

        (l_ring, g_ring), (l_dense, g_dense) = ring_vg(), dense_vg()
        torch.cuda.synchronize()
        vg_s = []
        for _ in range(3):
            t1 = time.perf_counter()
            ring_vg()
            torch.cuda.synchronize()
            vg_s.append(time.perf_counter() - t1)
    finally:
        dist.destroy_process_group()
    loss_rel = float((l_ring - l_dense).abs() / l_dense.abs())
    grad_rel = rel_err(g_ring, g_dense.double())

    # the single-device alternation at the same budgets
    t1 = time.perf_counter()
    st, a, x1, alpha, mem, twin = gstate, a_start, x_start, None, None, []
    for _ in range(steps):
        st, a, x1, fe, alpha, mem = alternation_step(gcfg, lcfg, q0, mask, st, a, x1, alpha,
                                                     mem)
        twin.append(fe)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t1

    nt = lcfg.nt
    evals = flat[kernel] / nt
    per_eval = {kernel: nt, "ksum": 2 * nt + 3}
    exact = (flat[kernel] == nt * round(evals)
             and flat["ksum"] == per_eval["ksum"] * round(evals)
             and all(v == 0 for key, v in flat.items() if key not in per_eval))
    fe_rel = [abs(f - t) / abs(t) for f, t in zip(fes, twin)]
    rec = {"phase": phase, "n_points": n, "world_size": size, "backend": backend_name,
           "version": version, "eta": lcfg.eta, "steps": steps, **RING_STEP,
           "FE_sequence": fes, "alternation_FE_sequence": twin, "FE_rel_diff": fe_rel,
           "tol_fe": TOL_RING_FE, "start_loss": float(l_ring),
           "start_loss_dense": float(l_dense), "start_loss_rel_diff": loss_rel,
           "start_grad_rel_err": grad_rel, "tol_start": start_tol,
           "alpha": float(out.alpha),
           "seconds_per_step": step_s, "loss_grad_evals": evals,
           "seconds_per_loss_grad": statistics.median(vg_s),
           "alternation_seconds": twin_s, "launches": flat,
           "expected_per_loss_grad": per_eval, "launches_exact": exact,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if not (flat[kernel] > 0 and flat["ksum"] > 0 and exact):
        fail(phase, f"launch counts not those of {evals} loss+grad evaluations: {flat}")
    if not all(map(math.isfinite, fes)):
        fail(phase, f"free energy not finite: {fes}")
    if any(b > a + 1e-3 * abs(a) for a, b in zip(fes, fes[1:])):
        fail(phase, f"free energy not monotone: {fes}")
    if max(fe_rel) > TOL_RING_FE:
        fail(phase, f"free energies {fes} differ from the alternation's {twin}")
    if not (math.isfinite(loss_rel) and math.isfinite(grad_rel)):
        fail(phase, "start loss or gradient not finite")
    if start_tol is not None and (loss_rel > start_tol[0] or grad_rel > start_tol[1]):
        fail(phase, f"start loss ({loss_rel}) or gradient ({grad_rel}) differs from the "
                    f"dense path's")
    if tuple(out.x1.shape) != (n, 2) or not bool(torch.isfinite(out.x1).all()):
        fail(phase, "warped points have the wrong shape or are not finite")
    return rec


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
    from difficp_torch.ops import ksum as ks
    from difficp_torch.ops import pair_poly as pp
    from difficp_torch.ops import reductions as tr
    from difficp_torch.ops import rhs_cross as rc
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
          "one_call_seconds": one_call_build_seconds(_build), "ptxas": regs,
          "ksum_ptxas": ksum_ptxas(_build.build_log)})

    counters = {"rhs_self": rs.launches, "rhs_ext": re.launches, "kmin2": k2.launches,
                "ksum": ks.launches, "rhs_cross": rc.launches}
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
    psr, grid_launches = phase_grid_main_path(counters, rs.orders)
    phase_grid_route_agreement(backend)
    phase_api_grid(counters, icp_two_set, icp_atlas)
    t0 = time.perf_counter()
    # an outer iteration cut to one L-BFGS step of 10 inner iterations: the
    # trace's own cost grows with its launches
    phase_profile(psr, counters, run_kw=dict(GRID_RUN, reg_nmax=1))
    emit({"phase": "profile_done", "seconds": time.perf_counter() - t0})
    del psr

    # the gradcomponent (eta != 0) slice
    worst.update(phase_check_eta(rs, re, ks))
    timing_eta, worst_eta = phase_timing_eta(rs, re, ks, pp)
    for name, (rel, ab) in worst_eta.items():
        worst[name] = [max(worst[name][0], rel), max(worst[name][1], ab)]
    psr_eta, grid_eta_launches = phase_grid_eta_path(counters, ks)
    phase_dense_eta_start(rs, pp, ks)
    t0 = time.perf_counter()
    dense_eta_launches = phase_dense_eta_path(counters, run_large)
    emit({"phase": "dense_eta_path_done", "seconds": time.perf_counter() - t0})
    phase_eta_route_agreement(backend, counters)
    phase_poly_precision(rs, re, tr)
    t0 = time.perf_counter()
    phase_api_eta(counters, icp_two_set, icp_atlas)
    emit({"phase": "api_eta_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    # cut to 5 EM steps and one L-BFGS step of 4 inner iterations
    phase_profile(psr_eta, counters, phase="profile_eta",
                  evals_of=lambda c: c["rhs_self"]["rhs_self_fwd_eta"] / psr_eta.lcfg.nt,
                  run_kw=dict(GRID_RUN, max_em=5, reg_nmax=1, reg_inner=4), host_ops=True)
    emit({"phase": "profile_eta_done", "seconds": time.perf_counter() - t0})

    # the point-sharded two-set slice: the cross forward kernel and the ring
    worst.update(phase_check_cross(rs, rc))
    timing_cross, worst_cross = phase_timing_cross(rc, pp)
    for name, (rel, ab) in worst_cross.items():
        worst[name] = [max(worst[name][0], rel), max(worst[name][1], ab)]
    timing_eta["ksum"] += timing_cross.pop("ksum")
    ring = phase_ring_path("ring_twoset_path", RING_N, "hybrid", 2, counters, "rhs_cross_fwd",
                           TOL_RING_START)
    ring_eta = phase_ring_path("ring_eta_path", RING_ETA_N, "logdet", 1, counters,
                               "rhs_cross_fwd_eta")

    pr = "difficp_tpu/ops/pallas_reductions.py"
    sources = {"rhs_self": "difficp_torch/csrc/rhs_self.cu",
               "rhs_ext": "difficp_torch/csrc/rhs_ext.cu",
               "kmin2": "difficp_torch/csrc/kmin2.cu"}
    replaces = {
        "rhs_self_fwd": (sources["rhs_self"], f"{pr}:928", [f"{pr}:1175", f"{pr}:677"]),
        "rhs_self_bwd": (sources["rhs_self"], f"{pr}:742", [f"{pr}:1175", f"{pr}:433",
                                                            f"{pr}:310"]),
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
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": rep,
            "also_replaces": also, "launches": grid_launches[name],
            "launches_by_path": launches_by_path, "max_abs_err": worst[name][1],
            "max_rel_err": worst[name][0], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms")}
        # the table kernels: the least work's and their route's bounds, of
        # which bound_ms is the lower
        entry.update({key: t[key] for key in TABLE_BOUND_KEYS if key in t})
        if name in dense_launches:
            # and the grid shape
            entry.update(shape=t["shape"],
                         shapes=[{key: r[key] for key in ("shape", "ms", "plain_ms", "bound_ms",
                                                          "bound_by", *TABLE_BOUND_KEYS)}
                                 for r in (t, timing[f"{name}_grid"])])
        kernels.append(entry)
    pk = "difficp_tpu/ops/pallas_ksum.py"
    eta_kernels = {
        "ksum": ("difficp_torch/csrc/ksum.cu", f"{pk}:266",
                 [f"{pk}:71", f"{pk}:205", f"{pk}:98", f"{pk}:110", f"{pk}:382",
                  f"{pk}:315"]),
        "rhs_self_fwd_eta": (sources["rhs_self"], f"{pr}:179", [f"{pr}:83"]),
        "rhs_ext_fwd_eta": (sources["rhs_ext"], f"{pr}:271", [f"{pr}:211"]),
    }
    for name, (source, rep, also) in eta_kernels.items():
        shapes = timing_eta[name]
        # the headline shape: the grid eta path's costliest call of the kernel
        grid = [r for r in shapes if not r["call"].startswith(("dense", "ring"))]
        t = max(grid, key=lambda r: r["ms"])
        by_path = {"grid_eta_path": grid_eta_launches[name],
                   "dense_eta_path": dense_eta_launches[name]}
        if name == "ksum":
            by_path.update({path["phase"]: path["launches"][name] for path in (ring, ring_eta)})
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": rep,
            "also_replaces": also, "launches": grid_eta_launches[name],
            "launches_by_path": by_path,
            "max_abs_err": worst[name][1], "max_rel_err": worst[name][0],
            "shape": t["call"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"),
            "shapes": [{key: r[key] for key in ("call", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}
                       for r in shapes]})
    for name, rep, also, path in (
            ("rhs_cross_fwd", f"{pr}:2218", [f"{pr}:677"], ring),
            ("rhs_cross_fwd_eta", f"{pr}:2247", [f"{pr}:83"], ring_eta)):
        t = timing_cross[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources["rhs_self"], "replaces": rep,
            "also_replaces": also, "launches": path["launches"][name],
            "launches_by_path": {path["phase"]: path["launches"][name]},
            "max_abs_err": worst[name][1], "max_rel_err": worst[name][0],
            "shape": f"{t['M']} x {t['N']}", "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            **{key: t[key] for key in TABLE_BOUND_KEYS if key in t}})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
