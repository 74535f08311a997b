#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``difficp_torch``) on one CUDA card.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each printing JSON lines with its seconds:
  1. device      the card's name and power limit (nvidia-smi);
  2. build       nvcc builds the kernels of difficp_torch/csrc from source,
                 one nvcc per source, all started together; g++ builds the
                 host library (decim support's decimation);
  3. check       each kernel against its plain PyTorch version on the card
                 (the plain version evaluated in float64 on the same float32
                 inputs): the self RHS at M = 16,381 (ragged, ~10% masked) and
                 65,536, also with its rows shuffled, and dq at the dense
                 path's geometry within 1e-5; the ext RHS on 3 frames of
                 N = 16,381 (ragged) and
                 65,536 data points against their grid support at sigma = 0.05
                 and a masked custom support; kmin2 on 33 leading frames with
                 duplicated points, both modes, with a random mask and with
                 ragged masks (each frame its own count of valid columns, the
                 padding at the end); d = 2 and 3, logdet on and off;
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
  8. utils path  the ported utilities on the grid main path's end state:
                 save_psr / load_psr into a fresh grid psr (bit for bit on
                 the card), continued by a GMM_opt and a Reg_opt with no
                 free-energy increase; a Deformetrica output directory of
                 that state replayed by load_deformetrica_output (template,
                 control points and momenta read back bit for bit, each
                 step of the warped templates within 1e-5 of a float64
                 plain step, their end-to-end distance printed beside the
                 float32 plain version's); Gridlines of 128 lines x 512
                 points registered forward (within 1e-5 of float64) and
                 backward (printed: that inverse diverges at this state)
                 and shot with speeds;
                 profiling.trace around one loss+grad (the trace names the
                 five RHS kernels) with phase_timer and timings_summary;
  9. decim main path  the same workload with decim support (each frame's own
                 greedy cover at rho = 1, padded with masks): run(1) and one
                 stepwise Reg_opt; the support sizes a frame (decim_M), its
                 set-up seconds (the decimation included), peak memory, its
                 FE sequence bit for bit as first recorded, and the
                 objective and gradient at its end against the float64
                 table kernels;
 10. decim route agreement  that workload at 3 x 4,000 points through the
                 kernel route and the dense route: the FE sequences within
                 5e-3;
 11. grid route agreement  the same workload at 3 x 4,000 points through the
                 kernel route and the dense route;
 12. api grid    icp_two_set and icp_atlas with default numerical options;
 13. profile     a torch.profiler trace of one outer iteration of the grid
                 main path, cut to one L-BFGS step (reg_nmax = 1):
                 device-busy share, top CUDA operations, launches, host time
                 between launches;
 14. check eta   the gradcomponent (eta != 0) slice's kernels against their
                 plain versions in float64: the generic kernel-sum (ksum) at
                 3, 6, 9, 20 and 121 columns (d = 2) and 333 (d = 3), masked,
                 several frames, a shared y and a split y axis, and at its
                 tile edges (1, 8, 128, 129 columns; 15, 16, 17 rows); the ETA
                 instances of the self and ext forward kernels; the ETA
                 instances at eta = 0 against the eta = 0 kernels (self:
                 within 1e-5, ext: bit for bit);
 15. timing eta  each of them at the shapes the two eta paths give it, first
                 held against its float64 plain version there, then timed
                 beside its plain version and its bound; then the direct
                 forwards (the any-eta self forward, the ext forward) at
                 d = 3 likewise; the direct forwards and the grid path's
                 kernels are timed by their device time too (device_ms);
 16. grid eta path  the grid main path with gradcomponent_LDDMM (version
                 "logdet", eta = 1/500), from start momenta computed with the
                 kernel-sum's float64 plain version, so that the sequence it
                 prints depends on the kernels only along the trajectory;
                 at its end the objective and its gradient through ksum
                 against those through the float64 plain version;
 17. dense eta path  examples/run_large.py's configuration with version
                 "logdet" (eta = 1/200) at N = 8,192, driven as
                 run_large.main drives DiffPSR; before it, the stability of
                 its start (v2p's momenta for a zero field, one shoot) at
                 8,192, 16,384 and 32,768 points, in float32 on the kernels
                 and in float64 on their plain versions, which sets that size;
 18. eta route agreement  the grid eta workload at 3 x 8,000 points through
                 the kernel route and the dense route (one outer
                 iteration and a stepwise Reg_opt); and the generated
                 backward's float32 error at the grid path's geometry against
                 float64 dense autograd (the poly-precision line);
 19. api eta     icp_two_set and icp_atlas with gradcomponent_LDDMM=True,
                 one iteration each;
 20. profile eta a torch.profiler trace of one outer iteration of the grid
                 eta path, cut to 5 EM steps and one L-BFGS step of 4 inner
                 iterations, with the host operators by their own CPU time;
 21. check cross the cross forward kernel (rows against a different column
                 set: rhs_cross_fwd, and its ETA instance) against its plain
                 version in float64, distinct sets of 16,384 and 65,536 points
                 with holes, d = 2 and 3, rows also shuffled; its ETA
                 instance at eta = 0 within 1e-5, its self entry bit for bit;
 22. timing cross each instance at its ring path's shape, held against its
                 plain version there, then timed beside it and its bound; the
                 same for ksum at every kernel-sum of both ring paths (the
                 generated cross backward's two tables, the cross
                 Hamiltonian's three);
 23. ring twoset path  the point-sharded two-set registration
                 (parallel/twoset.py over parallel/ring.py) at world size 1
                 over NCCL on run_large's problem at 65,536 points: two
                 make_twoset_step calls against the single-device alternation
                 (EM + lddmm.optimize) at the same budgets, the start loss and
                 gradient against the dense path's, seconds per step and per
                 loss+grad, exact launch counts;
 24. ring eta path  the same with version "logdet" at 8,192 points, one
                 step from the momenta DiffPSR.initialize_a0 gives (zero
                 momenta carry the gradcomponent field, whose shoot diverges
                 on these clouds).
 25. multi structure path  examples/run_full.py's three-structure atlas at
                 full width: 10 frames of a spiral, a circle and a bar of
                 21,000-22,699 points each drawn on the card (random_p's
                 rff_cg sampler, then a dense shoot a frame; its CG residual
                 held), icp_atlas with {"set": 0, "C": 20} (gmm.fit a
                 structure), grid support, 2 outer iterations: seconds, peak
                 memory, launches per loss+grad, the sigmas; then each kernel
                 on the path's own inputs (padded rows inside the row axis)
                 against its float64 plain version;
 26. affine atlas path  the grid main path's frames through icp_atlas with
                 {"set": 0, "C": 20} for rigid, similarity and general
                 affine, 3 outer iterations each (no kernel: the EM and the
                 batched closed-form fits), det(M) ranges; AffinePSR.run(3)
                 against 3 stepwise iterations within 5e-3;
 27. auto lambda path  icp_two_set with lambda_LDDMM "auto" on two spiral
                 frames of 16,384 points (the calibration's Ralston shoots
                 on rows #1 and #4), 2 outer iterations on grid support; the
                 calibration against the self kernels' float32 plain versions
                 from the same start momenta (h0_ref, lambda), and v2p's
                 start on the plain versions with both starts' residuals.
 28. check kred  the standard algorithm's kernel-sums (KRed on ksum, as
                 kred_scal takes them in data_distance; mdivsum) against
                 their float64 plain versions at the standard paths' shapes:
                 the atlas's <fy, fx> and <fx, fx> at 10 x 65,536 x 65,536,
                 the two-set's <fy, fy> at 65,536^2 with a weights payload
                 (dx + dy in one tensor, db); values and gradients; then
                 each timed (events and device time) beside its float32
                 plain version and its ksum calls' bound;
 29. standard atlas path  standard_atlas on the grid main path's frames
                 (10 x 65,536, the template frame 0's 65,536 points, grid
                 support at sigma = 0.05, sigma_data 0.1, noise_std 0.2, 2
                 iterations): seconds, the E sequence with no increase,
                 launches per loss+grad, peak memory; then each kernel of
                 the path on its own end state against float64;
 30. standard two-set path  standard_two_set of two such frames with dense
                 support (65,536 support points, sigma = 0.1), 2 iterations
                 of nmax_per_iter 4, held and printed likewise, then a
                 "rigid" standard two-set on the same pair;
 31. standard route agreement  the standard atlas at 3 x 2,048 points on
                 the kernel route and on the dense route: E sequences within
                 5e-3.
 32. offload atlas path  HostOffloadAtlas (models/offload.py) on the grid
                 main path's problem at 40 frames of 65,536 points held in
                 pinned host memory, streamed in chunks of 10 frames, run(1):
                 seconds, FE, host-device bytes an outer iteration, launches
                 a loss+grad, peak device memory;
 33. offload agreement  the same at 10 frames in chunks of 5 against
                 DiffPSR with all 10 on the card (em_tol = 0), one outer
                 iteration: FE within 5e-3, warped points at rtol 5e-2 /
                 atol 5e-3, both peaks, and the 40-frame peak at
                 most 1.25 times DiffPSR's;
 34. atlas step path  the frame-parallel atlas step (parallel/atlas.py) at
                 world size 1 over NCCL at 10 x 65,536 on the grid: 3 steps
                 threading the step sizes, 3 with the curvature memory, the
                 first against the single-device alternation within 5e-3;
 35. blockwise path  the blockwise route (ops/blockwise.py) forced: the
                 grid route agreement's workload against the kernel route,
                 one loss+grad of run_large's dense problem at 65,536 points
                 against the kernel route (peak under 8 GiB), and the
                 "accurate" backward (the blockwise VJP) against the
                 backward kernels at the grid state.
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
# the direct forward kernels (csrc/direct.cuh), timed also by their device
# time (device_ms)
DIRECT_KERNELS = ("rhs_ext_fwd", "rhs_ext_fwd_eta", "rhs_self_fwd_eta", "rhs_cross_fwd_eta")
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
# The grid path also prints GRID_FE_DIRECT_FWD, the sequence it printed with
# the ext forward of one thread a row (csrc/direct.cuh's kernel sums each row
# in another order: 7.7e-4 from it over all four entries).
GRID_FE_DIRECT = [22501056.0, -1347914.25, -1391784.75]
GRID_FE_DIRECT_EXT_BWD = [22501056.0, -1347946.625, -1391633.875, -1413118.75]
GRID_FE_DIRECT_FWD = [22501056.0, -1347924.625, -1392195.5, -1414159.75]
GRID_FE_BEFORE = [22501056.0, -1347923.375, -1393268.25, -1414657.25]
# the decim main path's free energies as this script printed them first
# (held bit for bit: the decimation and the kernels are deterministic)
DECIM_FE_BEFORE = [22501056.0, -1340335.875, -1352068.5, -1353956.375]
# The paths below were cut to one outer iteration to keep the script inside its
# time limit.  Each is held bit for bit to *_RUN1: the leading entries of its
# earlier sequence that stay (the start and the first iteration), then the
# stepwise Reg_opt after one iteration as this script first printed it
DECIM_FE_RUN1 = DECIM_FE_BEFORE[:2] + [-1350286.875]
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
# The any-eta self forward of csrc/direct.cuh sums each row in another order
# than the kernel of one thread a row before it, whose sequences are kept as
# *_DIRECT_FWD: the dense eta path moved 3.0e-4 (all six entries, held), the
# grid eta path's first entry 2.0e-5 (held) and its second and third 1.7e-3
# and 8.2e-3 (not held: within what the 1 + 2^-22 scaling above moves them)
GRID_ETA_FE_DIRECT_FWD = [-1339679.0, -1442487.75, -1484406.875]
DENSE_ETA_FE_DIRECT_FWD = ([-16926.025390625] + [-16926.04296875] * 2
                           + [-16959.234375] * 3)
GRID_ETA_FE_BEFORE = [-1339705.25, -1444913.875, -1496632.75]
# cut to one outer iteration (see DECIM_FE_RUN1)
GRID_ETA_FE_RUN1 = GRID_ETA_FE_BEFORE[:1] + [-1354102.625]
DENSE_ETA_FE_BEFORE = ([-16920.896484375, -16920.9453125, -16921.06640625]
                       + [-16955.337890625] * 3)
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
# the multi-structure path: examples/run_full.py's generative model and atlas
# (sigma_GMM 0.02, sigma_LDDMM 0.15, lambda 2e2 for the frames; the atlas at
# sigma_LDDMM 0.2, lambda 2e2, grid rho = 1) with each structure's counts
# widened so that a frame holds about 65,536 points
MULTI_FRAMES = 10
MULTI_N_BOUNDS = (21000, 22700)
MULTI_SIGMA = 0.2
# random_p's CG stops where its recursive float32 residual is 1e-6 of its
# right-hand side; the true residual of its last iterate, recomputed in
# float64 by the plain version, has drifted from that by the rounding of
# every step: held within 1e-4.  The phase prints it also with the kernel's
# own float32 K b: the two agree (PERF.md), so the gap is the iterate's, not
# one matvec's
TOL_CG_RESIDUAL = 1e-4
# the auto-calibrated registration: two spiral frames of AUTO_N points (the
# calibration's dense Ralston shoot at 268M pairs).  Its start energy h0_ref
# and its lambda = l_ref / H(x, p0) are held within TOL_CALIB of float64 H at
# the same momenta, relative to themselves.  v2p's momenta there make K a0
# some 5e5 times smaller than K |a0|, below what any float32 sum resolves to
# 1e-4: the kernels (held at the terms' scale) and the float32 plain versions
# both give an H some 2% from float64's (PERF.md)
AUTO_N = 16384
TOL_CALIB = 5e-2


# the standard algorithm's paths: the JAX package's own standard bench
# settings (benchmarks/scale_bench.py:237-240): sigma_data 0.1, noise_std 0.2,
# on the grid main path's frames; the atlas at sigma_LDDMM = GRID_SIGMA on
# the API's default grid support (rho = 1), the two-set with dense support at
# run_large's sigma_LDDMM = SIGMA
STD_FRAMES = 10
STD_N = 65536
STD_MODEL = {"sigma_data": 0.1, "noise_std": 0.2}
STD_ITERS = 2
STD_ROUTE_N = 2048


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


def ptxas_report(log, pattern, name_of):
    """{name: [registers, spill-store bytes]} of each kernel instance whose
    entry function matches ``pattern`` (``name_of(match)`` its name), from
    ptxas's report in the build log."""
    import re

    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '" + pattern, ln)
        if m:
            name = name_of(m)
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


def ksum_ptxas(log):
    """Each instance of the ksum kernel: {"D=d NT=n": [registers, spills]}."""
    return ptxas_report(log, r".*ksum_kernelILi(\d)ELi(\d+)E",
                        lambda m: f"D={m.group(1)} NT={m.group(2)}")


def direct_ptxas(log):
    """Each instance of the direct forward kernel (csrc/direct.cuh):
    {"SelfEta<d>" / "ExtFwd<d, eta>": [registers, spills]}."""
    return ptxas_report(
        log, r".*direct_kernelINS_\d+(SelfEta|ExtFwd)ILi(\d)E(?:Lb(\d)E)?",
        lambda m: f"{m.group(1)}<{m.group(2)}"
                  + (f", {bool(int(m.group(3)))}>" if m.group(3) else ">"))


def kmin2_ptxas(log):
    """Each instance of the kmin2 kernel: {"D=d exclude_self=b": [registers,
    spills]}."""
    return ptxas_report(log, r".*kmin2_kernelILi(\d)ELb(\d)E",
                        lambda m: f"D={m.group(1)} exclude_self={bool(int(m.group(2)))}")


def device_ms(fn, reps):
    """Median device milliseconds of the one kernel each run of fn launches,
    over the last ``reps`` of the kernels a torch.profiler trace of 3 reps
    runs holds: the kernel's own time.  CUDA events around one call
    (cuda_ms) take the host's time in the wrapper as well, since the card
    waits for the launch; at a few microseconds of kernel that is most of
    what they read.  The trace may miss the kernels of the first
    milliseconds (13 of 45 launches of a 0.075 ms kernel were traced once):
    a trace that holds fewer than ``reps`` is taken again, with twice the
    runs, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    runs = 3 * reps
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if len(spans) >= reps:
            return statistics.median((b - a) / 1e3 for a, b in spans[-reps:])
        runs *= 2
    raise RuntimeError(f"device_ms: {len(spans)} kernels traced over {runs // 2} calls")


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


def grid_problem(k, n, version="hybrid"):
    """bench.py's atlas workload (bench.py:82-105) at k frames of n points:
    the frames, C = 20 GMM components from 20 points of frame 0, LDDMM
    ("hybrid", or "logdet" for the gradcomponent model) at sigma = 0.05,
    lambda = 500, nt = 10 Euler: (frames, GMM state, its config, the LDDMM
    config)."""
    import numpy as np
    from difficp_torch.models import gmm, lddmm

    x = grid_frames(k, n)
    mu0 = x[0][np.random.default_rng(0).integers(0, n, 20)]
    state, _ = gmm.create(mu0, device="cuda")
    gcfg = gmm.GMMConfig(optimize_mu=True, optimize_sigma=True, optimize_w=True,
                         optimize_eta0=False)
    lcfg = lddmm.make_config(sigma=GRID_SIGMA, lambd=5e2, version=version, nt=10,
                             scheme="Euler")
    return x, state, gcfg, lcfg


def grid_psr(k, n, version="hybrid", scheme="grid"):
    """DiffPSR on grid_problem(k, n, version) with grid support at rho = 1
    (or the decimation of each frame, scheme="decim", at the same cover
    radius)."""
    from difficp_torch.models.psr import DiffPSR

    x, state, gcfg, lcfg = grid_problem(k, n, version)
    psr = DiffPSR(x, state, gcfg, lcfg, device="cuda")
    psr.printstuff = False
    psr.set_support_scheme(scheme, rho=1.0)
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
    # nt = 10 sends them), duplicated points, both modes; a random mask, and
    # ragged masks as decim support gives them: each frame of the 11 its own
    # count of valid columns (all, all but 3, one, none, half, two, ...), the
    # padding at the end on a point where 50 rows sit
    rng = np.random.default_rng(5)
    for d in (2, 3):
        for exclude_self, (n, m), ragged in ((False, (16381, 500), False),
                                             (True, (4096, 4096), False),
                                             (False, (16381, 500), True),
                                             (True, (4096, 4096), True)):
            y = rng.uniform(size=(3, 11, m, d))
            y[..., m // 2:m // 2 + 100, :] = y[..., :100, :]
            x = y if exclude_self else rng.uniform(size=(3, 11, n, d))
            if not exclude_self:
                x[..., :50, :] = y[..., 200:250, :]  # distance 0 to a y
            my = (rng.uniform(size=(3, 11, m)) > 0.1).astype(np.float64)
            if ragged:
                my[:] = 0.0
                for f in range(11):
                    valid = [m, m - 3, 1, 0, m // 2, 2][f % 6]
                    my[:, f, :valid] = 1.0
                    y[:, f, valid:] = -1.0
                if not exclude_self:
                    x[..., 50:100, :] = -1.0  # on the padding's place
            x, y, my = (torch.tensor(t, dtype=torch.float32, device="cuda")
                        for t in (x, y, my))
            m1, m2 = k2.kmin2(x, y, my, exclude_self)
            r1, r2 = k2.kmin2_reference(x.double(), y.double(), my.double(), exclude_self)
            torch.cuda.synchronize()
            # +inf where the plain version has it; each finite distance
            # relative to itself
            same_inf = bool(((torch.isinf(m1.double()) == torch.isinf(r1))
                             & (torch.isinf(m2.double()) == torch.isinf(r2))).all())
            rel = max(float(((a.double() - b).abs() / b.abs().clamp_min(1e-30))
                            [torch.isfinite(b)].max()) for a, b in ((m1, r1), (m2, r2)))
            ab = max(abs_err(a[torch.isfinite(b)], b[torch.isfinite(b)])
                     for a, b in ((m1, r1), (m2, r2)))
            ok = same_inf and rel <= TOL_KMIN2
            again = k2.kmin2(x, y, my, exclude_self)
            same = torch.equal(m1, again[0]) and torch.equal(m2, again[1])
            ok = ok and same
            emit({"phase": "check_kmin2", "frames": [3, 11], "N": n, "M": m, "d": d,
                  "exclude_self": exclude_self, "ragged_masks": ragged,
                  "ties": int((m1 == m2).sum()), "inf_m2": int(torch.isinf(m2).sum()),
                  "rel_err": rel, "tol": TOL_KMIN2, "bit_identical_repeat": same, "ok": ok})
            if not ok:
                fail("check_kmin2", f"kmin2 disagrees with its plain version at d={d} "
                                    f"exclude_self={exclude_self} ragged={ragged}")
            note("kmin2", rel, ab)
    emit({"phase": "check_ext_done", "seconds": time.perf_counter() - t0})
    return worst


def path_holds(phase, path, shape, worst):
    """The hold functions of a kernel held on a path's own inputs: ``hold``
    emits a record (with ``shape``), fails the run where rel > tol and keeps
    the worst errors in ``worst``; ``hold_sums`` takes the worst error of a
    kernel's outputs against float64, relative to each output's largest
    entry or to that of its ``scale`` (and of each frame's dcost against the
    sum of its terms' magnitudes)."""
    def hold(name, rel, ab, tol, **rec):
        ok = rel <= tol
        emit({"phase": phase, "kernel": name, **shape, **rec, "rel_err": rel,
              "abs_err": ab, "tol": tol, "ok": ok})
        if not ok:
            fail(phase, f"{name} disagrees with its plain version on the {path} "
                        f"path's inputs {rec}")
        old = worst.get(name, (0.0, 0.0))
        worst[name] = [max(old[0], rel), max(old[1], ab)]

    def hold_sums(name, got, ref, tol, dcost=None, scale=None, **rec):
        rel = max(rel_err(a, r) for a, r in zip(got, ref))
        ab = max(abs_err(a, r) for a, r in zip(got, ref))
        if scale is not None:
            # relative to the largest entry of each output's ``scale`` instead
            rec["rel_err_to_largest_output"] = rel
            rec["scale_over_largest_output"] = [float(m.abs().max() / r.abs().max())
                                                for r, m in zip(ref, scale)]
            rel = max(abs_err(a, r) / float(m.abs().max()) for a, r, m in zip(got, ref, scale))
        if dcost is not None:
            # each frame's dcost against the sum of its terms' magnitudes
            dc, rdc = dcost
            rec["dcost_rel_err"] = float((dc.double().sum(-1) - rdc.sum(-1)).abs().max()
                                         / rdc.abs().sum(-1).max().clamp_min(1e-300))
            rel = max(rel, rec["dcost_rel_err"])
        hold(name, rel, ab, tol, **rec)
    return hold, hold_sums


def hold_self_kernels(phase, path, rs, q, p, mq, order, seed, sig):
    """The eta = 0 self forward and backward on a path's own support (q, p,
    mq, its rows' order), logdet off as the classic model runs them, against
    their float64 plain versions within TOL_FWD and TOL_BWD (random
    cotangents of v and w from ``seed``, a zero dcost cotangent), each error
    relative to the largest entry of the same sums in float64 with the
    momenta's and the cotangents' signs dropped.  Momenta that cancel (v2p's
    for a small field above the pair limit) leave outputs far below their
    terms, which no float32 sum resolves: the error relative to the largest
    output is printed beside it, with the ratio of the two scales.  A wrong
    pair term moves the sums by a share of the held scale.  Fails the run on
    any miss.
    Returns the worst errors {kernel: [rel, abs]} and the float64 v = K p."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    gv = torch.randn(q.shape, generator=g, device="cuda")
    gw = torch.randn(q.shape, generator=g, device="cuda")
    zero = torch.zeros(q.shape[:1], device="cuda")
    shape = {"path": path, "frames": q.shape[0], "M": q.shape[1], "d": q.shape[2]}
    worst = {}
    hold, hold_sums = path_holds(phase, path, shape, worst)
    q8, p8, mq8, gv8, gw8, zero8 = (t.double() for t in (q, p, mq, gv, gw, zero))
    got = rs.rhs_self_fwd(q, p, mq, sig, False, order=order)
    ref = rs.rhs_self_fwd_reference(q8, p8, mq8, sig, False)
    mag = rs.rhs_self_fwd_reference(q8, p8.abs(), mq8, sig, False)
    hold_sums("rhs_self_fwd", got[:2], ref[:2], TOL_FWD, scale=mag[:2], withlogdet=False)
    v8 = ref[0]
    del got, ref, mag
    mag = rs.rhs_self_bwd_reference(q8, p8.abs(), mq8, gv8.abs(), gw8.abs(), zero8, sig, False)
    hold_sums("rhs_self_bwd", rs.rhs_self_bwd(q, p, mq, gv, gw, zero, sig, False, order),
              rs.rhs_self_bwd_reference(q8, p8, mq8, gv8, gw8, zero8, sig, False),
              TOL_BWD, scale=mag, withlogdet=False)
    del mag
    torch.cuda.empty_cache()
    return worst, v8


def hold_path_kernels(phase, path, rs, re, k2, x, mx, q, p, mq, cov, seed, sig=GRID_SIGMA):
    """Each eta = 0 kernel of a registration path with external points, on
    the path's own inputs, against its float64 plain version: the support's
    self forward and backward, the ext forward and its two backward kernels
    (data points x, mx; support q, p, mq; sigma ``sig``; random cotangents
    from ``seed``; logdet on, and off as the path runs them, with a zero dcost cotangent
    for the self backward; the support's and the data rows' orders computed
    once, as the path does) within TOL_FWD and TOL_BWD, and kmin2 over the
    coverage pass's frames ``cov`` = (x, y, mask_y) within TOL_KMIN2 of each
    distance, +inf where the plain version has it (none where cov is None:
    a path without a coverage pass).  Fails the run on any
    miss.  Returns the worst errors {kernel: [rel, abs]}, the cotangents
    (gx, gc, gv, gw) and the orders."""
    import torch

    k, n, d = x.shape
    m = q.shape[1]
    g = torch.Generator(device="cuda").manual_seed(seed)
    gx = torch.randn(x.shape, generator=g, device="cuda")
    gc = torch.randn((k,), generator=g, device="cuda")
    gv = torch.randn(q.shape, generator=g, device="cuda")
    gw = torch.randn(q.shape, generator=g, device="cuda")
    order = rs.row_order(q, mq, sig)
    xorder = re.data_order(x, mx, sig)
    shape = {"path": path, "frames": k, "N": n, "M": m, "d": d,
             "valid_M": [int(c) for c in mq.sum(-1).tolist()]}
    worst = {}
    hold, hold_sums = path_holds(phase, path, shape, worst)

    x8, mx8, q8, p8, mq8, gx8, gc8, gv8, gw8 = (
        t.double() for t in (x, mx, q, p, mq, gx, gc, gv, gw))
    for wl in (True, False):
        got = rs.rhs_self_fwd(q, p, mq, sig, wl, order=order)
        ref = rs.rhs_self_fwd_reference(q8, p8, mq8, sig, wl)
        hold_sums("rhs_self_fwd", got[:2], ref[:2], TOL_FWD, (got[2], ref[2]), withlogdet=wl)
        cot, cot8 = (gc, gc8) if wl else (torch.zeros_like(gc), torch.zeros_like(gc8))
        hold_sums("rhs_self_bwd", rs.rhs_self_bwd(q, p, mq, gv, gw, cot, sig, wl, order),
                  rs.rhs_self_bwd_reference(q8, p8, mq8, gv8, gw8, cot8, sig, wl),
                  TOL_BWD, withlogdet=wl)
        vx, dc = re.rhs_ext_fwd(x, mx, q, p, mq, sig, wl)
        rvx, rdc = re.rhs_ext_fwd_reference(x8, mx8, q8, p8, mq8, sig, wl)
        hold_sums("rhs_ext_fwd", [vx], [rvx], TOL_FWD, (dc, rdc), withlogdet=wl)
        hold_sums("rhs_ext_bwd_dx",
                  [re.rhs_ext_bwd_dx(x, mx, gx, q, p, mq, gc, sig, wl, xorder)],
                  [re.rhs_ext_bwd_dx_reference(x8, mx8, gx8, q8, p8, mq8, gc8, sig, wl)],
                  TOL_BWD, withlogdet=wl)
        hold_sums("rhs_ext_bwd_dqdp",
                  re.rhs_ext_bwd_dqdp(x, mx, gx, q, p, mq, gc, sig, wl, order),
                  re.rhs_ext_bwd_dqdp_reference(x8, mx8, gx8, q8, p8, mq8, gc8, sig, wl),
                  TOL_BWD, withlogdet=wl)
    del x8, mx8, q8, p8, mq8, gx8, gc8, gv8, gw8, got, ref, vx, dc, rvx, rdc
    if cov is None:
        torch.cuda.empty_cache()
        return worst, (gx, gc, gv, gw), (order, xorder)
    # kmin2 over all the coverage frames in one launch; its float64 plain
    # version k frames at a time, to bound its memory
    m1, m2 = k2.kmin2(*cov)
    refs = [k2.kmin2_reference(*(t[s:s + k].double() for t in cov))
            for s in range(0, cov[0].shape[0], k)]
    rel, ab, same_inf = 0.0, 0.0, True
    for i, got in enumerate((m1, m2)):
        ref = torch.cat([r[i] for r in refs])
        fin = torch.isfinite(ref)
        same_inf &= bool((torch.isinf(got) == torch.isinf(ref)).all())
        if bool(fin.any()):
            # relative to each distance: a plain rel_err over the largest
            # would hide the small ones the coverage check reads
            err = (got.double() - ref).abs()[fin]
            rel = max(rel, float((err / ref.abs()[fin].clamp_min(1e-30)).max()))
            ab = max(ab, float(err.max()))
    del refs, m1, m2
    hold("kmin2", rel if same_inf else math.inf, ab, TOL_KMIN2,
         coverage_frames=cov[0].shape[0], coverage_M=cov[1].shape[1],
         inf_where_plain=same_inf)
    torch.cuda.empty_cache()
    return worst, (gx, gc, gv, gw), (order, xorder)


def phase_timing_ext(rs, re, k2):
    """Each new kernel at the grid main path's shape (K = 10, N = 65,536,
    the run's grid M, d = 2; dq/dp with the support's order and dx with the
    data rows' order computed once beforehand, as the path does); kmin2 at
    the coverage pass's (nt + 1) K frames.  Each kernel of the grid path, the
    self kernels on the support included, is first held against its plain
    version in float64 on the same inputs (hold_path_kernels).  Then CUDA
    events, median of 15, beside the bound: the function's least work, for
    dx and dq/dp the lower of that and their table route's own
    (table_bound)."""
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
    worst, (gx, gc, gv, gw), (order, xorder) = hold_path_kernels(
        "check_main_shape", "grid", rs, re, k2, x, mx, q, p, mq, xs, seed=4)
    del gv, gw

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
        dev_ms = device_ms(fn, 15)
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
        out[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                         **bd, share_of_bound=bd["bound_ms"] / ms,
                         device_share_of_bound=bd["bound_ms"] / dev_ms, pairs=npairs,
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
                                        "direct_ext_bwd": GRID_FE_DIRECT_EXT_BWD[:3],
                                        "direct_fwd": GRID_FE_DIRECT_FWD[:3]},
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
            psr.run(1, **GRID_RUN)
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


def phase_decim_main_path(counters, orders):
    """The grid main path's workload (10 x 65,536 points, sigma = 0.05) with
    decim support, the JAX package's default scheme: each frame's own greedy
    cover at r = rho sigma, padded to one width with masks.  DiffPSR.run(1)
    and one stepwise Reg_opt (its coverage pass: kmin2 over the (nt + 1) K
    frames with the per-frame masks); then the objective and its gradient at
    the path's end against the float64 table kernels', and each kernel of the
    path against its float64 plain version on the path's own inputs (its
    data points, its masked per-frame supports and momenta, and the coverage
    pass's frames of one more shoot: hold_path_kernels); then kmin2's time
    at the coverage pass's shape.  Returns the launches, the worst errors and
    kmin2's timing record."""
    import torch
    from difficp_torch.models import lddmm
    from difficp_torch.ops import kmin2 as k2
    from difficp_torch.ops import rhs_ext as re
    from difficp_torch.ops import rhs_self as rs

    k, n = 10, 65536
    reset(*counters.values(), orders)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    psr = grid_psr(k, n, scheme="decim")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    decim_m = [int(c) for c in psr.qmask.sum(1).tolist()]
    fe0 = psr.FE
    t1 = time.perf_counter()
    fes = psr.run(1, **GRID_RUN)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    psr.Reg_opt(tol=1e-3, nmax=1, inner=10, ls_steps=12)
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t2
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    flat = {key: v for c in counters.values() for key, v in c.items() if key in ETA0_KERNELS}
    fe_seq = [fe0, *map(float, fes), psr.FE]
    evals = flat["rhs_self_bwd"] / psr.lcfg.nt
    n_orders = orders["row_order"]
    emit({"phase": "decim_main_path", "frames": k, "n_points": n, "rho": psr.rho,
          "decim_M": decim_m, "support_width": int(psr.q0.shape[1]),
          "sigma_lddmm": GRID_SIGMA, "setup_seconds": setup, "run_seconds": run_s,
          "seconds_per_outer_iteration": run_s, "reg_opt_seconds": reg_s,
          "seconds": seconds, "FE_sequence": fe_seq,
          "fe_increase_events": psr.fe_increase_events,
          "uncovered": psr.last_reg_stats["uncovered"].cpu().tolist(),
          "last_reg_evals": psr.last_reg_evals.cpu().tolist(),
          "launches": flat, "loss_grad_evals": evals, "row_orders": n_orders,
          "max_memory_allocated_bytes": peak})
    if not all(v > 0 for v in flat.values()):
        fail("decim_main_path", f"a kernel of the path never launched: {flat}")
    if not 0 < n_orders <= evals:
        fail("decim_main_path", f"{n_orders} row orders for {evals} loss+grad evaluations")
    if not min(decim_m) > 0 or psr.support_scheme != "decim":
        fail("decim_main_path", f"a frame has no support point: {decim_m}")
    if not (all(map(math.isfinite, fe_seq)) and monotone(fe_seq)
            and psr.fe_increase_events == 0):
        fail("decim_main_path", "free energy not finite or not monotone")
    if not fe_seq[-1] < fe_seq[0]:
        fail("decim_main_path", "free energy did not decrease over the run")
    if tuple(psr.x1.shape) != (k, n, 2) or not bool(torch.isfinite(psr.x1).all()):
        fail("decim_main_path", "warped points have the wrong shape or are not finite")
    hold_fes("decim_main_path", fe_seq, {}, DECIM_FE_RUN1)
    hold_end_state("decim_main_end_state", psr, float64_table_kernels)

    nx, m, d = psr.x0.shape[1], psr.q0.shape[1], psr.D  # the padded widths
    a0 = psr.a0.detach()
    with torch.no_grad():
        _, traj = lddmm.shoot(psr.lcfg, psr.q0, a0, psr.x0, psr.qmask, psr.xmask,
                              save_traj=True)
    # the coverage pass's call: every time step of every frame, the support's
    # mask expanded over the time steps (backend.check_coverage)
    cov = [traj.x.reshape(-1, nx, d).contiguous(), traj.q.reshape(-1, m, d).contiguous(),
           psr.qmask.expand(traj.q.shape[:-1]).reshape(-1, m).contiguous()]
    del traj
    worst, _, _ = hold_path_kernels("check_decim_path", "decim", rs, re, k2, psr.x0,
                                    psr.xmask, psr.q0, a0, psr.qmask, cov, seed=5)
    fn = lambda: k2.kmin2(*cov)  # noqa: E731
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    frames = cov[0].shape[0]
    # the work this run's data needs: the pairs with a valid support column
    pairs = float(nx) * float(cov[2].sum())
    bd = bound(pairs, k2.ops_per_pair(d), 0.0,
               4.0 * frames * (nx * d + m * (d + 1) + 2 * nx))
    timing = dict(call=f"decim coverage {frames} x {nx:,} x {m}", frames=frames, N=nx, M=m,
                  valid_M=[int(c) for c in psr.qmask.sum(-1).tolist()],
                  ms=cuda_ms(fn, 15), device_ms=device_ms(fn, 15), pairs=pairs, **bd)
    timing["device_share_of_bound"] = bd["bound_ms"] / timing["device_ms"]
    emit({"phase": "timing", "kernel": "kmin2", **timing})
    del cov
    torch.cuda.empty_cache()
    return flat, worst, timing


def phase_decim_route_agreement(backend):
    """The decim main path's workload at 3 x 4,000 points through the kernel
    route and the dense route on the card: run(1) and one stepwise Reg_opt,
    the FE sequences entry by entry within TOL_ROUTE_FE."""
    import torch

    t0 = time.perf_counter()
    fes = {}
    for mode in ("kernel", "dense"):
        backend.set_backend(mode)
        try:
            psr = grid_psr(3, 4000, scheme="decim")
            fe0 = psr.FE
            run = psr.run(1, **GRID_RUN)
            psr.Reg_opt(tol=1e-3, nmax=1, inner=10, ls_steps=12)
            torch.cuda.synchronize()
        finally:
            backend.set_backend(None)
        fes[mode] = [fe0, *map(float, run), psr.FE]
        if psr.fe_increase_events:
            fail("decim_route_agreement", f"free energy rose on the {mode} route")
    rel = rel_diff_fes(fes["kernel"], fes["dense"])
    emit({"phase": "decim_route_agreement", "frames": 3, "n_points": 4000,
          "decim_M": [int(c) for c in psr.qmask.sum(1).tolist()],
          "FE_kernel": fes["kernel"], "FE_dense": fes["dense"], "rel_diff": rel,
          "tol": TOL_ROUTE_FE, "seconds": time.perf_counter() - t0})
    if rel > TOL_ROUTE_FE:
        fail("decim_route_agreement", "kernel and dense routes disagree")


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
        dev_ms = device_ms(fn, 15)
        plain()
        torch.cuda.synchronize()
        plain_ms = cuda_ms(plain, 3)
        nb, mpts = qq.shape[0], qq.shape[1]
        upairs = float((mm.sum(-1) * (mm.sum(-1) - 1) / 2).sum())
        nbytes = 4.0 * nb * mpts * ((2 * d + 1) + (2 * d + 1))
        bd = bound(upairs, rs.fwd_eta_ops_per_unordered_pair(d, wl), upairs, nbytes)
        rec = dict(call=label, frames=nb, M=mpts, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                   library_ms=None, **bd, share_of_bound=bd["bound_ms"] / ms,
                   device_share_of_bound=bd["bound_ms"] / dev_ms)
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
    dev_ms = device_ms(fn, 15)
    plain()
    torch.cuda.synchronize()
    plain_ms = cuda_ms(plain, 3)
    pairs = float(k * m * n)
    nbytes = 4.0 * k * (m * (d + 1) + n * (2 * d + 1) + m * d)
    bd = bound(pairs, re.fwd_eta_ops_per_pair(d, False), pairs, nbytes)
    out["rhs_ext_fwd_eta"] = [dict(call="v_field", frames=k, N=m, M=n, ms=ms, device_ms=dev_ms,
                                   plain_ms=plain_ms, library_ms=None, **bd,
                                   share_of_bound=bd["bound_ms"] / ms,
                                   device_share_of_bound=bd["bound_ms"] / dev_ms)]
    emit({"phase": "timing", "kernel": "rhs_ext_fwd_eta", **out["rhs_ext_fwd_eta"][0]})
    out["ksum"] = shapes
    torch.cuda.empty_cache()
    emit({"phase": "timing_eta_done", "seconds": time.perf_counter() - t0})
    return out, worst


def phase_timing_direct_d3(rs, re):
    """The direct forwards at d = 3, which no main path runs above the pair
    limit: the any-eta self forward on one frame of 16,384 helix points
    (sigma = 0.1, eta = 1/200, logdet on) and the ext forward at eta = 0 on
    3 frames of 65,536 helix points against their grid support (sigma =
    0.05, logdet on).  Each first held against its float64 plain version
    (TOL_FWD; each frame's dcost against its terms' magnitudes), then timed
    (cuda_ms and device_ms, median of 15) beside its plain version and its
    bound (the function's least work)."""
    import torch

    t0 = time.perf_counter()
    d = 3
    q, p, m, *_ = make_inputs(16384, d, False, seed=7)
    x, mx, qs, ps, mq, *_ = ext_inputs(3, 65536, d, False, "grid", seed=65539)
    upairs = float((m.sum(-1) * (m.sum(-1) - 1) / 2).sum())
    pairs = float((mx.sum(-1) * mq.sum(-1)).sum())
    k, n, msup = x.shape[0], x.shape[1], qs.shape[1]
    out, worst = {}, {}
    for name, call, fn, plain, bd in (
            ("rhs_self_fwd_eta", "self d = 3, 16,384^2",
             lambda: rs.rhs_self_fwd(q, p, m, SIGMA, True, DENSE_ETA),
             lambda dt: rs.rhs_self_fwd_reference(*(t.to(dt) for t in (q, p, m)), SIGMA, True,
                                                  DENSE_ETA),
             bound(upairs, rs.fwd_eta_ops_per_unordered_pair(d, True), upairs,
                   4.0 * q.shape[1] * (2 * d + 1) * 2)),
            ("rhs_ext_fwd", "ext d = 3, 3 x 65,536 x M",
             lambda: re.rhs_ext_fwd(x, mx, qs, ps, mq, GRID_SIGMA, True),
             lambda dt: re.rhs_ext_fwd_reference(*(t.to(dt) for t in (x, mx, qs, ps, mq)),
                                                 GRID_SIGMA, True),
             bound(pairs, re.fwd_ops_per_pair(d), pairs,
                   4.0 * k * (n * (d + 1) + msup * (2 * d + 1) + n * (d + 1))))):
        got = fn()
        torch.cuda.synchronize()
        ref = plain(torch.float64)
        rel = max(rel_err(a, r) for a, r in zip(got[:-1], ref[:-1]))
        dc_rel = float((got[-1].double().sum(-1) - ref[-1].sum(-1)).abs().max()
                       / ref[-1].abs().sum(-1).max().clamp_min(1e-300))
        ab = max(abs_err(a, r) for a, r in zip(got[:-1], ref[:-1]))
        ok = max(rel, dc_rel) <= TOL_FWD
        emit({"phase": "check_main_shape", "kernel": name, "call": call, "rel_err": rel,
              "dcost_rel_err": dc_rel, "abs_err": ab, "tol": TOL_FWD, "ok": ok})
        if not ok:
            fail("check_main_shape", f"{name} disagrees with its plain version at {call}")
        worst[name] = [max(rel, dc_rel), ab]
        del got, ref
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ms = cuda_ms(fn, 15)
        dev_ms = device_ms(fn, 15)
        plain(torch.float32)
        torch.cuda.synchronize()
        plain_ms = cuda_ms(lambda: plain(torch.float32), 3)
        out[name] = dict(call=call, d=d, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=None, **bd, share_of_bound=bd["bound_ms"] / ms,
                         device_share_of_bound=bd["bound_ms"] / dev_ms)
        emit({"phase": "timing", "kernel": name, **out[name]})
    torch.cuda.empty_cache()
    emit({"phase": "timing_direct_d3_done", "seconds": time.perf_counter() - t0})
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
    return timed_loss_grad(psr)[:2]


def timed_loss_grad(psr):
    """loss_grad(psr) and the seconds of its forward and of its backward."""
    import torch

    from difficp_torch.models import lddmm
    from difficp_torch.models.psr import _frame_quad_dataloss

    ext = psr.support_scheme is not None
    dataloss = _frame_quad_dataloss(psr.y, psr._sig2_vector(), psr.xmask, psr.ptw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lossfn = lddmm._make_lossfn_aux(psr.lcfg, dataloss, psr.q0, psr.x0 if ext else None,
                                    psr.qmask, psr.xmask if ext else None)
    p = psr.a0.detach().clone().requires_grad_(True)
    loss, _ = lossfn(p)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (grad,) = torch.autograd.grad(loss.sum(), p)
    torch.cuda.synchronize()
    return loss.detach(), grad, t1 - t0, time.perf_counter() - t1


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
def plain_ksum(ks, dtype, out_dtype=None):
    """ks.ksum taken by its plain version on the caller's tensors in
    ``dtype`` (float64: the reference the kernel is held to; float32: the
    plain version's time), its output in ``out_dtype`` (default ``dtype``),
    inside the block; these calls launch no kernel."""
    kernel = ks.ksum

    def plain(x, y, table, my, sigma):
        out = ks.ksum_reference(x.to(dtype), y.to(dtype), table.to(dtype),
                                None if my is None else my.to(dtype), sigma)
        return out if out_dtype is None else out.to(out_dtype)

    ks.ksum = plain
    try:
        yield
    finally:
        ks.ksum = kernel


def float64_ksum(ks):
    """ks.ksum taken by its plain version in float64, rounded to float32 at
    its output, inside the block."""
    import torch

    return plain_ksum(ks, torch.float64, torch.float32)


def grid_eta_psr(ks):
    """The grid eta path's DiffPSR: grid_psr(10, 65,536) with version
    "logdet", its start momenta (v2p on the dense support, then the
    projection onto the grid) computed with the kernel-sum's float64 plain
    version, the same whichever kernel-sum runs the path after it."""
    with float64_ksum(ks):
        return grid_psr(10, 65536, version="logdet")


def grid_eta_run(psr, iters=1):
    """The grid eta path after its set-up: run(iters) and one stepwise
    Reg_opt.  The FE sequence (the iterations', then the Reg_opt's), and the
    seconds of each."""
    import torch

    t1 = time.perf_counter()
    fes = psr.run(iters, **GRID_RUN)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    psr.Reg_opt(tol=1e-3, nmax=1, inner=10, ls_steps=12)
    torch.cuda.synchronize()
    return [*map(float, fes), psr.FE], run_s, time.perf_counter() - t2


def phase_grid_eta_path(counters, ks):
    """The grid main path with the gradcomponent model (version "logdet",
    eta = 1/500): DiffPSR set-up (grid_eta_psr), run(1) and one stepwise
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
           "seconds_per_outer_iteration": run_s, "reg_opt_seconds": reg_s,
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
                                           "float64_ksum": GRID_ETA_FE_FLOAT64_KSUM,
                                           "direct_fwd": GRID_ETA_FE_DIRECT_FWD[:1]},
                 GRID_ETA_FE_RUN1)
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
    hold_fes("dense_eta_path", fes, {"fp32_ksum": DENSE_ETA_FE_FP32_KSUM,
                                     "direct_fwd": DENSE_ETA_FE_DIRECT_FWD},
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
        dev_ms = device_ms(fn, 15) if name in DIRECT_KERNELS else None
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
        out[name] = dict(M=n, N=n, d=d, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=None, **bd, share_of_bound=bd["bound_ms"] / ms,
                         device_share_of_bound=dev_ms and bd["bound_ms"] / dev_ms, pairs=pairs,
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


def iteration_marks():
    """A callback for the APIs that records the card's time (synchronized)
    at each call, with its after-GMM flag, and the free energy after each
    registration step."""
    import torch

    marks, fes = [], []

    def callback(psr, after_gmm):
        torch.cuda.synchronize()
        marks.append((after_gmm, time.perf_counter()))
        if not after_gmm:
            fes.append(psr.FE)
    return marks, fes, callback


def iteration_seconds(marks):
    """Seconds of each outer iteration from iteration_marks: the first from
    its after-GMM mark (its GMM step is skipped or timed apart) to its end,
    each later one from the end of the one before."""
    ends = [t for after, t in marks if not after]
    first = next(t for after, t in marks if after)
    return [b - a for a, b in zip([first] + ends[:-1], ends)]


def phase_multi_structure_path(counters, orders, icp_atlas):
    """run_full.py's three-structure atlas at full width: 10 frames of a
    spiral, a circle and a bar of 21,000-22,699 points each (about 65,536 a
    frame), drawn on the card (random_p "ridge", which becomes rff_cg above
    the pair limit, then a dense shoot), registered by icp_atlas with a GMM
    of 20 components fitted to each structure of frame 0, grid support
    (rho = 1) and 2 outer iterations.  Structure 0's and 1's padded rows lie
    inside the row axis.  Holds random_p's CG residual, the FE oracle, and
    each kernel of the path on its own inputs (hold_path_kernels)."""
    import torch
    from difficp_torch.examples import run_full
    from difficp_torch.models import lddmm
    from difficp_torch.ops import backend
    from difficp_torch.ops import kmin2 as k2
    from difficp_torch.ops import rhs_ext as re
    from difficp_torch.ops import rhs_self as rs

    reset(*counters.values(), orders)
    solves, solve = [], lddmm.kridge_solve_cg

    def recording(q, u, sigma, **kw):
        sol = solve(q, u, sigma, **kw)
        solves.append((q, u, sol, sigma, kw["alpha"]))
        return sol

    t0 = time.perf_counter()
    lddmm.kridge_solve_cg = recording
    try:
        frames = run_full.generate_multi_structure_frames(
            torch.Generator(device="cuda").manual_seed(0), k=MULTI_FRAMES,
            n_bounds=MULTI_N_BOUNDS)
    finally:
        lddmm.kridge_solve_cg = solve
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    setup_launches = {k: v for k, v in flat_counts(counters).items() if v}
    with torch.no_grad():
        # (K + alpha I) b = u, b the solution before its 1 / sqrt(lambda), in
        # float64 by the self forward's plain version (held), and with the
        # kernel's own float32 K b, as the CG's matvec computes it (printed:
        # the gap between the two is the matvec's rounding, not the CG's)
        residual, residual_kernel = 0.0, 0.0
        for q, u, b, sig, alpha in solves:
            q8, b8, u8 = q.double(), b.double(), u.double()
            ones = torch.ones_like(q[..., 0])
            kb = rs.rhs_self_fwd_reference(q8, b8, ones.double(), sig, False)[0]
            residual = max(residual, float((kb + alpha * b8 - u8).norm() / u8.norm()))
            kb = rs.rhs_self_fwd(q, b, ones, sig, False)[0].double()
            residual_kernel = max(residual_kernel,
                                  float((kb + alpha * b8 - u8).norm() / u8.norm()))
    n_solves = len(solves)
    del solves
    counts = [[int(a.shape[0]) for a in fr] for fr in frames]

    reset(*counters.values(), orders)
    torch.cuda.reset_peak_memory_stats()
    marks, fes, callback = iteration_marks()
    t1 = time.perf_counter()
    try:
        psr, _ = icp_atlas(
            frames, {"init_components": {"set": 0, "C": 20}, "optimize_weights": True},
            {"type": "diffeomorphic", "lambda_LDDMM": 2e2, "sigma_LDDMM": MULTI_SIGMA},
            {"support_LDDMM": {"scheme": "grid", "rho": 1.0}, "computversion": "pallas"},
            {"max_iterations": 2}, callback_function=callback, printstuff=False,
            device="cuda")
    finally:
        backend.set_backend(None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    flat = {k: v for k, v in flat_counts(counters).items() if k in ETA0_KERNELS}
    evals = flat["rhs_self_bwd"] / psr.lcfg.nt
    per_eval = {k: v / max(evals, 1) for k, v in flat.items() if k != "kmin2"}
    emit({"phase": "multi_structure_path", "frames": MULTI_FRAMES, "structures": psr.S,
          "points_per_structure": counts, "points_per_frame": [sum(c) for c in counts],
          "padded_width": int(psr.x0.shape[1]), "grid_M": int(psr.q0.shape[1]),
          "setup_seconds": setup, "setup_launches": setup_launches,
          "cg_solves": n_solves, "cg_residual": residual, "cg_residual_tol": TOL_CG_RESIDUAL,
          "cg_residual_kernel_matvec": residual_kernel,
          "registration_setup_seconds": next(t for a, t in marks if a) - t1,
          "seconds_per_outer_iteration": iteration_seconds(marks), "seconds": seconds,
          "FE_sequence": fes, "fe_increase_events": psr.fe_increase_events,
          "sigmas": [float(g.sigma) for g in psr.gmm], "launches": flat,
          "loss_grad_evals": evals, "launches_per_loss_grad": per_eval,
          "uncovered": psr.last_reg_stats["uncovered"].cpu().tolist(),
          "max_memory_allocated_bytes": peak})
    if not all(v > 0 for v in flat.values()):
        fail("multi_structure_path", f"a kernel of the path never launched: {flat}")
    if not residual <= TOL_CG_RESIDUAL:
        fail("multi_structure_path", f"random_p's CG residual {residual}")
    if not (all(map(math.isfinite, fes)) and monotone(fes) and psr.fe_increase_events == 0):
        fail("multi_structure_path", "free energy not finite or not monotone")
    if psr.S != 3 or not bool(torch.isfinite(psr.x1).all()):
        fail("multi_structure_path", "warped points are not finite")
    inner = psr.xmask[:, :psr.slices[-1][0]] == 0
    if not bool(inner.any()):
        fail("multi_structure_path", "no padded row inside the row axis")

    nx, m, d = psr.x0.shape[1], psr.q0.shape[1], psr.D
    a0 = psr.a0.detach()
    with torch.no_grad():
        _, traj = lddmm.shoot(psr.lcfg, psr.q0, a0, psr.x0, psr.qmask, psr.xmask,
                              save_traj=True)
    cov = [traj.x.reshape(-1, nx, d).contiguous(), traj.q.reshape(-1, m, d).contiguous(),
           psr.qmask.expand(traj.q.shape[:-1]).reshape(-1, m).contiguous()]
    del traj
    worst, _, _ = hold_path_kernels("check_multi_structure_path", "multi_structure", rs, re,
                                    k2, psr.x0, psr.xmask, psr.q0, a0, psr.qmask, cov,
                                    seed=7, sig=MULTI_SIGMA)
    del cov, psr
    torch.cuda.empty_cache()
    return flat, worst


def phase_affine_atlas_path(counters, icp_atlas):
    """The grid main path's frames (10 x 65,536 points) through icp_atlas
    with a GMM of 20 components fitted to frame 0, 3 outer iterations each
    for "rigid", "similarity" and "general_affine" (the EM over 655,360 x 20
    pairs, the closed-form fits batched over the frames); then AffinePSR.run(3)
    against 3 stepwise iterations for "similarity", FE within TOL_ROUTE_FE
    (tests/test_api.py:219-245)."""
    import torch
    from difficp_torch.models import affine, gmm
    from difficp_torch.models.psr import AffinePSR

    frames = grid_frames(10, 65536)
    reset(*counters.values())
    for reg_type in ("rigid", "similarity", "general_affine"):
        marks, fes, callback = iteration_marks()
        t0 = time.perf_counter()
        psr, evol = icp_atlas(frames, {"init_components": {"set": 0, "C": 20}},
                              {"type": reg_type}, optim_options={"max_iterations": 3},
                              callback_function=callback, printstuff=False, device="cuda")
        torch.cuda.synchronize()
        det = torch.linalg.det(psr.M.double())
        emit({"phase": "affine_atlas_path", "type": reg_type, "frames": 10, "n_points": 65536,
              "setup_seconds": next(t for a, t in marks if a) - t0,
              "seconds_per_outer_iteration": iteration_seconds(marks),
              "seconds": time.perf_counter() - t0, "FE_sequence": fes,
              "fe_increase_events": psr.fe_increase_events,
              "det_M_range": [float(det.min()), float(det.max())],
              "sigma": float(psr.gmm[0].sigma)})
        if not (len(evol["M"]) == len(fes) and all(map(math.isfinite, fes)) and monotone(fes)
                and psr.fe_increase_events == 0 and bool(torch.isfinite(psr.M).all())):
            fail("affine_atlas_path", f"{reg_type}: free energy or fit not finite or not monotone")

    st, cfg = gmm.fit(torch.as_tensor(frames[0], device="cuda"), 20,
                      torch.Generator(device="cuda").manual_seed(0))
    cfg = cfg._replace(optimize_mu=True, optimize_sigma=True, optimize_w=True)

    def build():
        psr = AffinePSR(frames, st, cfg, affine.AffineConfig(version="similarity"),
                        device="cuda")
        psr.printstuff = False
        return psr

    t0 = time.perf_counter()
    step = build()
    for _ in range(3):
        step.GMM_opt(max_iterations=10, tol=1e-3)
        step.Reg_opt()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fused = build()
    fused_fes = fused.run(3, max_em=10, em_tol=1e-3)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rel = abs(fused.FE - step.FE) / abs(step.FE)
    launches = {k: v for k, v in flat_counts(counters).items() if v}
    emit({"phase": "affine_fused_run", "type": "similarity", "FE_stepwise": step.FE,
          "FE_fused": fused.FE, "fused_FE_sequence": fused_fes.tolist(), "rel_diff": rel,
          "tol": TOL_ROUTE_FE, "stepwise_seconds": t1 - t0, "fused_seconds": t2 - t1,
          "fe_increase_events": [step.fe_increase_events, fused.fe_increase_events],
          "kernel_launches": launches})
    if rel > TOL_ROUTE_FE or step.fe_increase_events or fused.fe_increase_events:
        fail("affine_fused_run", "AffinePSR.run and its steps disagree or the FE rose")
    torch.cuda.empty_cache()


def phase_auto_lambda_path(counters, orders, icp_two_set):
    """icp_two_set with lambda_LDDMM = "auto" on two spiral frames of AUTO_N
    points: the calibration (a general-affine ICP with xB's points as GMM
    centroids, v2p's CG ridge solve, the dense Ralston shoots of its L-BFGS at
    AUTO_N^2 pairs: rows #1 and #4), then the registration on grid support,
    2 outer iterations.  Holds lambda finite and > 0, the FE oracle, rows #1
    and #4 on the calibration's own start (x, a0) against their float64
    plain versions (hold_self_kernels), and h0_ref = H(x, a0) and lambda
    within TOL_CALIB of float64 H and of l_ref over float64 H(x, p0) (l_ref
    comes from the affine ICP, which runs no kernel).
    Above the pair limit v2p's start is an unconverged CG (alpha = 1e-4;
    ROADMAP section 3), and the L-BFGS on the exponential loss takes no step
    from it (p0 == a0, printed as "lbfgs_moved"): lambda is then
    l_ref / H(x, a0), which only the forward kernel reaches; the backward
    kernel is held on the start itself."""
    import torch
    from difficp_torch.models import calibration, lddmm
    from difficp_torch.ops import rhs_self as rs

    xa, xb = grid_frames(2, AUTO_N)
    parts = {}
    orig = calibration.lambda_from_reference
    start_momenta, optimize = calibration.start_momenta, lddmm.optimize

    def recording_start(*args):
        parts["start"] = start_momenta(*args)
        return parts["start"]

    def recording_optimize(*args, **kw):
        res = optimize(*args, **kw)
        parts["p0"] = res.p0
        return res

    def recording(ref, sigma):
        # the start and the optimum of the calibration only (the
        # registration after it runs lddmm.optimize too)
        parts["ref"] = ref
        calibration.start_momenta, lddmm.optimize = recording_start, recording_optimize
        try:
            parts["out"] = orig(ref, sigma)
        finally:
            calibration.start_momenta, lddmm.optimize = start_momenta, optimize
        torch.cuda.synchronize()
        parts["end"] = time.perf_counter()
        parts["launches"] = {k: v for k, v in flat_counts(counters).items() if v}
        return parts["out"]

    reset(*counters.values(), orders)
    t0 = time.perf_counter()
    calibration.lambda_from_reference = recording
    try:
        psr, _ = icp_two_set(
            xa, xb, {"sigma": 0.1, "optimize_sigma": True, "outlier_weight": None},
            {"type": "diffeomorphic", "lambda_LDDMM": "auto", "sigma_LDDMM": 0.2},
            optim_options={"max_iterations": 2}, printstuff=False, device="cuda")
    finally:
        calibration.lambda_from_reference = orig
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lam, out, ref = psr.lcfg.lambd, parts["out"], parts["ref"]
    _, a0, _ = parts["start"]
    p0 = parts["p0"].detach()
    moved = not torch.equal(p0, a0)

    q = ref.x[None]
    mq = torch.ones_like(q[..., 0])
    worst, v8 = hold_self_kernels("check_auto_lambda_path", "auto_lambda", rs, q, a0, mq,
                                  rs.row_order(q, mq, 0.2), seed=11, sig=0.2)
    with torch.no_grad():
        a8, u8 = a0.double(), (ref.y - ref.x)[None].double()
        h0 = 0.5 * float((a8 * v8).sum())
        # v2p's ridge residual ||(K + alpha I) a0 - (y - x)|| / ||y - x||
        residual = float((v8 + 1e-4 * a8 - u8).norm() / u8.norm())
        deformation = h0
        if moved:
            p8 = p0.double()
            deformation = 0.5 * float((p8 * rs.rhs_self_fwd_reference(
                q.double(), p8, mq.double(), 0.2, False)[0]).sum())
    del v8, a8, u8
    rel_h0 = abs(out.h0_ref - h0) / abs(h0)
    lam64 = out.l_ref / deformation
    rel_lam = abs(out.lam - lam64) / abs(lam64)
    emit({"phase": "auto_lambda_path", "n_points": AUTO_N, "lambda": lam,
          "l_ref": out.l_ref, "h0_ref": out.h0_ref, "deformation": out.deformation,
          "lbfgs_moved": moved, "calibration_seconds": parts["end"] - t0, "seconds": seconds,
          "calibration_launches": parts["launches"], "FE": psr.FE,
          "fe_increase_events": psr.fe_increase_events, "grid_M": int(psr.q0.shape[1]),
          "float64": {"h0_ref": h0, "deformation": deformation, "lambda": lam64},
          "h0_ref_rel_diff": rel_h0, "lambda_rel_diff": rel_lam, "tol": TOL_CALIB,
          "v2p_cg_residual": residual})
    if not (math.isfinite(lam) and lam > 0 and math.isfinite(psr.FE)
            and psr.fe_increase_events == 0):
        fail("auto_lambda_path", f"lambda {lam} or the registration's FE is not sound")
    if not all(parts["launches"].get(k, 0) > 0 for k in ("rhs_self_fwd", "rhs_self_bwd")):
        fail("auto_lambda_path", f"the calibration did not run rows #1 and #4: "
                                 f"{parts['launches']}")
    if not (rel_h0 <= TOL_CALIB and rel_lam <= TOL_CALIB):
        fail("auto_lambda_path", "the calibration disagrees with float64")
    del psr
    torch.cuda.empty_cache()
    return parts["launches"], worst


def device_ms_total(fn, runs=3):
    """Device milliseconds per call of fn, all the kernels it launches summed:
    a torch.profiler trace of calls each followed by a synchronize and 50 ms
    of host sleep, its kernels cut into calls at the gaps (> 20 ms), the
    median over the last ``runs`` calls.  A trace can miss the kernels of its
    first milliseconds (device_ms): one with fewer than runs + 1 calls is
    taken again with twice the calls, up to three times; None if it still
    holds too few."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    n = runs + 2
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
                torch.cuda.synchronize()
                time.sleep(0.05)
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        calls, end = [], None
        for a, b in spans:
            if end is None or a - end > 20e3:
                calls.append(0.0)
            calls[-1] += b - a
            end = b if end is None else max(end, b)
        if len(calls) >= runs + 1:
            return statistics.median(c / 1e3 for c in calls[-runs:])
        n *= 2
    return None


def kred_calls():
    """The standard paths' kernel-sums as (label, x, y, d, grads): kred_scal(x,
    y, d) with gradients into the tensors named in ``grads`` ("x" for the
    first point argument, "y" where it is the same tensor, "d" the payload):
    the atlas's <fy, fx> on its 10 x 65,536 data frames against the template
    (frame 0, jittered a frame as if warped), its <fx, fx> (the cached
    constant, no gradient), and the two-set's <fy, fy> at 65,536^2 with a
    weights payload (dx + dy in the one tensor, and db, the template
    weights' gradient)."""
    import numpy as np
    import torch

    g = torch.Generator(device="cuda").manual_seed(17)
    x = torch.as_tensor(np.stack(grid_frames(STD_FRAMES, STD_N)), device="cuda")
    y = (x[:1] + 0.01 * torch.randn(x.shape, generator=g, device="cuda")).contiguous()
    wx = torch.full(x.shape[:-1], 1.0 / STD_N, device="cuda")
    y2 = x[1:2].contiguous()
    w2 = (torch.rand((1, STD_N), generator=g, device="cuda") + 0.5) / STD_N
    return [("standard atlas <fy, fx>", y, x, wx, ("x",)),
            ("standard atlas <fx, fx>", x, x, wx, ()),
            ("standard two-set <fy, fy>, weights", y2, y2, w2, ("x", "d"))]


def kred_run(ks, x, y, d, grads, cot):
    """kred_scal(x, y, d) (a KRed) and the gradients ``grads`` of <out, cot>."""
    import torch

    xs = x.detach().clone().requires_grad_("x" in grads)
    ys = xs if y is x else y
    ds = d.detach().clone().requires_grad_("d" in grads)
    out = ks.kred_scal(xs, ys, ds, STD_MODEL["sigma_data"])
    wrt = [t for name, t in (("x", xs), ("d", ds)) if name in grads]
    gs = torch.autograd.grad((out * cot).sum(), wrt) if wrt else ()
    return [out.detach(), *gs]


def phase_check_kred(ks):
    """KRed (ops/ksum.py), as kred_scal takes it on the standard paths, and
    mdivsum against their float64 plain versions (the same Functions with
    ksum's plain version in float64, on the same float32 inputs): values
    within TOL_FWD and gradients within TOL_BWD of their largest float64
    entry; with positive weights and payloads the values carry no
    cancellation, so that is the terms' scale; the data_distance they make
    up is printed against float64 too, relative to itself and to the sum of
    its terms.  mdivsum at the grid main path's shape (10 x 65,536 data
    points on their 380 grid support points), its value relative to the sum
    of its pair terms' magnitudes.  Then each call timed: the forward and
    the forward + backward with CUDA events (median of 5) and by device time
    (all its kernels), beside the same Functions on ksum's float32 plain
    version and the bound of their ksum calls (ksum_bound)."""
    import numpy as np
    import torch
    from difficp_torch.ops import ksum as ksm
    from difficp_torch.utils.point_sets import grid_support

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(19)
    worst, shapes = [0.0, 0.0], []
    sig = STD_MODEL["sigma_data"]
    for label, x, y, d, grads in kred_calls():
        nb, nx, dim = x.shape
        ny = y.shape[1]
        cot = torch.randn((nb, nx), generator=g, device="cuda")
        got = kred_run(ks, x, y, d, grads, cot)
        torch.cuda.synchronize()
        x64 = x.double()
        with plain_ksum(ks, torch.float64):
            ref = kred_run(ks, x64, x64 if y is x else y.double(), d.double(), grads,
                           cot.double())
        del x64
        names = ["value"] + [{"x": "dx + dy" if y is x else "dx", "d": "db"}[n] for n in grads]
        errs = {n: (rel_err(a, r), abs_err(a, r)) for n, a, r in zip(names, got, ref)}
        ok = all(e[0] <= (TOL_FWD if n == "value" else TOL_BWD) for n, e in errs.items())
        # the inner product <f, f'> = sum_i d'_i out_i it makes up
        wgt = x.new_full((nb, nx), 1.0 / nx) if y is not x else d
        ip, ip64 = (wgt * got[0]).sum(-1), (wgt.double() * ref[0]).sum(-1)
        emit({"phase": "check_kred", "call": label, "frames": nb, "Nx": nx, "Ny": ny,
              "rel_err": {n: e[0] for n, e in errs.items()},
              "abs_err": {n: e[1] for n, e in errs.items()},
              "inner_product_rel_err": float(((ip.double() - ip64).abs() / ip64.abs()).max()),
              "tol": [TOL_FWD, TOL_BWD], "ok": ok})
        if not ok:
            fail("check_kred", f"KRed disagrees with its plain version at {label}")
        for e in errs.values():
            worst = [max(worst[0], e[0]), max(worst[1], e[1])]
        del got, ref
        torch.cuda.empty_cache()

        # timing: forward alone and forward + backward
        def fwd():
            with torch.no_grad():
                ks.kred_scal(x, y, d, sig)

        def fwd_bwd():
            kred_run(ks, x, y, d, grads, cot)

        rec = {"call": label, "frames": nb, "Nx": nx, "Ny": ny, "library_ms": None}
        # a self sum (x is y) takes each unordered pair once at least
        npairs = nb * (nx * (nx - 1) / 2 if y is x else nx * ny)
        # the backward's ksum calls: the forward direction for dx, the reverse
        # one for dy (x is y) and db
        bwd_calls = ("x" in grads) + ("d" in grads or (y is x and "x" in grads))
        runs = [("forward", fwd, [1])]
        if grads:
            runs.append(("forward_backward", fwd_bwd, [1] + [1 + dim] * bwd_calls))
        for key, fn, ncalls in runs:
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            ms = cuda_ms(fn, 5)
            dev = device_ms_total(fn)
            with plain_ksum(ks, torch.float32):
                fn()
                torch.cuda.synchronize()
                plain_ms = cuda_ms(fn, 1)
            bounds = [ksum_bound(npairs, dim, c, 4.0 * nb * (nx * dim + ny * dim + c * ny
                                                            + c * nx), self_pairs=y is x)
                      for c in ncalls]
            rec[key] = {"ms": ms, "device_ms": dev, "plain_ms": plain_ms,
                        "ksum_calls": len(ncalls), "cols": ncalls,
                        "bound_ms": sum(b["bound_ms"] for b in bounds),
                        "bound_by": "bytes" if all(b["bound_by"] == "bytes" for b in bounds)
                        else "operations",
                        "bound_terms": [b["bound_term"] for b in bounds]}
        emit({"phase": "timing", "kernel": "ksum", "op": "KRed", **rec})
        key = runs[-1][0]
        fb = rec[key]
        shapes.append(dict(call=f"{label} (KRed {key.replace('_', ' + ')})", frames=nb, Nx=nx,
                           Ny=ny,
                           cols=fb["cols"], ms=fb["ms"], device_ms=fb["device_ms"],
                           plain_ms=fb["plain_ms"], bound_ms=fb["bound_ms"],
                           bound_by=fb["bound_by"], library_ms=None))

    # mdivsum at the grid main path's shape
    x = torch.as_tensor(np.stack(grid_frames(STD_FRAMES, STD_N)), device="cuda")
    q1 = grid_support(x[0].cpu().numpy(), GRID_SIGMA)
    q = torch.as_tensor(q1, device="cuda").expand(STD_FRAMES, *q1.shape).contiguous()
    p = 0.05 * torch.randn(q.shape, generator=g, device="cuda")
    mq = torch.ones(q.shape[:-1], device="cuda")
    mx = (torch.rand(x.shape[:-1], generator=g, device="cuda") > 0.1).float()
    cot = torch.randn((STD_FRAMES,), generator=g, device="cuda")

    def mdiv(xx, qq, pp, mqq, mxx, c):
        xs, qs, ps = (t.detach().clone().requires_grad_(True) for t in (xx, qq, pp))
        out = ksm.mdivsum(xs, qs, ps, GRID_SIGMA, 0.0, mqq, mxx)
        return [out.detach(), *torch.autograd.grad((out * c).sum(), [xs, qs, ps])]

    got = mdiv(x, q, p, mq, mx, cot)
    with plain_ksum(ks, torch.float64):
        ref = mdiv(x.double(), q.double(), p.double(), mq.double(), mx.double(), cot.double())
    # the value against the sum of its pair terms' magnitudes
    # sum_ij k m_i m_j u |p_j.(x_i - q_j)|, in float64, frames and rows in chunks
    u = 1.0 / GRID_SIGMA**2
    terms = torch.zeros(STD_FRAMES, dtype=torch.float64, device="cuda")
    x8, q8, p8, mx8 = x.double(), q.double(), p.double(), mx.double()
    for lo in range(0, STD_N, 4096):
        dlt = x8[:, lo:lo + 4096, None, :] - q8[:, None, :, :]
        k = torch.exp(-0.5 * u * (dlt * dlt).sum(-1)) * mx8[:, lo:lo + 4096, None]
        terms += (k * u * (dlt * p8[:, None, :, :]).sum(-1).abs()).sum((-2, -1))
    val_err = float(((got[0].double() - ref[0]).abs() / terms).max())
    errs = {"value": val_err, **{n: rel_err(a, r) for n, a, r in zip(("dx", "dq", "dp"),
                                                                       got[1:], ref[1:])}}
    ok = errs["value"] <= TOL_FWD and all(errs[n] <= TOL_BWD for n in ("dx", "dq", "dp"))
    emit({"phase": "check_kred", "call": "mdivsum, grid main shape", "frames": STD_FRAMES,
          "N": STD_N, "M": int(q.shape[1]), "rel_err": errs,
          "value_rel_err_to_itself": float(((got[0].double() - ref[0]).abs()
                                            / ref[0].abs()).max()),
          "tol": [TOL_FWD, TOL_BWD], "ok": ok})
    if not ok:
        fail("check_kred", "mdivsum disagrees with its plain version")
    worst = [max(worst[0], *errs.values()),
             max(worst[1], *(abs_err(a, r) for a, r in zip(got[1:], ref[1:])))]
    del got, ref, x8, q8, p8, mx8
    torch.cuda.empty_cache()
    emit({"phase": "check_kred_done", "seconds": time.perf_counter() - t0})
    return worst, shapes


def std_marks():
    """A callback for standard_atlas / standard_two_set that records the
    card's time (synchronized) and E at each call, with its flag (True: the
    atlas's mark before Reg_opt)."""
    import torch

    marks = []

    def callback(psr, before_reg):
        torch.cuda.synchronize()
        marks.append((before_reg, time.perf_counter(), psr.E))
    return marks, callback


def std_launches(counters, nt):
    """The launches of the standard path's kernels, the loss+grad evaluations
    (each runs one backward of nt steps: rhs_ext_bwd_dx on external points,
    else rhs_self_bwd) and the launches per evaluation."""
    names = ETA0_KERNELS[:-1] + ("ksum",)
    flat = {k: v for k, v in flat_counts(counters).items() if k in names}
    evals = (flat["rhs_ext_bwd_dx"] or flat["rhs_self_bwd"]) / nt
    return flat, evals, {k: v / max(evals, 1) for k, v in flat.items()}


def std_data_terms(psr, y1):
    """The two y-dependent terms of the path's data loss, per frame:
    sum_s <fy, fy> / noise_s^2 and sum_s 2 <fy, fx> / noise_s^2 (no template
    weights), through backend.kred_scal in y1's dtype."""
    import torch
    from difficp_torch.ops import backend

    yy = yx = 0.0
    for s, (ylo, yhi, xlo, xhi) in enumerate(psr.slices):
        y = y1[:, ylo:yhi]
        x, mx = psr.x[:, xlo:xhi].to(y1.dtype), psr.xmask[:, xlo:xhi].to(y1.dtype)
        wx = mx / mx.sum(-1, keepdim=True)
        wy = torch.full(y.shape[:-1], 1.0 / y.shape[1], dtype=y1.dtype, device=y1.device)
        yy = yy + (wy * backend.kred_scal(y, y, wy, psr.data_sigma)).sum(-1) / psr.noise2[s]
        yx = yx + 2.0 * (wy * backend.kred_scal(y, x, wx, psr.data_sigma)).sum(-1) \
            / psr.noise2[s]
    return yy, yx


def hold_kred_on_path(phase, path, ks, psr):
    """The path's data-loss kernel-sums on its own end state: the dataloss
    Reg_opt descends (data_distance with skip_xx, <fy, fy> - 2 <fy, fx>) of
    every frame and its gradient in the warped templates, through the
    kernels, against its two terms computed with ksum's float64 plain
    version, at the terms' scale: the loss within TOL_FWD of |<fy, fy>| +
    2 |<fy, fx>|, the gradient within TOL_BWD of the larger of the two
    terms' largest gradient entries.  Near the fit the two terms cancel (the
    error relative to the loss itself and to the largest entry of its
    gradient is printed beside).  Returns the worst errors."""
    import torch
    from difficp_torch.models.psr_standard import _frame_rkhs_dataloss

    y1 = psr.y1.detach().clone().requires_grad_(True)
    loss = _frame_rkhs_dataloss(psr.x, psr.xmask, None, psr.noise2, psr.data_sigma,
                                psr.slices)(y1)
    (grad,) = torch.autograd.grad(loss.sum(), y1)
    loss = loss.detach()
    y8 = psr.y1.detach().double().requires_grad_(True)
    with plain_ksum(ks, torch.float64):
        yy, yx = std_data_terms(psr, y8)
        g_yy, = torch.autograd.grad(yy.sum(), y8, retain_graph=True)
        g_yx, = torch.autograd.grad(yx.sum(), y8)
    loss64, grad64 = (yy - yx).detach(), g_yy - g_yx
    terms = (yy.abs() + yx.abs()).detach()
    rel_loss = float(((loss.double() - loss64).abs() / terms).max())
    gscale = max(float(g_yy.abs().max()), float(g_yx.abs().max()))
    rel_grad = abs_err(grad, grad64) / gscale
    ok = rel_loss <= TOL_FWD and rel_grad <= TOL_BWD
    emit({"phase": phase, "kernel": "ksum", "path": path, "loss": loss.tolist(),
          "loss_float64": loss64.tolist(), "loss_rel_err_to_terms": rel_loss,
          "loss_rel_err_to_itself": float(((loss.double() - loss64).abs()
                                           / loss64.abs()).max()),
          "grad_rel_err_to_terms": rel_grad, "grad_rel_err_to_itself": rel_err(grad, grad64),
          "terms_grad_scale_over_grad": gscale / float(grad64.abs().max()),
          "tol": [TOL_FWD, TOL_BWD], "ok": ok})
    if not ok:
        fail(phase, f"the {path} path's data loss or its gradient is not within tolerance "
                    "of float64 at the terms' scale")
    del grad, grad64, g_yy, g_yx, y8
    torch.cuda.empty_cache()
    return [max(rel_loss, rel_grad), abs_err(loss, loss64)]


def phase_standard_atlas_path(counters, orders, ks, standard_atlas):
    """standard_atlas on the grid main path's frames (10 x 65,536 points),
    initial_template=0 (a template of 65,536 points), the API's default grid
    support at sigma_LDDMM = GRID_SIGMA (~380 support points, so the ext
    shoot takes the kernels), sigma_data 0.1, noise_std 0.2, STD_ITERS
    iterations (each a lockstep Reg_opt and a Template_opt).  Holds the
    energy oracle (grid support re-projects nothing: no increase), then
    every kernel of the path on its own end state against float64: the
    support's self kernels and the ext kernels (hold_path_kernels: the
    template as the external points, no kmin2 on this path) and the data
    loss's kernel-sums (hold_kred_on_path)."""
    import torch
    from difficp_torch.ops import kmin2 as k2
    from difficp_torch.ops import rhs_ext as re
    from difficp_torch.ops import rhs_self as rs

    frames = grid_frames(STD_FRAMES, STD_N)
    reset(*counters.values(), orders)
    torch.cuda.reset_peak_memory_stats()
    marks, callback = std_marks()
    t0 = time.perf_counter()
    psr, evol = standard_atlas(
        frames, initial_template=0,
        model_parameters={**STD_MODEL, "sigma_LDDMM": GRID_SIGMA},
        optim_options={"max_iterations": STD_ITERS}, callback_function=callback,
        printstuff=False, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    flat, evals, per_eval = std_launches(counters, psr.lcfg.nt)
    starts = [t for before, t, _ in marks if before]
    es = [e for before, _, e in marks if before] + [psr.E]
    emit({"phase": "standard_atlas_path", "frames": STD_FRAMES, "n_points": STD_N,
          "template_points": int(psr.ny_tot), "grid_M": int(psr.q0.shape[0]),
          "sigma_lddmm": GRID_SIGMA, **STD_MODEL, "setup_seconds": starts[0] - t0,
          "seconds_per_outer_iteration": [b - a for a, b in zip(starts, starts[1:] + [t1])],
          "seconds": t1 - t0, "E_sequence": es, "e_increase_events": psr.e_increase_events,
          "launches": flat, "loss_grad_evals": evals, "launches_per_loss_grad": per_eval,
          "max_memory_allocated_bytes": peak})
    if not (flat["ksum"] > 0 and flat["rhs_ext_fwd"] > 0 and flat["rhs_ext_bwd_dx"] > 0
            and flat["rhs_ext_bwd_dqdp"] > 0):
        fail("standard_atlas_path", f"a kernel of the path never launched: {flat}")
    if not (all(map(math.isfinite, es)) and psr.e_increase_events == 0 and es[-1] < es[0]):
        fail("standard_atlas_path", f"energy not finite, rising or not decreasing: {es}")
    if not (len(evol["y0"]) == STD_ITERS and bool(torch.isfinite(psr.y1).all())):
        fail("standard_atlas_path", "warped templates not finite")

    x = psr._frames(psr.ally0)
    q = psr._frames(psr.q0)
    mx = torch.ones(x.shape[:-1], device="cuda")
    mq = torch.ones(q.shape[:-1], device="cuda")
    worst, _, _ = hold_path_kernels("check_standard_atlas_path", "standard_atlas", rs, re, k2,
                                    x, mx, q, psr.a0.detach(), mq, None, seed=23)
    worst["ksum"] = hold_kred_on_path("check_standard_atlas_path", "standard_atlas", ks, psr)
    del psr, x, q
    torch.cuda.empty_cache()
    return flat, worst


def phase_standard_two_set_path(counters, orders, ks, standard_two_set):
    """standard_two_set of frame 0 onto frame 1 of grid_frames(2, 65,536)
    with dense support (the template of 65,536 points is the support: the
    self kernels at 65,536^2), sigma_LDDMM 0.1, sigma_data 0.1, noise_std
    0.2, STD_ITERS iterations of nmax_per_iter 4.  Holds the energy oracle,
    the self kernels on the path's own end state (hold_self_kernels) and its
    data loss's kernel-sums (hold_kred_on_path); then a "rigid" standard
    two-set on the same pair, STD_ITERS iterations: M, t, seconds."""
    import torch
    from difficp_torch.ops import rhs_self as rs

    from difficp_torch.models.psr_standard import data_distance

    xa, xb = grid_frames(2, STD_N)
    with torch.no_grad():
        e_start = float(data_distance(torch.as_tensor(xb, device="cuda"),
                                      torch.as_tensor(xa, device="cuda"),
                                      STD_MODEL["sigma_data"])) / STD_MODEL["noise_std"] ** 2
    reset(*counters.values(), orders)
    torch.cuda.reset_peak_memory_stats()
    marks, callback = std_marks()
    t0 = time.perf_counter()
    psr, _ = standard_two_set(
        xa, xb, {"type": "diffeomorphic", **STD_MODEL, "sigma_LDDMM": SIGMA},
        {"support_LDDMM": {"scheme": "dense"}},
        {"max_iterations": STD_ITERS, "nmax_per_iter": 4}, printstuff=False,
        callback_function=callback, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    flat, evals, per_eval = std_launches(counters, psr.lcfg.nt)
    ends = [t for _, t, _ in marks]
    es = [e for _, _, e in marks]
    emit({"phase": "standard_two_set_path", "n_points": STD_N, "support": "dense",
          "sigma_lddmm": SIGMA, **STD_MODEL,
          "seconds_per_outer_iteration": [b - a for a, b in zip([t0] + ends, ends)],
          "seconds": t1 - t0, "E_start": e_start, "E_sequence": es,
          "e_increase_events": psr.e_increase_events, "launches": flat, "loss_grad_evals": evals,
          "launches_per_loss_grad": per_eval, "max_memory_allocated_bytes": peak})
    if not (flat["ksum"] > 0 and flat["rhs_self_fwd"] > 0 and flat["rhs_self_bwd"] > 0):
        fail("standard_two_set_path", f"a kernel of the path never launched: {flat}")
    if not (all(map(math.isfinite, es)) and psr.e_increase_events == 0 and es[-1] < e_start
            and bool(torch.isfinite(psr.y1).all())):
        fail("standard_two_set_path", f"energy not finite, rising or not below the start "
                                      f"{e_start}: {es}")
    q = psr._frames(psr.q0)
    mq = torch.ones(q.shape[:-1], device="cuda")
    worst, _ = hold_self_kernels("check_standard_two_set_path", "standard_two_set", rs, q,
                                 psr.a0.detach(), mq, rs.row_order(q, mq, SIGMA), seed=31,
                                 sig=SIGMA)
    worst["ksum"] = hold_kred_on_path("check_standard_two_set_path", "standard_two_set", ks,
                                      psr)
    del psr, q
    torch.cuda.empty_cache()

    reset(*counters.values())
    t2 = time.perf_counter()
    rigid, _ = standard_two_set(xa, xb, {"type": "rigid", "sigma_data": STD_MODEL["sigma_data"]},
                                optim_options={"max_iterations": STD_ITERS, "nmax_per_iter": 4},
                                printstuff=False, device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "standard_two_set_rigid", "n_points": STD_N, "M": rigid.M[0].tolist(),
          "t": rigid.t[0].tolist(), "E": rigid.E, "e_increase_events": rigid.e_increase_events,
          "seconds": time.perf_counter() - t2,
          "launches": {k: v for k, v in flat_counts(counters).items() if v}})
    if not (math.isfinite(rigid.E) and bool(torch.isfinite(rigid.M).all())):
        fail("standard_two_set_rigid", "the rigid fit is not finite")
    return flat, worst


def phase_standard_route_agreement(backend, standard_atlas):
    """The standard atlas at 3 frames of STD_ROUTE_N points (grid support at
    GRID_SIGMA) forced onto the kernel route and then onto the dense route:
    the E sequences within TOL_ROUTE_FE, entry by entry."""
    import torch

    t0 = time.perf_counter()
    frames = grid_frames(3, STD_ROUTE_N)
    seqs = {}
    for mode, cv in (("kernel", "pallas"), ("dense", "dense")):
        marks, callback = std_marks()
        try:
            psr, _ = standard_atlas(
                frames, initial_template=0,
                model_parameters={**STD_MODEL, "sigma_LDDMM": GRID_SIGMA},
                numerical_options={"computversion": cv}, optim_options={"max_iterations": 2},
                callback_function=callback, printstuff=False, device="cuda")
            torch.cuda.synchronize()
        finally:
            backend.set_backend(None)
        seqs[mode] = [e for before, _, e in marks if before] + [psr.E]
    rel = rel_diff_fes(seqs["kernel"], seqs["dense"])
    emit({"phase": "standard_route_agreement", "frames": 3, "n_points": STD_ROUTE_N,
          "E_kernel": seqs["kernel"], "E_dense": seqs["dense"], "rel_diff": rel,
          "tol": TOL_ROUTE_FE, "seconds": time.perf_counter() - t0})
    if rel > TOL_ROUTE_FE:
        fail("standard_route_agreement", "kernel and dense routes disagree")


# the host-offload atlas, the frame-parallel atlas step and the blockwise
# route: the grid main path's problem at 40 frames streamed to the card in
# chunks of 10, and at 10 frames in chunks of 5 against DiffPSR holding all
# 10 (FE within TOL_ROUTE_FE, the warped points at tests/test_offload.py's
# bars, rtol 5e-2 / atol 5e-3); the offload's peak device memory at most
# OFFLOAD_PEAK_RATIO times that DiffPSR's (it holds one chunk of frames as
# DiffPSR holds its frames); the blockwise route's loss+grad at 65,536 dense
# points under BLOCKWISE_PEAK_BYTES (one 1,024-column tile's (M, tile, D)
# float32 temporaries are 0.54 GB there)
OFFLOAD_FRAMES = 40
OFFLOAD_CHUNK = 10
OFFLOAD_AGREE = (10, 5)  # frames, chunk
OFFLOAD_ITERS = 1  # outer iterations of the offload atlas path and agreement
OFFLOAD_PEAK_RATIO = 1.25
TOL_X1 = (5e-2, 5e-3)  # rtol, atol
BLOCKWISE_PEAK_BYTES = 8 * 2**30


def eta0_launches(counters, nt):
    """The eta = 0 kernels' launches of a run, its loss+grad evaluations (one
    self backward a step) and the launches per evaluation."""
    flat = {key: v for key, v in flat_counts(counters).items() if key in ETA0_KERNELS}
    evals = flat["rhs_self_bwd"] / nt
    return flat, evals, {key: v / evals for key, v in flat.items()} if evals else {}


def x1_agreement(x1, ref):
    """|x1 - ref| / (atol + rtol |ref|) at TOL_X1, at most 1 where the warped
    points agree at tests/test_offload.py's bars: its largest value, that of
    each frame and the number of coordinates above 1."""
    rtol, atol = TOL_X1
    ref = ref.double()
    r = ((x1.double() - ref).abs() / (atol + rtol * ref.abs())).flatten(1)
    return {"worst_over_tol": float(r.max()), "frames_worst": r.amax(1).tolist(),
            "coordinates_over_tol": int((r > 1).sum())}


def phase_offload_atlas_path(counters, orders):
    """HostOffloadAtlas on the grid main path's problem at OFFLOAD_FRAMES
    frames of 65,536 points, grid support (rho = 1), chunks of
    OFFLOAD_CHUNK frames, run(1) at GRID_RUN's budgets: set-up and seconds
    an outer iteration, the FE sequence, the grid's M, launches a loss+grad,
    host-device bytes an outer iteration and the peak device memory."""
    import torch
    from difficp_torch.models.offload import HostOffloadAtlas

    k, n = OFFLOAD_FRAMES, 65536
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x, state, gcfg, lcfg = grid_problem(k, n)
    atlas = HostOffloadAtlas(x, state, gcfg, lcfg, chunk_frames=OFFLOAD_CHUNK, device="cuda")
    atlas.set_support_scheme("grid", rho=1.0)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    reset(*counters.values(), orders)
    fes, iter_s, h2d, d2h = [], [], [], []
    for _ in range(OFFLOAD_ITERS):
        b_up, b_down = atlas.bytes_h2d, atlas.bytes_d2h
        t1 = time.perf_counter()
        fes += [float(f) for f in atlas.run(1, **GRID_RUN)]
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t1)
        h2d.append(atlas.bytes_h2d - b_up)
        d2h.append(atlas.bytes_d2h - b_down)
    flat, evals, per_eval = eta0_launches(counters, lcfg.nt)
    peak = torch.cuda.max_memory_allocated()
    x1 = atlas.x1[:k]
    rec = {"phase": "offload_atlas_path", "frames": k, "n_points": n,
           "chunk_frames": OFFLOAD_CHUNK, "grid_M": int(atlas.q0.shape[1]),
           "sigma_lddmm": GRID_SIGMA, "setup_seconds": setup,
           "seconds_per_outer_iteration": iter_s, "FE_sequence": fes,
           "fe_increase_events": atlas.fe_increase_events,
           "host_to_device_bytes_per_outer_iteration": h2d,
           "device_to_host_bytes_per_outer_iteration": d2h, "launches": flat,
           "loss_grad_evals": evals, "launches_per_loss_grad": per_eval,
           "row_orders": orders["row_order"], "max_memory_allocated_bytes": peak,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if not all(flat[key] > 0 for key in ETA0_KERNELS if key != "kmin2"):
        fail("offload_atlas_path", f"a kernel of the path never launched: {flat}")
    if flat["kmin2"]:
        fail("offload_atlas_path", "the offload atlas ran a coverage pass")
    if not (all(map(math.isfinite, fes)) and monotone(fes) and atlas.fe_increase_events == 0):
        fail("offload_atlas_path", f"free energy not finite or not monotone: {fes}")
    if not bool(torch.isfinite(x1).all()):
        fail("offload_atlas_path", "warped points not finite")
    return rec


def phase_offload_agreement(counters, offload_peak):
    """The grid main path's problem at 10 frames, em_tol = 0 and GRID_RUN's
    other budgets, one outer iteration: HostOffloadAtlas in chunks of 5
    against DiffPSR with all 10 frames on the card (GMM_opt then Reg_opt,
    the latter with its coverage pass): FE within TOL_ROUTE_FE, warped
    points at TOL_X1 (a second iteration, whose points were only printed,
    is no longer run: there DiffPSR with its Reg_opt in chunks of 5 frames,
    the same work batched otherwise, already differs from DiffPSR by more
    than TOL_X1 allows); both peaks, and offload_atlas_path's peak
    (``offload_peak``, 40 frames in chunks of 10) at most
    OFFLOAD_PEAK_RATIO times this DiffPSR's."""
    import torch
    from difficp_torch.models.offload import HostOffloadAtlas
    from difficp_torch.models.psr import DiffPSR

    (k, chunk), n = OFFLOAD_AGREE, 65536
    run_kw = dict(GRID_RUN, em_tol=0.0)
    x, state, gcfg, lcfg = grid_problem(k, n)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    atlas = HostOffloadAtlas(x, state, gcfg, lcfg, chunk_frames=chunk, device="cuda")
    atlas.set_support_scheme("grid", rho=1.0)
    fes_off, x1_off = [], []
    for _ in range(OFFLOAD_ITERS):
        fes_off += [float(f) for f in atlas.run(1, **run_kw)]
        x1_off.append(atlas.x1[:k].cuda())
    torch.cuda.synchronize()
    off_s = time.perf_counter() - t0
    off_peak = torch.cuda.max_memory_allocated()
    off_events = atlas.fe_increase_events
    del atlas
    torch.cuda.empty_cache()

    # DiffPSR twice: with all 10 frames in one lockstep Reg_opt (its default,
    # held against), and with Reg_opt(frame_chunk=chunk), the offload's lanes
    # a call, whose kernels cut their work as for the offload's chunks: the
    # two DiffPSR runs apart measure how far the optimizer carries the
    # rounding of another batching
    fes_psr, x1_psr, events, psr_s, psr_peak = {}, {}, {}, {}, {}
    for mode, fc in (("all", None), ("chunked", chunk)):
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        psr = DiffPSR(x, state, gcfg, lcfg, device="cuda")
        psr.printstuff = False
        psr.set_support_scheme("grid", rho=1.0)
        reset(*counters.values())
        fes_psr[mode], x1_psr[mode] = [], []
        for _ in range(OFFLOAD_ITERS):
            psr.GMM_opt(max_iterations=run_kw["max_em"], tol=0.0)
            psr.Reg_opt(tol=run_kw["reg_tol"], nmax=run_kw["reg_nmax"],
                        inner=run_kw["reg_inner"], ls_steps=run_kw["reg_ls"], frame_chunk=fc)
            fes_psr[mode].append(psr.FE)
            x1_psr[mode].append(psr.x1)
        torch.cuda.synchronize()
        psr_s[mode] = time.perf_counter() - t1
        psr_peak[mode] = torch.cuda.max_memory_allocated()
        events[mode] = psr.fe_increase_events
        if mode == "all":
            flat, evals, _ = eta0_launches(counters, lcfg.nt)
        del psr
        torch.cuda.empty_cache()
    fe_rel = [abs(a - b) / abs(b) for fes in fes_psr.values() for a, b in zip(fes_off, fes)]
    x1_agree = {mode: [x1_agreement(a, b) for a, b in zip(x1_off, x1_psr[mode])]
                for mode in x1_psr}
    x1_agree["diffpsr_chunked_vs_all"] = [x1_agreement(a, b) for a, b in
                                          zip(x1_psr["chunked"], x1_psr["all"])]
    x1_worst = x1_agree["all"][0]["worst_over_tol"]
    ratio = offload_peak / psr_peak["all"]
    rec = {"phase": "offload_agreement", "frames": k, "n_points": n, "chunk_frames": chunk,
           "FE_offload": fes_off, "FE_diffpsr": fes_psr, "FE_rel_diff": fe_rel,
           "tol": TOL_ROUTE_FE, "x1_agreement_by_iteration": x1_agree, "x1_tol": TOL_X1,
           "fe_increase_events": [off_events, events],
           "offload_seconds": off_s, "diffpsr_seconds": psr_s,
           "offload_max_memory_allocated_bytes": off_peak,
           "diffpsr_max_memory_allocated_bytes": psr_peak,
           "offload_atlas_path_peak_bytes": offload_peak, "peak_ratio": ratio,
           "peak_ratio_limit": OFFLOAD_PEAK_RATIO, "diffpsr_launches": flat,
           "diffpsr_loss_grad_evals": evals}
    emit(rec)
    if off_events or any(events.values()):
        fail("offload_agreement", "a free-energy increase")
    if max(fe_rel) > TOL_ROUTE_FE:
        fail("offload_agreement", f"offload FE {fes_off} against DiffPSR's {fes_psr}")
    if not x1_worst <= 1.0:
        fail("offload_agreement", "warped points after the first outer iteration differ: "
                                  f"{x1_worst} of the tolerance")
    if ratio > OFFLOAD_PEAK_RATIO:
        fail("offload_agreement", f"the offload's peak is {ratio} times DiffPSR's")
    return rec


def phase_atlas_step_path(counters):
    """make_atlas_train_step at world size 1 over NCCL on the grid main
    path's problem at 10 frames of 65,536 points, the data as external
    points of the grid (q0 the grid of all frames, for every frame),
    RING_STEP's budgets: 3 steps threading the step sizes, then 3 more with
    the curvature memory carried; the first step's FE against the
    single-device alternation (em_targets, then lddmm.optimize over all
    frames) within TOL_ROUTE_FE; both FE sequences monotone."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from difficp_torch.models import lddmm
    from difficp_torch.parallel import (frame_range, init_distributed, make_atlas_train_step,
                                        zero_atlas_memory)
    from difficp_torch.utils.io import pad_frames
    from difficp_torch.utils.point_sets import grid_support

    k, n = 10, 65536
    t0 = time.perf_counter()
    x, state, gcfg, lcfg = grid_problem(k, n)
    pf = pad_frames(x, "cuda")
    pts = grid_support(np.concatenate(x), GRID_SIGMA)
    q0 = torch.as_tensor(pts, device="cuda").expand(k, *pts.shape).contiguous()
    qmask = torch.ones(q0.shape[:-1], device="cuda")
    budgets = dict(em_iters=RING_STEP["em_iters"], reg_nmax=RING_STEP["reg_nmax"],
                   tol=RING_STEP["tol"], reg_inner=RING_STEP["reg_inner"],
                   reg_ls=RING_STEP["reg_ls"], use_ext=True)
    group, size, _ = init_distributed("cuda")
    try:
        backend_name = dist.get_backend(group)
        fr = frame_range(k, group)
        x0, xm, q0r, qmr = (t[fr].contiguous() for t in (pf.x, pf.mask, q0, qmask))
        step = make_atlas_train_step(gcfg, lcfg, group, **budgets)
        step_mem = make_atlas_train_step(gcfg, lcfg, group, carry_memory=True, **budgets)
        torch.cuda.synchronize()
        reset(*counters.values())
        torch.cuda.reset_peak_memory_stats()
        st, a0, x1, al = state, torch.zeros_like(q0r), x0, torch.zeros(x0.shape[0], device="cuda")
        fes, fes_mem, step_s = [], [], []
        mem = None
        for i in range(6):
            t1 = time.perf_counter()
            if i < 3:
                out = step(st, q0r, a0, x0, x1, qmr, xm, al)
            else:
                mem = zero_atlas_memory(a0) if mem is None else mem
                out = step_mem(st, q0r, a0, x0, x1, qmr, xm, al, mem)
                mem = out.memory
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            st, a0, x1, al = out.gmm, out.a0, out.x1, out.alpha
            (fes if i < 3 else fes_mem).append(float(out.fe))
        flat, evals, per_eval = eta0_launches(counters, lcfg.nt)
        peak = torch.cuda.max_memory_allocated()
    finally:
        dist.destroy_process_group()

    # the first step through the single-device alternation
    st1, y, cfe, ptw = em_targets(gcfg, state, pf.x.reshape(-1, 2), pf.mask.reshape(-1),
                                  RING_STEP["em_iters"])
    y, ptw, sig2 = y.reshape(pf.x.shape), ptw.reshape(pf.mask.shape), st1.sigma ** 2

    def dataloss(pts_):
        return ((pf.mask * ptw)[..., None] * (pts_ - y) ** 2 / (2.0 * sig2)).sum((-2, -1))

    res = lddmm.optimize(lcfg, dataloss, q0, torch.zeros_like(q0), pf.x, qmask, pf.mask,
                         nmax=RING_STEP["reg_nmax"], tol=RING_STEP["tol"],
                         inner=RING_STEP["reg_inner"], max_linesearch_steps=RING_STEP["reg_ls"])
    twin = float(cfe + res.trajl.sum() + res.datal.sum())
    rel = abs(fes[0] - twin) / abs(twin)
    rec = {"phase": "atlas_step_path", "frames": k, "n_points": n, "world_size": size,
           "backend": backend_name, "grid_M": int(q0.shape[1]), **RING_STEP,
           "FE_sequence": fes, "FE_sequence_carry_memory": fes_mem,
           "alternation_FE": twin, "FE_rel_diff": rel, "tol_fe": TOL_ROUTE_FE,
           "seconds_per_step": step_s, "launches": flat, "loss_grad_evals": evals,
           "launches_per_loss_grad": per_eval, "max_memory_allocated_bytes": peak,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if not all(flat[key] > 0 for key in ETA0_KERNELS if key != "kmin2"):
        fail("atlas_step_path", f"a kernel of the path never launched: {flat}")
    if not (all(map(math.isfinite, fes + fes_mem)) and monotone(fes) and monotone(fes_mem)):
        fail("atlas_step_path", f"free energies not finite or not monotone: {fes}, {fes_mem}")
    if rel > TOL_ROUTE_FE:
        fail("atlas_step_path", f"the first step's FE {fes[0]} against the alternation's {twin}")
    if x1.shape != pf.x.shape or not bool(torch.isfinite(x1).all()):
        fail("atlas_step_path", "warped points have the wrong shape or are not finite")
    return rec


def phase_blockwise_path(counters, backend):
    """The blockwise route (ops/blockwise.py), forced: (a) the grid route
    agreement's workload (3 x 4,000 points, run(1) and a stepwise Reg_opt)
    on it and on the kernel route, FE within TOL_ROUTE_FE, no kernel
    launched on it; (b) one loss+grad of run_large's dense problem at
    65,536 points on it against the kernel route at the same non-zero
    momenta (one kernel-route Reg_opt): the loss within TOL_FWD, the
    gradient within TOL_BWD of its largest entry, its peak memory under
    BLOCKWISE_PEAK_BYTES; (c) the grid loss+grad at (a)'s kernel-route state
    with backward_precision "accurate" (the blockwise VJP) against "fast"
    (the backward kernels): the gradient within TOL_BWD of its largest
    entry, the backwards' seconds."""
    import torch
    from difficp_torch.models.psr import DiffPSR

    t0 = time.perf_counter()
    fes, secs, launches, psrs = {}, {}, {}, {}
    for mode in ("kernel", "blockwise"):
        backend.set_backend(mode)
        try:
            reset(*counters.values())
            t1 = time.perf_counter()
            psr = grid_psr(3, 4000)
            psr.run(1, **GRID_RUN)
            psr.Reg_opt(tol=1e-3, nmax=1, inner=10, ls_steps=12)
            torch.cuda.synchronize()
            secs[mode] = time.perf_counter() - t1
        finally:
            backend.set_backend(None)
        fes[mode], launches[mode], psrs[mode] = psr.FE, flat_counts(counters), psr
    rel = abs(fes["blockwise"] - fes["kernel"]) / abs(fes["kernel"])
    emit({"phase": "blockwise_route_agreement", "frames": 3, "n_points": 4000,
          "grid_M": int(psrs["kernel"].q0.shape[1]), "FE_kernel": fes["kernel"],
          "FE_blockwise": fes["blockwise"], "rel_diff": rel, "tol": TOL_ROUTE_FE,
          "seconds": secs, "fe_increase_events": {m: p.fe_increase_events
                                                  for m, p in psrs.items()},
          "blockwise_launches": launches["blockwise"]})
    if rel > TOL_ROUTE_FE or any(p.fe_increase_events for p in psrs.values()):
        fail("blockwise_route_agreement", "blockwise and kernel routes disagree")
    if any(launches["blockwise"].values()) or not launches["kernel"]["rhs_ext_bwd_dx"]:
        fail("blockwise_route_agreement", f"routes not taken: {launches}")

    # (c) the accurate backward at the kernel run's state
    psr = psrs["kernel"]
    grads, bwd = {}, {}
    backend.set_backend("kernel")
    try:
        for prec in ("fast", "accurate", "fast", "accurate"):
            backend.set_bwd_precision(prec)
            reset(*counters.values())
            _, grads[prec], _, bwd[prec] = timed_loss_grad(psr)
            launches[prec] = flat_counts(counters)
    finally:
        backend.set_bwd_precision("fast")
        backend.set_backend(None)
    backend.set_backend("kernel")
    try:
        with float64_table_kernels():
            _, grad64, _, _ = timed_loss_grad(psr)
    finally:
        backend.set_backend(None)
    rel_acc = rel_err(grads["accurate"], grads["fast"].double())
    emit({"phase": "blockwise_accurate_backward", "frames": 3, "n_points": 4000,
          "grad_rel_err": rel_acc, "tol": TOL_BWD,
          "float64_route_rel_err": {p: rel_err(grads[p], grad64.double())
                                    for p in ("fast", "accurate")},
          "backward_seconds": bwd,
          "launches": {p: launches[p] for p in ("fast", "accurate")}})
    if rel_acc > TOL_BWD:
        fail("blockwise_accurate_backward", "the accurate backward disagrees with the kernels")
    if launches["accurate"]["rhs_self_bwd"] or not launches["fast"]["rhs_self_bwd"]:
        fail("blockwise_accurate_backward", "backward routes not taken: "
             f"{ {p: launches[p] for p in ('fast', 'accurate')} }")
    del psrs, psr
    torch.cuda.empty_cache()

    # (b) full width: run_large's dense problem
    x_a, gstate, gcfg, lcfg = twoset_problem(RING_N, "hybrid")
    psr = DiffPSR(x_a, gstate, gcfg, lcfg, device="cuda")
    psr.printstuff = False
    psr.Reg_opt(tol=1e-3, nmax=1, inner=5, ls_steps=12)
    timed_loss_grad(psr)
    loss_k, grad_k, fwd_k, bwd_k = timed_loss_grad(psr)
    backend.set_backend("blockwise")
    try:
        reset(*counters.values())
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss_b, grad_b, fwd_b, bwd_b = timed_loss_grad(psr)
        peak = torch.cuda.max_memory_allocated()
        block_launches = flat_counts(counters)
    finally:
        backend.set_backend(None)
    rel_loss = float(((loss_b.double() - loss_k.double()).abs() / loss_k.double().abs()).max())
    rel_grad = rel_err(grad_b, grad_k.double())
    emit({"phase": "blockwise_full_width", "n_points": RING_N, "sigma_lddmm": SIGMA,
          "a0_abs_max": float(psr.a0.abs().max()), "loss_kernel": loss_k.tolist(),
          "loss_blockwise": loss_b.tolist(), "loss_rel_diff": rel_loss, "tol_loss": TOL_FWD,
          "grad_rel_err": rel_grad, "tol_grad": TOL_BWD,
          "kernel_seconds": [fwd_k, bwd_k], "blockwise_seconds": [fwd_b, bwd_b],
          "blockwise_max_memory_allocated_bytes": peak, "memory_before_bytes": base,
          "peak_limit_bytes": BLOCKWISE_PEAK_BYTES, "blockwise_launches": block_launches,
          "seconds": time.perf_counter() - t0})
    if any(block_launches.values()):
        fail("blockwise_full_width", f"a kernel launched on the blockwise route: {block_launches}")
    if not (rel_loss <= TOL_FWD and rel_grad <= TOL_BWD):
        fail("blockwise_full_width", "blockwise and kernel loss+grad disagree")
    if peak >= BLOCKWISE_PEAK_BYTES:
        fail("blockwise_full_width", f"peak memory {peak} bytes")
    if not float(psr.a0.abs().max()) > 0.0:
        fail("blockwise_full_width", "the momenta are zero")
    del psr
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the utilities on the grid main path's state: checkpoints, the Deformetrica
# replay, the deformation grid, the trace
# ---------------------------------------------------------------------------

# the gridlines step: 64 x 64 ticks, 512 points a line, so 128 lines of 65,536
# points in all: 65,536 x 380 support pairs, above the dense pair limit
UTILS_TICKS = 64
UTILS_LINE_POINTS = 512
# the Deformetrica replay's model (sigma_LDDMM the grid's: the momenta are
# the grid main path's)
DFCA_MODEL = dict(sigma_data=0.1, noise_std=0.2, sigma_lddmm=GRID_SIGMA)
# the five eta = 0 RHS kernels by the CUDA symbols a trace names them with
# (csrc/rhs_self.cu's table kernel, csrc/direct.cuh's ext forward,
# csrc/rhs_ext.cu's table kernels), d = 2
RHS_SYMBOLS = {"rhs_self_fwd": "rhs_table_kernel<2, false",
               "rhs_self_bwd": "rhs_table_kernel<2, true",
               "rhs_ext_fwd": "ExtFwd<2, false>",
               "rhs_ext_bwd_dx": "DxSpec<2>",
               "rhs_ext_bwd_dqdp": "DqdpSpec<2>"}


@contextlib.contextmanager
def dense_route():
    """The dense route forced inside the block (the plain functions)."""
    from difficp_torch.ops import backend

    backend.set_backend("dense")
    try:
        yield
    finally:
        backend.set_backend(None)


def hold_shoot(cfg, q, a, x, qmask, got, backward=False):
    """A warp of the external points x through rows #1 and #6 (``got``, the
    kernel route's, float32) against float64: its distance from the float64
    plain shoot (``end_to_end``) beside the float32 plain shoot's
    (``plain32_end_to_end``), and each Euler step of the kernel route's own
    trajectory against one float64 plain step from the same state
    (``local_steps``: the kernels' error where their inputs are the path's),
    all relative to the largest |coordinate| of the float64 result, and the
    float64 result's own change when a is perturbed at float32 rounding
    (2^-24 relative).  Ten steps amplify the state's float32 rounding by as
    much as the kernels' error on these trajectories, so the end-to-end
    figures measure that, the local steps the kernels."""
    import torch
    from difficp_torch.models import lddmm
    from difficp_torch.models.registration import LDDMMRegistration

    def warp(q, a, m, save_traj=False):
        # the handle's shoot in q's dtype, on the route the backend picks
        return LDDMMRegistration(cfg, q, a, m).shoot(x, backward=backward,
                                                     save_traj=save_traj)

    assert cfg.scheme == "Euler"
    q8, a8 = q.double(), a.double()
    m8 = None if qmask is None else qmask.double()
    g = torch.Generator(device=q.device).manual_seed(0)
    a8p = a8 * (1 + 2.0 ** -24 * torch.randn(a8.shape, generator=g, device=q.device,
                                             dtype=torch.float64))
    with dense_route():
        fin64, tr64 = warp(q8, a8, m8, save_traj=True)
        y64 = fin64.x
        y64p = warp(q8, a8p, m8)[0].x
        y32 = warp(q, a, qmask)[0].x
    _, traj = warp(q, a, qmask, save_traj=True)
    scale = float(y64.abs().max())
    local = []
    with dense_route(), torch.no_grad():
        ode = lddmm._ode(cfg, m8, None, None, None)
        for t in range(cfg.nt):
            st = lddmm.ShootState(q=traj.q[t].double(), p=traj.p[t].double(),
                                  cost=traj.cost[t].double(), x=traj.x[t].double())
            nxt = st.x + ode(st).x / cfg.nt
            local.append(float((traj.x[t + 1].double() - nxt).abs().max()) / scale)
    finite = [bool(torch.isfinite(traj.x[t]).all() and torch.isfinite(traj.p[t]).all())
              for t in range(cfg.nt + 1)]
    return {"end_to_end": rel_err(got, y64), "plain32_end_to_end": rel_err(y32, y64),
            "local_steps": local, "local_max": max(local),
            "finite": bool(all(finite) and torch.isfinite(got).all()
                           and torch.isfinite(y64).all()),
            "first_nonfinite_step": finite.index(False) if False in finite else None,
            "max_abs_p": float(traj.p.abs().max()),
            "max_abs_q_p_float64": [float(tr64.q.abs().max()), float(tr64.p.abs().max())],
            "float64_sensitivity_to_a0_rounding": rel_err(y64p, y64)}


def utils_checkpoint(psr, counters, orders, tmp):
    """save_psr the grid main path's psr, load_psr into a fresh grid_psr of
    the same frames (the same grid), every array bit for bit on the card and
    the FE the saved one; then one GMM_opt and one stepwise Reg_opt of the
    loaded psr: no free-energy increase, the FE at most the loaded one, the
    five RHS kernels and kmin2 launched."""
    import os

    import torch
    from difficp_torch.utils import checkpoint

    path = os.path.join(tmp, "grid_psr")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_psr(path, psr)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path + ".npz")
    fresh = grid_psr(psr.K, int(psr.structs[0].n[0]))  # the same frames, so the same grid
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    checkpoint.load_psr(path, fresh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    pairs = [(name, getattr(fresh, name), getattr(psr, name))
             for name in ("x1", "y", "ptw", "regloss", "quadloss", "a0", "q0", "qmask")]
    pairs += [(f"gmm{s}_{f}", a, b) for s, (g, h) in enumerate(zip(fresh.gmm, psr.gmm))
              for f, a, b in zip(g._fields, g, h)]
    pairs += [(f"Cfe{s}", a, b) for s, (a, b) in enumerate(zip(fresh.Cfe, psr.Cfe))]
    differ = [name for name, a, b in pairs
              if not (a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b))]
    fe_loaded = fresh.FE
    reset(*counters.values(), orders)
    t2 = time.perf_counter()
    fresh.GMM_opt()
    fresh.Reg_opt(tol=1e-3, nmax=1, inner=10, ls_steps=12)
    torch.cuda.synchronize()
    cont_s = time.perf_counter() - t2
    flat = {key: v for key, v in flat_counts(counters).items() if key in ETA0_KERNELS}
    rec = {"phase": "utils_path", "step": "checkpoint", "file_bytes": nbytes,
           "save_seconds": save_s, "load_seconds": load_s, "arrays": len(pairs),
           "arrays_not_equal_on_cuda": differ, "FE_saved": psr.FE, "FE_loaded": fe_loaded,
           "continued_seconds": cont_s, "FE_continued": fresh.FE,
           "fe_increase_events": fresh.fe_increase_events, "launches": flat}
    emit(rec)
    if differ or fe_loaded != psr.FE:
        fail("utils_path", f"checkpoint not bit for bit on the card: {differ}")
    if fresh.fe_increase_events or not fresh.FE <= fe_loaded:
        fail("utils_path", "the loaded psr's free energy rose")
    if not all(v > 0 for v in flat.values()):
        fail("utils_path", f"a kernel of the continued path never launched: {flat}")
    del fresh
    torch.cuda.empty_cache()
    return flat


def utils_deformetrica(psr, counters, orders, tmp):
    """A Deformetrica output directory from the grid main path's state (the
    template frame 0's points as VTK, the control points the grid, the
    momenta psr.a0 as exact text) replayed by load_deformetrica_output on
    the card: the template, control points and momenta read back bit for
    bit, each Euler step of the warped templates (10 x 65,536 through rows
    #1 and #6) within TOL_FWD of a float64 plain step from the same state,
    their end-to-end distance from a float64 plain shoot printed beside the
    float32 plain shoot's (hold_shoot), E finite, rows #1, #6 and #13
    launched."""
    import os

    import numpy as np
    import torch
    from difficp_torch.api.deformetrica_atlas import load_deformetrica_output
    from difficp_torch.utils.spec import on_cpu
    from difficp_torch.utils.vtk_io import write_landmarks

    out = os.path.join(tmp, "deformetrica")
    os.makedirs(out)
    stem = os.path.join(out, "DeterministicAtlas__EstimatedParameters__")
    frames = [psr.get_data_points(k) for k in range(psr.K)]
    template = frames[0]
    q0, a0 = on_cpu(psr.q0[0]), on_cpu(psr.a0)
    t0 = time.perf_counter()
    write_landmarks(stem + "Template_pointset.vtk", template)
    np.savetxt(stem + "ControlPoints.txt", q0)
    with open(stem + "Momenta.txt", "w") as f:
        f.write(f"{a0.shape[0]} {a0.shape[1]} {a0.shape[2]}\n\n")
        np.savetxt(f, a0.reshape(-1, a0.shape[2]), fmt="%.17g")
    write_s = time.perf_counter() - t0
    reset(*counters.values(), orders)
    t1 = time.perf_counter()
    replay = load_deformetrica_output(frames, out, device="cuda", **DFCA_MODEL)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t1
    flat = {key: flat_counts(counters)[key] for key in ("rhs_self_fwd", "rhs_ext_fwd", "ksum")}
    same = {"template": bool(torch.equal(replay.y0[0].cpu(), torch.as_tensor(template))),
            "control_points": bool(torch.equal(replay.q0, psr.q0[0])),
            "momenta": bool(torch.equal(replay.a0, psr.a0))}
    t2 = time.perf_counter()
    holds = [hold_shoot(replay.lcfg, replay.q0, replay.a0[k], replay.y0[0], None,
                        replay.y1[k]) for k in range(replay.K)]
    check_s = time.perf_counter() - t2
    local = max(h["local_max"] for h in holds)
    rec = {"phase": "utils_path", "step": "deformetrica_replay", "frames": replay.K,
           "template_points": int(replay.ny_tot), "control_points": int(replay.q0.shape[0]),
           **DFCA_MODEL, "write_seconds": write_s, "replay_seconds": replay_s,
           "float64_check_seconds": check_s, "read_back_bit_for_bit": same,
           "y1_local_step_rel_err": local, "tol": TOL_FWD,
           "y1_end_to_end_rel_err_by_frame": [h["end_to_end"] for h in holds],
           "plain32_end_to_end_rel_err_by_frame": [h["plain32_end_to_end"] for h in holds],
           "y1_local_step_rel_err_by_frame": [h["local_max"] for h in holds],
           "float64_sensitivity_by_frame": [h["float64_sensitivity_to_a0_rounding"]
                                            for h in holds],
           "max_abs_p_by_frame": [h["max_abs_p"] for h in holds],
           "E": replay.E, "launches": flat}
    emit(rec)
    if not all(same.values()):
        fail("utils_path", f"the replay did not read back what was written: {same}")
    if not (local <= TOL_FWD and all(h["finite"] for h in holds)):
        fail("utils_path", f"a replayed step {local} from float64, above {TOL_FWD}")
    if not (math.isfinite(replay.E) and all(v > 0 for v in flat.values())):
        fail("utils_path", f"replay E not finite or a kernel never launched: {flat}")
    del replay
    torch.cuda.empty_cache()
    return flat


def utils_gridlines(psr, counters, orders):
    """Gridlines over frame 0's bounds (relmargin 0.1), UTILS_TICKS ticks a
    side and UTILS_LINE_POINTS points a line, through frame 0's registration
    handle: register forward within TOL_FWD of a float64 plain shoot (end to
    end and each step: hold_shoot), register backward measured the same way
    and printed (that inverse diverges at this state, in float64 too: the
    support's momenta grow to ~4e3, and its float32 plain version lands 0.98
    of the grid's extent from float64's), shoot(require_v=True)'s nt + 1
    grids, intersections and speeds, its last grid within TOL_FWD of
    register's; rows #1 and #6 launched.  Nothing is plotted."""
    import numpy as np
    import torch
    from difficp_torch.viz.grid import Gridlines
    from difficp_torch.viz.visu import get_bounds

    b = get_bounds(psr.get_data_points(0), relmargin=0.1)
    gl = Gridlines(np.linspace(b[0], b[1], UTILS_TICKS), np.linspace(b[2], b[3], UTILS_TICKS),
                   points_per_line=UTILS_LINE_POINTS)
    reg = psr.Registration(0)
    reset(*counters.values(), orders)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd = gl.register(reg)
    bwd = gl.register(reg, backward=True)
    register_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    grids, inters, speeds = gl.shoot(reg, require_v=True)
    shoot_s = time.perf_counter() - t1
    flat = {key: v for key, v in flat_counts(counters).items()
            if v or key in ("rhs_self_fwd", "rhs_ext_fwd")}
    pts = torch.as_tensor(gl.get_points(), device="cuda")
    holds = {name: hold_shoot(reg.cfg, reg.q0, reg.a0, pts, reg.qmask,
                              torch.as_tensor(got.get_points(), device="cuda"), backward=back)
             for name, got, back in (("forward", fwd, False), ("backward", bwd, True))}
    last = rel_err(torch.as_tensor(grids[-1].get_points()),
                      torch.as_tensor(fwd.get_points()).double())
    finite = all(np.isfinite(v).all() for v in (*inters, *speeds))
    rec = {"phase": "utils_path", "step": "gridlines", "lines": len(gl.lines),
           "points": int(pts.shape[0]), "support_points": int(reg.q0.shape[0]),
           "grids": len(grids), "intersections": int(inters[0].shape[0]),
           "register_seconds": register_s, "shoot_seconds": shoot_s, "holds": holds,
           "shoot_last_vs_register": last, "tol": TOL_FWD, "speeds_finite": finite,
           "max_speed": max(float(np.abs(v).max()) for v in speeds), "launches": flat}
    emit(rec)
    # the backward (a shoot from the arrival with negated momenta) diverges
    # at this state in float64 too: printed, not held (ROADMAP §3)
    fw = holds["forward"]
    if not (fw["end_to_end"] <= TOL_FWD and fw["local_max"] <= TOL_FWD and fw["finite"]
            and last <= TOL_FWD):
        fail("utils_path", f"the forward grid is not within {TOL_FWD} of float64: {fw}")
    if len(grids) != psr.lcfg.nt + 1 or not finite:
        fail("utils_path", "shoot(require_v=True) gave the wrong number of grids or non-finite "
                           "speeds")
    if not (flat["rhs_self_fwd"] > 0 and flat["rhs_ext_fwd"] > 0):
        fail("utils_path", f"the grid did not take the ext kernels: {flat}")
    return flat


def utils_trace(psr, counters, tmp):
    """profiling.trace around one loss+grad of the grid psr, inside
    phase_timer("loss_grad"): the trace file names the five eta = 0 RHS
    kernels' CUDA symbols; timings_summary()."""
    import glob
    import os

    import torch
    from difficp_torch.utils import profiling

    logdir = os.path.join(tmp, "trace")
    profiling.timings_summary(reset=True)
    reset(*counters.values())
    t0 = time.perf_counter()
    with profiling.trace(logdir):
        with profiling.phase_timer("loss_grad", sync=torch.cuda.synchronize):
            loss, _ = loss_grad(psr)
    traced_s = time.perf_counter() - t0
    flat = {key: v for key, v in flat_counts(counters).items() if key in RHS_SYMBOLS}
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    kernels = []
    if len(files) == 1:
        with open(files[0]) as f:
            kernels = [e.get("name", "") for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"]
    named = {key: sum(sym in name for name in kernels) for key, sym in RHS_SYMBOLS.items()}
    summary = profiling.timings_summary(reset=True)
    rec = {"phase": "utils_path", "step": "trace", "trace_files": len(files),
           "trace_bytes": os.path.getsize(files[0]) if files else 0,
           "traced_seconds": traced_s, "kernel_events": len(kernels),
           "rhs_kernel_events": named, "launches": flat, "timings_summary": summary,
           "loss_finite": bool(torch.isfinite(loss).all())}
    emit(rec)
    if len(files) != 1 or not all(named.values()):
        fail("utils_path", f"the trace does not name the five RHS kernels: {named}, "
                           f"{sorted(set(kernels))[:40]}")
    if summary.get("loss_grad", {}).get("n") != 1:
        fail("utils_path", f"phase_timer did not record the loss+grad: {summary}")
    return flat


def phase_utils_path(psr, counters, orders):
    """The ported utilities on the grid main path's end state (10 x 65,536
    points, grid support M = 380, after run(2) and a Reg_opt; psr itself is
    not changed): checkpoint, deformetrica_replay, gridlines, trace, each
    step with the launch counters set to 0 before it.  Returns the launches
    of all four steps, summed."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="difficp_utils_")
    try:
        steps = [utils_checkpoint(psr, counters, orders, tmp),
                 utils_deformetrica(psr, counters, orders, tmp),
                 utils_gridlines(psr, counters, orders),
                 utils_trace(psr, counters, tmp)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = {}
    for flat in steps:
        for key, v in flat.items():
            total[key] = total.get(key, 0) + v
    emit({"phase": "utils_path", "step": "done", "launches": total,
          "seconds": time.perf_counter() - t0})
    return total


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
    _build.build_host(force=True)
    _build.host_library()
    regs = [ln.strip() for ln in _build.build_log.splitlines() if "registers" in ln]
    emit({"phase": "build", "seconds": _build.build_seconds,
          "host_seconds": _build.host_build_seconds,
          "ptxas": regs,
          "ksum_ptxas": ksum_ptxas(_build.build_log),
          "direct_ptxas": direct_ptxas(_build.build_log),
          "kmin2_ptxas": kmin2_ptxas(_build.build_log)})

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
    utils_launches = phase_utils_path(psr, counters, rs.orders)
    t0 = time.perf_counter()
    decim_launches, worst_decim, kmin2_decim = phase_decim_main_path(counters, rs.orders)
    for name, (rel, ab) in worst_decim.items():
        worst[name] = [max(worst[name][0], rel), max(worst[name][1], ab)]
    phase_decim_route_agreement(backend)
    emit({"phase": "decim_done", "seconds": time.perf_counter() - t0})
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
    timing_d3, worst_d3 = phase_timing_direct_d3(rs, re)
    for name, (rel, ab) in [*worst_eta.items(), *worst_d3.items()]:
        worst[name] = [max(worst[name][0], rel), max(worst[name][1], ab)]
    timing_eta["rhs_self_fwd_eta"].append(timing_d3["rhs_self_fwd_eta"])
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

    # the affine, GMM-fit, auto-lambda and multi-structure slice
    t0 = time.perf_counter()
    multi_launches, worst_multi = phase_multi_structure_path(counters, rs.orders, icp_atlas)
    for name, (rel, ab) in worst_multi.items():
        worst[name] = [max(worst[name][0], rel), max(worst[name][1], ab)]
    emit({"phase": "multi_structure_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    phase_affine_atlas_path(counters, icp_atlas)
    emit({"phase": "affine_atlas_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    auto_launches, worst_auto = phase_auto_lambda_path(counters, rs.orders, icp_two_set)
    for name, (rel, ab) in worst_auto.items():
        worst[name] = [max(worst[name][0], rel), max(worst[name][1], ab)]
    emit({"phase": "auto_lambda_done", "seconds": time.perf_counter() - t0})

    # the standard algorithm (RKHS loss): KRed on ksum, the two entry points
    from difficp_torch.api.standard_atlas import standard_atlas
    from difficp_torch.api.standard_two_set import standard_two_set
    worst_kred, kred_shapes = phase_check_kred(ks)
    worst["ksum"] = [max(worst["ksum"][0], worst_kred[0]), max(worst["ksum"][1], worst_kred[1])]
    timing_eta["ksum"] += kred_shapes
    t0 = time.perf_counter()
    std_atlas_launches, worst_std = phase_standard_atlas_path(counters, rs.orders, ks,
                                                              standard_atlas)
    emit({"phase": "standard_atlas_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    std_two_set_launches, worst_two = phase_standard_two_set_path(counters, rs.orders, ks,
                                                                  standard_two_set)
    emit({"phase": "standard_two_set_done", "seconds": time.perf_counter() - t0})
    for name, (rel, ab) in [*worst_std.items(), *worst_two.items()]:
        worst[name] = [max(worst[name][0], rel), max(worst[name][1], ab)]
    phase_standard_route_agreement(backend, standard_atlas)
    std_launches_by_path = {"standard_atlas_path": std_atlas_launches,
                            "standard_two_set_path": std_two_set_launches}

    # the host-offload atlas, the frame-parallel atlas step, the blockwise route
    t0 = time.perf_counter()
    offload = phase_offload_atlas_path(counters, rs.orders)
    offload_agree = phase_offload_agreement(counters, offload["max_memory_allocated_bytes"])
    emit({"phase": "offload_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    atlas_step = phase_atlas_step_path(counters)
    emit({"phase": "atlas_step_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    phase_blockwise_path(counters, backend)
    emit({"phase": "blockwise_done", "seconds": time.perf_counter() - t0})
    frame_paths = {"offload_atlas_path": offload["launches"],
                   "offload_agreement": offload_agree["diffpsr_launches"],
                   "atlas_step_path": atlas_step["launches"]}

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
        launches_by_path = {"grid_main_path": grid_launches[name],
                            "decim_main_path": decim_launches[name],
                            "multi_structure_path": multi_launches[name]}
        if name in auto_launches:
            launches_by_path["auto_lambda_path"] = auto_launches[name]
        if utils_launches.get(name):
            launches_by_path["utils_path"] = utils_launches[name]
        for path, counts in [*std_launches_by_path.items(), *frame_paths.items()]:
            if counts.get(name):
                launches_by_path[path] = counts[name]
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
        if t.get("device_ms") is not None:
            entry["device_ms"] = t["device_ms"]
        if name == "kmin2":
            # and the decim path's coverage shape
            entry.update(shapes=[
                dict(call=f"grid coverage {t['frames']} x {t['N']:,} x {t['M']}",
                     **{key: t[key] for key in ("ms", "device_ms", "bound_ms", "bound_by")}),
                {key: kmin2_decim[key] for key in ("call", "ms", "device_ms", "bound_ms",
                                                   "bound_by")}])
        if name in DIRECT_KERNELS:
            # and the d = 3 shape
            d3 = timing_d3[name]
            entry.update(shapes=[dict(call="grid main 10 x 65,536 x M", ms=t["ms"],
                                      device_ms=t["device_ms"], plain_ms=t["plain_ms"],
                                      bound_ms=t["bound_ms"], bound_by=t["bound_by"]),
                                 {key: d3[key] for key in ("call", "ms", "device_ms", "plain_ms",
                                                           "bound_ms", "bound_by")}])
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
        grid = [r for r in shapes if not r["call"].startswith(("dense", "ring", "standard"))
                and "d = 3" not in r["call"]]
        t = max(grid, key=lambda r: r["ms"])
        by_path = {"grid_eta_path": grid_eta_launches[name],
                   "dense_eta_path": dense_eta_launches[name]}
        if name == "ksum":
            by_path.update({path["phase"]: path["launches"][name] for path in (ring, ring_eta)})
            by_path.update({path: counts["ksum"] for path, counts in
                            std_launches_by_path.items()})
            by_path["utils_path"] = utils_launches.get("ksum", 0)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": rep,
            "also_replaces": also, "launches": grid_eta_launches[name],
            "launches_by_path": by_path,
            "max_abs_err": worst[name][1], "max_rel_err": worst[name][0],
            "shape": t["call"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"),
            **({"device_ms": t["device_ms"]} if name in DIRECT_KERNELS else {}),
            "shapes": [{key: r.get(key) for key in ("call", "ms", "device_ms", "plain_ms",
                                                    "bound_ms", "bound_by", "library_ms")}
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
            **({"device_ms": t["device_ms"]} if name in DIRECT_KERNELS else {}),
            **{key: t[key] for key in TABLE_BOUND_KEYS if key in t}})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
