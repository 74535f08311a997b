#!/usr/bin/env python3
"""An earlier build of the top-2 minimum kernel (kmin2) against the current
one, on one CUDA card; and what the current one compiles to.

    python3 tools/kmin2_ab.py time OLD_DIR
    python3 tools/kmin2_ab.py sass
    python3 tools/kmin2_ab.py clock

OLD_DIR holds the earlier kernel's source and its wrapper from one commit,
for example:

    mkdir -p build/kmin2_old
    for f in csrc/kmin2.cu csrc/tile.cuh ops/kmin2.py; do
        git show <commit>:difficp_torch/$f > build/kmin2_old/$(basename $f)
    done

``kmin2.cu`` is built with nvcc into OLD_DIR and ``kmin2.py`` is imported as
a module of its own whose ``_build.library()`` is that build, so the earlier
kernel runs with its own entry point.

``time``: at each shape both versions run on the same inputs; the line gives
each one's largest error against the float64 plain version, relative to each
distance (+inf where the plain version has +inf), whether two calls of the
current kernel agree bit for bit and whether the two versions agree bit for
bit, then, in the order earlier, current, current, earlier, each one's
median of 15 launches timed with CUDA events (cuda_ms: the wrapper's host
time included) and its median device time (device_ms: the kernel's own,
from a torch.profiler trace), the earlier's summed times over the current's,
and the current's share of the bound by device time.  Shapes: the coverage
pass of chip_smoke.py's grid main path (the 10 frames of 65,536 spiral
points and their grid support at sigma = 0.05, each moved a little at each
of the nt + 1 = 11 time steps: 110 frames of 65,536 x 380, d = 2), the
coverage pass of its decim main path (the same frames, each frame's support
its own greedy cover at r = sigma, utils.point_sets.decimate, padded to one
width with masks as DiffPSR.set_support_scheme("decim") pads it, each moved
a little at each time step), and second_min_sqdist on one frame of 65,536
spiral points (exclude_self).  Writes build/kmin2_ab.json.

``sass``: the instruction mix of each kmin2 kernel instance in the current
build (cuobjdump -sass of build/libdifficp_torch_kernels.so, counted over
the whole kernel and over its longest straight run, cut at branches and
branch targets: the unrolled pair loop), and the issue rate of the pair
loop's instructions measured alone and mixed: FMNMX (min.f32), FADD, IMNMX,
the three-input integer min of Hopper's DPX functions, and the pair's mix
(4 FP32, 3 FMNMX) grouped and interleaved, or beside integer min/max, each
as warp instructions issued per SM cycle, every instruction of the stream's
loop counted (clock64 and %smid in every block: an SM's blocks from the
first start to the last end; 4 is the SM's issue limit), and again on the
launch's time and nvidia-smi's SM clock.  Writes build/kmin2_sass.json.

``clock``, after ``sass`` in the same command: the SM clock while kmin2
runs at the grid coverage shape (3 seconds of back-to-back launches timed
with CUDA events, nvidia-smi's clocks.sm sampled meanwhile, every 0.1 s),
and with the pair loop's instruction count from build/kmin2_sass.json (the
loop body and the branch that closes it, over the unroll's 16 x 4 pairs)
the warp instructions the loop issues an SM cycle on the median sample.
Writes build/kmin2_clock.json.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import types
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load(old_dir: Path):
    """The earlier kmin2 module bound to OLD_DIR's build."""
    from difficp_torch.ops import _build

    lib = old_dir / "libkmin2_old.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    str(old_dir / "kmin2.cu"), "-o", str(lib)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    spec = importlib.util.spec_from_file_location("kmin2_old", old_dir / "kmin2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = types.SimpleNamespace(library=lambda: dll)
    return mod


def shapes(cs):
    """(name, x, y, mask, exclude_self, pairs) of every timed shape."""
    import numpy as np
    import torch
    from difficp_torch.examples.run_large import spiral_cloud
    from difficp_torch.utils.io import pad_frames
    from difficp_torch.utils.point_sets import decimate_sets, grid_support

    k, n, d, nt = 10, 65536, 2, 10
    frames = cs.grid_frames(k, n)
    x = torch.as_tensor(np.stack(frames)).cuda()
    qg = torch.as_tensor(grid_support(x.reshape(-1, d).cpu().numpy(), cs.GRID_SIGMA)).cuda()
    m = qg.shape[0]
    g = torch.Generator(device="cuda").manual_seed(3)
    q = qg + 0.1 * cs.GRID_SIGMA * torch.randn((k, m, d), generator=g, device="cuda")
    xs = (x + 0.1 * cs.GRID_SIGMA * torch.randn((nt + 1, k, n, d), generator=g,
                                                device="cuda")).reshape(-1, n, d)
    qs = (q + 0.1 * cs.GRID_SIGMA * torch.randn((nt + 1, k, m, d), generator=g,
                                                device="cuda")).reshape(-1, m, d)
    ones = torch.ones((qs.shape[0], m), device="cuda")
    # decim support: each frame's own cover at r = rho sigma (rho = 1)
    dec = pad_frames([f[kept] for f, (kept, _) in
                      zip(frames, decimate_sets(frames, cs.GRID_SIGMA))], "cuda")
    md = dec.x.shape[1]
    qd = (dec.x + 0.1 * cs.GRID_SIGMA * torch.randn((nt + 1, k, md, d), generator=g,
                                                    device="cuda")).reshape(-1, md, d)
    maskd = dec.mask.expand(nt + 1, k, md).reshape(-1, md).contiguous()
    one = torch.as_tensor(spiral_cloud(n, np.random.default_rng(4)))[None].cuda()
    return [
        ("coverage 110 x 65,536 x M", xs, qs, ones, False, float(xs.shape[0]) * n * m),
        ("decim coverage 110 x 65,536 x M", xs, qd, maskd,
         False, float(n) * float(maskd.sum())),
        ("second_min_sqdist 65,536^2", one, one, torch.ones((1, n), device="cuda"),
         True, float(n) * (n - 1)),
    ]


def rel_errors(got, ref):
    """The largest error relative to each finite distance; whether +inf is
    where the plain version has it."""
    import torch

    worst, same_inf = 0.0, True
    for a, b in zip(got, ref):
        a = a.double()
        fin = torch.isfinite(b)
        same_inf &= bool((torch.isinf(a) == torch.isinf(b)).all())
        if bool(fin.any()):
            worst = max(worst, float(((a - b).abs() / b.abs().clamp_min(1e-30))[fin].max()))
    return worst, same_inf


def run_time(cs, k2, old):
    import torch

    smi = cs.nvidia_smi_line()
    recs = []
    for name, x, y, my, excl, pairs in shapes(cs):
        new_fn = lambda: k2.kmin2(x, y, my, excl)  # noqa: E731
        old_fn = lambda: old.kmin2(x, y, my, excl)  # noqa: E731
        a, again, b = new_fn(), new_fn(), old_fn()
        torch.cuda.synchronize()
        # the float64 plain version a block of frames at a time, to bound its memory
        refs = [k2.kmin2_reference(x[s:s + 10].double(), y[s:s + 10].double(),
                                   my[s:s + 10].double(), excl)
                for s in range(0, x.shape[0], 10)]
        ref = [torch.cat([r[i] for r in refs]) for i in (0, 1)]
        new_err, new_inf = rel_errors(a, ref)
        old_err, old_inf = rel_errors(b, ref)
        rec = dict(call=name, frames=x.shape[0], N=x.shape[1], M=y.shape[1],
                   exclude_self=excl, pairs=pairs, new_rel_err=new_err, new_inf_ok=new_inf,
                   old_rel_err=old_err, old_inf_ok=old_inf,
                   new_bit_identical=all(torch.equal(u, v) for u, v in zip(a, again)),
                   new_equals_old=all(torch.equal(u, v) for u, v in zip(a, b)))
        del a, again, b, refs, ref
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
        bd = cs.bound(pairs, k2.ops_per_pair(x.shape[-1]), 0.0,
                      4.0 * x.shape[0] * (x.shape[1] * (x.shape[2] + 2) + y.shape[1]
                                          * (y.shape[2] + 1)))
        rec.update({f"{key}_ms": t for key, t in ms.items()},
                   **{f"{key}_device_ms": t for key, t in dev.items()},
                   speedup=sum(ms["old"]) / sum(ms["new"]),
                   device_speedup=sum(dev["old"]) / sum(dev["new"]),
                   bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
                   new_device_share_of_bound=bd["bound_ms"] / (sum(dev["new"]) / 2),
                   old_device_share_of_bound=bd["bound_ms"] / (sum(dev["old"]) / 2),
                   device=smi)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    print(smi)
    return {"records": recs}


# instruction streams for the issue-rate measurement, one kernel each
# (pipe_<name>, an instance of pipe<MODE>): 8 independent chains a thread, 7 steps of one
# instruction a chain each (nothing folded: asm volatile, or an empty asm
# that takes the value as changed), the loop not unrolled, each block's SM
# cycles from clock64()
_PIPES_CU = r"""
#define FMIN(a) asm volatile("min.f32 %0, %0, %1;" : "+f"(a) : "f"(fb))
#define FMAX(a) asm volatile("max.f32 %0, %0, %1;" : "+f"(a) : "f"(fb))
#define FADD(a) asm volatile("add.f32 %0, %0, %1;" : "+f"(a) : "f"(fb))
#define FFMA(a) asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(a) : "f"(fb))
#define IMIN(a) asm volatile("min.s32 %0, %0, %1;" : "+r"(a) : "r"(ib))
#define IMAX(a) asm volatile("max.s32 %0, %0, %1;" : "+r"(a) : "r"(ib))
#define IMIN3(a) { a = __vimin3_s32(a, ib, ic); asm volatile("" : "+r"(a)); }
#define EIGHT(S, p) S(p##0); S(p##1); S(p##2); S(p##3); S(p##4); S(p##5); S(p##6); S(p##7);
template <int MODE>
__device__ __forceinline__ void pipe(float* out, long long* cycles, float fb, int ib, int ic,
                                     int iters) {
  float f0 = threadIdx.x, f1 = f0 + 1, f2 = f0 + 2, f3 = f0 + 3, f4 = f0 + 4,
        f5 = f0 + 5, f6 = f0 + 6, f7 = f0 + 7;
  int i0 = threadIdx.x, i1 = i0 + 1, i2 = i0 + 2, i3 = i0 + 3, i4 = i0 + 4, i5 = i0 + 5,
      i6 = i0 + 6, i7 = i0 + 7;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    if constexpr (MODE == 0) {  // FMNMX
      EIGHT(FMIN, f) EIGHT(FMAX, f) EIGHT(FMIN, f) EIGHT(FMAX, f) EIGHT(FMIN, f)
      EIGHT(FMAX, f) EIGHT(FMIN, f)
    } else if constexpr (MODE == 1) {  // FADD
      EIGHT(FADD, f) EIGHT(FADD, f) EIGHT(FADD, f) EIGHT(FADD, f) EIGHT(FADD, f)
      EIGHT(FADD, f) EIGHT(FADD, f)
    } else if constexpr (MODE == 2) {  // IMNMX
      EIGHT(IMIN, i) EIGHT(IMAX, i) EIGHT(IMIN, i) EIGHT(IMAX, i) EIGHT(IMIN, i)
      EIGHT(IMAX, i) EIGHT(IMIN, i)
    } else if constexpr (MODE == 3) {  // three-input integer min (a DPX function)
      EIGHT(IMIN3, i) EIGHT(IMIN3, i) EIGHT(IMIN3, i) EIGHT(IMIN3, i) EIGHT(IMIN3, i)
      EIGHT(IMIN3, i) EIGHT(IMIN3, i)
    } else if constexpr (MODE == 4) {  // the pair's mix, grouped: 2 FADD, 2 FFMA, 3 FMNMX
      EIGHT(FADD, f) EIGHT(FADD, f) EIGHT(FFMA, f) EIGHT(FFMA, f) EIGHT(FMIN, f)
      EIGHT(FMAX, f) EIGHT(FMIN, f)
    } else if constexpr (MODE == 5) {  // the pair's mix, interleaved
      EIGHT(FADD, f) EIGHT(FMIN, f) EIGHT(FADD, f) EIGHT(FMAX, f) EIGHT(FFMA, f)
      EIGHT(FMIN, f) EIGHT(FFMA, f)
    } else if constexpr (MODE == 6) {  // 4 FP32 beside 3 IMNMX on other registers
      EIGHT(FADD, f) EIGHT(IMIN, i) EIGHT(FADD, f) EIGHT(IMAX, i) EIGHT(FFMA, f)
      EIGHT(IMIN, i) EIGHT(FFMA, f)
    } else {  // 4 FP32 beside 3 three-input integer mins
      EIGHT(FADD, f) EIGHT(IMIN3, i) EIGHT(FADD, f) EIGHT(IMIN3, i) EIGHT(FFMA, f)
      EIGHT(IMIN3, i) EIGHT(FFMA, f)
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  out[blockIdx.x * blockDim.x + threadIdx.x] =
      f0 + f1 + f2 + f3 + f4 + f5 + f6 + f7 + (float)(i0 + i1 + i2 + i3 + i4 + i5 + i6 + i7);
  if (threadIdx.x == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    cycles[3 * blockIdx.x] = t0;
    cycles[3 * blockIdx.x + 1] = t1;
    cycles[3 * blockIdx.x + 2] = sm;
  }
}
#define KERNEL(NAME, MODE)                                                                \
  extern "C" __global__ void pipe_##NAME(float* out, long long* cycles, float fb, int ib,  \
                                         int ic, int iters) {                             \
    pipe<MODE>(out, cycles, fb, ib, ic, iters);                                           \
  }
KERNEL(fmnmx, 0)
KERNEL(fadd, 1)
KERNEL(imnmx, 2)
KERNEL(imin3_dpx, 3)
KERNEL(pair_mix_grouped, 4)
KERNEL(pair_mix_interleaved, 5)
KERNEL(fp32_beside_imnmx, 6)
KERNEL(fp32_beside_imin3_dpx, 7)
"""
_PIPE_MODES = ("fmnmx", "fadd", "imnmx", "imin3_dpx", "pair_mix_grouped",
               "pair_mix_interleaved", "fp32_beside_imnmx", "fp32_beside_imin3_dpx")
_SASS_OP = re.compile(
    r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_functions(sass, keep):
    """{function: [(address, opcode, branch target or None), ...]} of the
    functions of cuobjdump -sass output whose names ``keep`` accepts."""
    out, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1) if keep(m.group(1)) else None
            if name:
                out[name] = []
            continue
        m = _SASS_OP.match(ln)
        if name and m:
            op = m.group(2).split(".")[0]
            t = re.search(r"0x([0-9a-f]+)\s*$", m.group(3)) if op == "BRA" else None
            out[name].append((int(m.group(1), 16), op, int(t.group(1), 16) if t else None))
    return out


def longest_run(ins):
    """The longest run of instructions with no branch, barrier or exit in it
    and no branch target after its first: a loop's body, from the target of
    the branch that closes it (not counted) to that branch."""
    targets = {t for _, _, t in ins if t is not None}
    runs, cur = [], []
    for addr, op, _ in ins:
        if addr in targets:
            runs.append(cur)
            cur = []
        if op in ("BRA", "EXIT", "BAR", "RET"):
            runs.append(cur)
            cur = []
        else:
            cur.append(op)
    runs.append(cur)
    return max(runs, key=len)


def issue_rates():
    """Warp instructions issued per SM cycle by each stream of _PIPES_CU (8
    blocks of 256 threads an SM: 64 warps resident), per SM from the first
    start to the last end of its blocks (clock64 and %smid), the median over
    SMs: counting the 56 instructions of the stream an iteration
    (``stream_...``), and counting every instruction of the loop's body,
    the loop's own and the branch that closes it included (from the
    kernel's SASS).  Beside them the same rate on the launch's time by CUDA
    events and nvidia-smi's SM clock read after it (``..._by_time``: the
    whole grid's instructions over the launch's SM cycles), and the rate
    at which clock64 ticked (the median SM's span over the launch's
    time)."""
    import torch
    from difficp_torch.ops import _build

    src = ROOT / "build" / "kmin2_pipes.cu"
    src.write_text(_PIPES_CU)
    cubin = src.with_suffix(".cubin")
    cc = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                         "-std=c++17", "-cubin", str(src), "-o", str(cubin)],
                        capture_output=True, text=True)
    if cc.returncode:
        raise RuntimeError(f"nvcc {src}:\n{cc.stderr}")
    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    funcs = sass_functions(sass, lambda name: name.startswith("pipe_"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = sms * 8, 256, 4096
    out = torch.empty(blocks * threads, device="cuda")  # the context is current from here
    cycles = torch.zeros(3 * blocks, dtype=torch.int64, device="cuda")
    cuda = ctypes.CDLL("libcuda.so.1")
    mod = ctypes.c_void_p()
    err = cuda.cuModuleLoad(ctypes.byref(mod), str(cubin).encode())
    if err != 0:
        raise RuntimeError(f"loading the issue-rate kernels: CUresult {err}")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    res = {}
    for name in _PIPE_MODES:
        fn = ctypes.c_void_p()
        err = cuda.cuModuleGetFunction(ctypes.byref(fn), mod, f"pipe_{name}".encode())
        if err != 0:
            raise RuntimeError(f"cuModuleGetFunction {name}: CUresult {err}")
        args = [ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(cycles.data_ptr()),
                ctypes.c_float(1.0), ctypes.c_int(3), ctypes.c_int(5), ctypes.c_int(iters)]
        ptrs = (ctypes.c_void_p * len(args))(*[ctypes.cast(ctypes.pointer(a), ctypes.c_void_p)
                                               for a in args])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for rep in range(2):
            if rep:
                ev[0].record()
            err = cuda.cuLaunchKernel(fn, blocks, 1, 1, threads, 1, 1, 0, stream, ptrs, None)
            if err != 0:
                raise RuntimeError(f"cuLaunchKernel: CUresult {err}")
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1])
        mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                    "--format=csv,noheader,nounits"], capture_output=True,
                                   text=True, check=True).stdout.split()[0])
        t0, t1, sm = cycles.view(blocks, 3).cpu().unbind(1)
        rates, spans = [], []
        for k in sm.unique():
            on = sm == k
            span = float(t1[on].max() - t0[on].min())
            spans.append(span)
            rates.append(float(on.sum()) * threads / 32 * iters / span)
        rates.sort()
        spans.sort()
        body = longest_run(funcs[f"pipe_{name}"])
        loop = len(body) + 1
        warp_iters = blocks * threads / 32 * iters
        res[name] = dict(loop_instructions=loop, loop_ops=dict(Counter(body).most_common()),
                         loop_order=" ".join(body),
                         warp_instr_per_sm_cycle=rates[len(rates) // 2] * loop,
                         stream_warp_instr_per_sm_cycle=rates[len(rates) // 2] * 7 * 8,
                         spread=[rates[0] * loop, rates[-1] * loop], launch_ms=ms,
                         clocks_sm_mhz=mhz,
                         warp_instr_per_sm_cycle_by_time=(
                             warp_iters * loop / (ms * 1e-3 * mhz * 1e6 * sms)),
                         clock64_mhz=spans[len(spans) // 2] / (ms * 1e3))
    return res


def run_sass(cs):
    from difficp_torch.ops import _build

    lib = _build.build()
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    kernels = sass_functions(sass, lambda name: "kmin2" in name)
    out = {}
    for name, ins in kernels.items():
        # the longest run with no branch: the unrolled pair loop
        body = longest_run(ins)
        out[name] = {"all": dict(Counter(op for _, op, _ in ins).most_common()),
                     "pair_loop": dict(Counter(body).most_common()),
                     "pair_loop_len": len(body), "pair_loop_order": " ".join(body)}
        print(json.dumps({"kernel": name, **out[name]}), flush=True)
    rates = issue_rates()
    print(json.dumps({"issue_rates": rates}), flush=True)
    smi = cs.nvidia_smi_line()
    print(smi)
    return {"sass": out, "issue_rates": rates, "device": smi}


def run_clock(cs, k2):
    """The SM clock during kmin2 at the grid coverage shape, and the issue
    rate of its pair loop on it."""
    import statistics
    import threading
    import time

    import torch

    sass = json.loads((ROOT / "build" / "kmin2_sass.json").read_text())["sass"]
    name = next(key for key in sass if "kmin2_kernelILi2ELb0E" in key)
    body = sass[name]["pair_loop_len"] + 1  # and the branch that closes it
    per_pair = body / 64  # the unroll's 16 columns x 4 rows
    _, x, y, my, excl, pairs = shapes(cs)[0]
    fn = lambda: k2.kmin2(x, y, my, excl)  # noqa: E731
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, check=True)
            samples.append(float(out.stdout.split()[0]))
            time.sleep(0.1)

    reps = max(1, int(3000 / cs.device_ms(fn, 5)))
    th = threading.Thread(target=sample)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    th.start()
    time.sleep(0.3)  # a sample before the loop
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    stop.set()
    th.join()
    ms = a.elapsed_time(b) / reps
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = statistics.median(samples)
    warp_instr = pairs / 32 * per_pair
    rec = dict(kernel=name, pair_loop_instructions=body, instructions_per_pair=per_pair,
               launches=reps, ms_per_launch=ms, clocks_sm_mhz_samples=samples,
               clocks_sm_mhz_median=mhz, sms=sms,
               loop_warp_instr_per_sm_cycle=warp_instr / (ms * 1e-3 * mhz * 1e6 * sms),
               device=cs.nvidia_smi_line())
    print(json.dumps(rec), flush=True)
    print(rec["device"])
    return rec


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("kmin2_ab: CUDA is not available", file=sys.stderr)
        return 2
    if not ((len(argv) == 2 and argv[0] == "time") or argv in (["sass"], ["clock"])):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from difficp_torch.ops import kmin2 as k2

    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    if argv[0] == "time":
        res = run_time(cs, k2, load(Path(argv[1]).resolve()))
    elif argv[0] == "sass":
        res = run_sass(cs)
    else:
        res = run_clock(cs, k2)
    (out / f"kmin2_{'ab' if argv[0] == 'time' else argv[0]}.json").write_text(
        json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
