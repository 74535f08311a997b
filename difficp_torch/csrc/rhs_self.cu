// Fused LDDMM self right-hand side for eta = 0 (forward) and its VJP
// (backward), for sm_90a.  Plain C interface, loaded with ctypes by
// difficp_torch/ops/rhs_self.py.
//
// Notation: u = 1/sigma^2, k_ij = exp(-u |q_i - q_j|^2 / 2), d_ij = q_i - q_j,
// m the point mask.  Per frame b of a batch, rows 0..M-1:
//
//   forward   v_i  = m_i sum_j m_j k_ij p_j
//             w_i  = u m_i sum_j m_j k_ij (p_i.p_j) d_ij           (= -Gq)
//             dc_i = -u m_i sum_j m_j k_ij (p_i.d_ij)  (0 without logdet)
//   backward  (cotangents a of v, b of w, c of sum_i dc_i)
//             dp_l = m_l sum_j m_j k_lj [a_j + u ((b_l-b_j).d_lj) p_j - u c d_lj]
//             dq_l = m_l u sum_j m_j k_lj [-S_lj d_lj + (p_l.p_j)(b_l-b_j)
//                                          - c (p_l-p_j)]
//             S_lj = a_l.p_j + a_j.p_l + u (p_l.p_j)((b_l-b_j).d_lj)
//                    - u c ((p_l-p_j).d_lj)
//
// Replaces the TPU kernels of difficp_tpu/ops/pallas_reductions.py:
//   forward:  _rhs_self_sym_mm_kernel (via _rhs_self_fwd_sym_mm),
//             _rhs_self_sym_pair_kernel mode="fwd" (via _sym_block_tables),
//             _rhs_self_mm_kernel (via _rhs_self_fwd_mm);
//   backward: _rhs_self_bwd_mm_kernel (via _rhs_self_bwd_mm),
//             _rhs_self_sym_pair_kernel mode="bwd" (via _sym_block_grads).
//
// What bounds it on an H100: arithmetic.  The function needs 32 FP32
// operations per unordered pair forward at d = 2 (15 d + 2, an FMA counted as
// two, each term shared by (i, j) and (j, i) once) and 71 backward (34 d + 3):
// see fwd_ops_per_unordered_pair and bwd_ops_per_unordered_pair in
// ops/rhs_self.py.  It needs one exponential per unordered pair, on the MUFU
// ex2 unit (16 per SM per clock), which takes about half as long as the FP32
// work forward.  The bytes moved are O(M d), a few MB.  These kernels take
// each ordered pair apart instead, 11 d + 5 FP32 operations forward and
// 29 d + 7 backward per ordered pair, and one exponential each (exp2f of a
// prescaled argument): at d = 2, 1.69 and 1.83 times the least FP32 work and
// twice the exponentials.
//
// What the design does about it: a direct pair sum.  One thread owns one row
// and keeps it in registers; a block of 128 rows stages 128-column tiles of the
// j side in shared memory as float4 records (one to four 16-byte words per
// column), every thread reads the same record (a broadcast), and all sums stay
// in registers: no atomics, nothing crosses blocks.  Sums are taken per tile
// and then added to the running total, which keeps the float32 error of a
// 65,536-term sum near that of a 512-term one.  The TPU's payload-matmul
// tables (raw-coordinate monomials fed to the MXU, split-bf16 products, the
// (8, M) packing) existed to use a matrix unit; the direct form has none of
// their (R/sigma)^2 cancellation, so neither Morton ordering nor per-block
// re-centering of the coordinates is needed here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // rows per block, and columns per j tile
constexpr float kLog2e = 1.4426950408889634f;

template <int NF>
struct Record {
  static constexpr int kWords = (NF + 3) / 4;  // float4 words per column
};

// Copies column j's NF floats (zeros past the end) into the tile slot.
template <int NF>
__device__ __forceinline__ void store_record(float4* slot, const float* vals) {
  constexpr int NV = Record<NF>::kWords;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = (4 * v + e < NF) ? vals[4 * v + e] : 0.f;
    slot[v] = make_float4(f[0], f[1], f[2], f[3]);
  }
}

template <int NF>
__device__ __forceinline__ void load_record(const float4* slot, float* out) {
  constexpr int NV = Record<NF>::kWords;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float4 t = slot[v];
    out[4 * v] = t.x;
    out[4 * v + 1] = t.y;
    out[4 * v + 2] = t.z;
    out[4 * v + 3] = t.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
rhs_self_fwd_kernel(const float* __restrict__ q, const float* __restrict__ p,
                    const float* __restrict__ m, float* __restrict__ v,
                    float* __restrict__ w, float* __restrict__ dc, int M,
                    float u, int withlogdet) {
  constexpr int NF = 2 * D + 1;  // record: q_j, p_j, m_j
  constexpr int NV = Record<NF>::kWords;
  __shared__ float4 tile[kThreads * NV];

  const size_t frame = blockIdx.y;
  q += frame * M * D;
  p += frame * M * D;
  m += frame * M;
  v += frame * M * D;
  w += frame * M * D;
  dc += frame * M;

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool row_ok = i < M;
  float qi[D], pi[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qi[d] = row_ok ? q[(size_t)i * D + d] : 0.f;
    pi[d] = row_ok ? p[(size_t)i * D + d] : 0.f;
  }
  const float mi = row_ok ? m[i] : 0.f;
  const float c2 = -0.5f * u * kLog2e;

  float av[D], aw[D], adc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) av[d] = aw[d] = 0.f;

  for (int base = 0; base < M; base += kThreads) {
    const int j = base + threadIdx.x;
    float rec[NF];
    if (j < M) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        rec[d] = q[(size_t)j * D + d];
        rec[D + d] = p[(size_t)j * D + d];
      }
      rec[2 * D] = m[j];
    } else {
#pragma unroll
      for (int e = 0; e < NF; ++e) rec[e] = 0.f;  // m_j = 0: no contribution
    }
    store_record<NF>(&tile[threadIdx.x * NV], rec);
    __syncthreads();

    float tv[D], tw[D], tdc = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) tv[d] = tw[d] = 0.f;
#pragma unroll 4
    for (int jj = 0; jj < kThreads; ++jj) {
      float f[4 * NV];
      load_record<NF>(&tile[jj * NV], f);
      float dd[D];
      float r2 = 0.f, pp = 0.f, pd = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dd[d] = qi[d] - f[d];
        r2 = fmaf(dd[d], dd[d], r2);
        pp = fmaf(pi[d], f[D + d], pp);
        pd = fmaf(pi[d], dd[d], pd);
      }
      const float k = f[2 * D] * exp2f(c2 * r2);
      const float kpp = k * pp;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        tv[d] = fmaf(k, f[D + d], tv[d]);
        tw[d] = fmaf(kpp, dd[d], tw[d]);
      }
      tdc = fmaf(k, pd, tdc);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      av[d] += tv[d];
      aw[d] += tw[d];
    }
    adc += tdc;
    __syncthreads();
  }

  if (row_ok) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      v[(size_t)i * D + d] = mi * av[d];
      w[(size_t)i * D + d] = u * mi * aw[d];
    }
    dc[i] = withlogdet ? -u * mi * adc : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
rhs_self_bwd_kernel(const float* __restrict__ q, const float* __restrict__ p,
                    const float* __restrict__ m, const float* __restrict__ ga,
                    const float* __restrict__ gb, const float* __restrict__ gc,
                    float* __restrict__ dq, float* __restrict__ dp, int M,
                    float u, int withlogdet) {
  constexpr int NF = 4 * D + 1;  // record: q_j, p_j, a_j, b_j, m_j
  constexpr int NV = Record<NF>::kWords;
  __shared__ float4 tile[kThreads * NV];

  const size_t frame = blockIdx.y;
  q += frame * M * D;
  p += frame * M * D;
  m += frame * M;
  ga += frame * M * D;
  gb += frame * M * D;
  dq += frame * M * D;
  dp += frame * M * D;
  // the cotangent of the frame's dcost, read on the device: no host sync
  const float c = withlogdet ? gc[frame] : 0.f;

  const int l = blockIdx.x * kThreads + threadIdx.x;
  const bool row_ok = l < M;
  float ql[D], pl[D], al[D], bl[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t o = (size_t)l * D + d;
    ql[d] = row_ok ? q[o] : 0.f;
    pl[d] = row_ok ? p[o] : 0.f;
    al[d] = row_ok ? ga[o] : 0.f;
    bl[d] = row_ok ? gb[o] : 0.f;
  }
  const float ml = row_ok ? m[l] : 0.f;
  const float c2 = -0.5f * u * kLog2e;

  float sa[D], sb[D], sq[D];
#pragma unroll
  for (int d = 0; d < D; ++d) sa[d] = sb[d] = sq[d] = 0.f;

  for (int base = 0; base < M; base += kThreads) {
    const int j = base + threadIdx.x;
    float rec[NF];
    if (j < M) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const size_t o = (size_t)j * D + d;
        rec[d] = q[o];
        rec[D + d] = p[o];
        rec[2 * D + d] = ga[o];
        rec[3 * D + d] = gb[o];
      }
      rec[4 * D] = m[j];
    } else {
#pragma unroll
      for (int e = 0; e < NF; ++e) rec[e] = 0.f;
    }
    store_record<NF>(&tile[threadIdx.x * NV], rec);
    __syncthreads();

    float ta[D], tb[D], tq[D];
#pragma unroll
    for (int d = 0; d < D; ++d) ta[d] = tb[d] = tq[d] = 0.f;
#pragma unroll 2
    for (int jj = 0; jj < kThreads; ++jj) {
      float f[4 * NV];
      load_record<NF>(&tile[jj * NV], f);
      const float* qj = f;
      const float* pj = f + D;
      const float* aj = f + 2 * D;
      const float* bj = f + 3 * D;
      float dd[D], db[D], dpl[D];
      float r2 = 0.f, pp = 0.f, dbd = 0.f, dpd = 0.f, ap = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dd[d] = ql[d] - qj[d];
        db[d] = bl[d] - bj[d];
        dpl[d] = pl[d] - pj[d];
        r2 = fmaf(dd[d], dd[d], r2);
        pp = fmaf(pl[d], pj[d], pp);
        dbd = fmaf(db[d], dd[d], dbd);
        dpd = fmaf(dpl[d], dd[d], dpd);
        ap = fmaf(al[d], pj[d], ap);
        ap = fmaf(aj[d], pl[d], ap);
      }
      const float k = f[4 * D] * exp2f(c2 * r2);
      const float s = fmaf(u, fmaf(pp, dbd, -c * dpd), ap);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        ta[d] = fmaf(k, aj[d], ta[d]);
        tb[d] = fmaf(k, fmaf(dbd, pj[d], -c * dd[d]), tb[d]);
        tq[d] = fmaf(k, fmaf(pp, db[d], fmaf(-s, dd[d], -c * dpl[d])), tq[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      sa[d] += ta[d];
      sb[d] += tb[d];
      sq[d] += tq[d];
    }
    __syncthreads();
  }

  if (row_ok) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dp[(size_t)l * D + d] = ml * fmaf(u, sb[d], sa[d]);
      dq[(size_t)l * D + d] = ml * u * sq[d];
    }
  }
}

}  // namespace

extern "C" {

// q, p: (B, M, D) float32; m: (B, M); v, w: (B, M, D); dc: (B, M) per-row
// partials of the divergence cost.  Returns cudaGetLastError() after launch.
int difficp_rhs_self_fwd(const void* q, const void* p, const void* m, void* v,
                         void* w, void* dc, int B, int M, int D, float u,
                         int withlogdet, void* stream) {
  if (B <= 0 || M <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* pf = static_cast<const float*>(p);
  const auto* mf = static_cast<const float*>(m);
  auto* vf = static_cast<float*>(v);
  auto* wf = static_cast<float*>(w);
  auto* df = static_cast<float*>(dc);
  if (D == 2) {
    rhs_self_fwd_kernel<2><<<grid, kThreads, 0, s>>>(qf, pf, mf, vf, wf, df, M, u,
                                                     withlogdet);
  } else if (D == 3) {
    rhs_self_fwd_kernel<3><<<grid, kThreads, 0, s>>>(qf, pf, mf, vf, wf, df, M, u,
                                                     withlogdet);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// a, b: cotangents of v and w, (B, M, D); gc: (B,) cotangent of each frame's
// dcost, on the device.  Writes dq, dp (B, M, D).
int difficp_rhs_self_bwd(const void* q, const void* p, const void* m,
                         const void* a, const void* b, const void* gc, void* dq,
                         void* dp, int B, int M, int D, float u, int withlogdet,
                         void* stream) {
  if (B <= 0 || M <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* pf = static_cast<const float*>(p);
  const auto* mf = static_cast<const float*>(m);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  const auto* cf = static_cast<const float*>(gc);
  auto* dqf = static_cast<float*>(dq);
  auto* dpf = static_cast<float*>(dp);
  if (D == 2) {
    rhs_self_bwd_kernel<2><<<grid, kThreads, 0, s>>>(qf, pf, mf, af, bf, cf, dqf,
                                                     dpf, M, u, withlogdet);
  } else if (D == 3) {
    rhs_self_bwd_kernel<3><<<grid, kThreads, 0, s>>>(qf, pf, mf, af, bf, cf, dqf,
                                                     dpf, M, u, withlogdet);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
