// External-point LDDMM right-hand side: the cross terms between data points x
// (advected by the flow) and the support (q, p), forward (any eta) and VJP
// (eta = 0), for sm_90a.  Plain C interface, loaded with ctypes by
// difficp_torch/ops/rhs_ext.py.
//
// Notation: u = 1/sigma^2, k_ij = exp(-u |x_i - q_j|^2 / 2), delta_ij =
// x_i - q_j, e_li = q_l - x_i, masks mx (data) and mq (support).  Per frame b
// of a batch, data rows 0..N-1, support rows 0..M-1:
//
//   forward   vx_i = mx_i sum_j mq_j k_ij p_j
//             dc_i = u mx_i sum_j mq_j k_ij (p_j.delta_ij)  (0 without logdet)
//             and with the gradcomponent field (eta != 0; reference
//             LDDMM.py:113-138) the added terms, r2 = |delta_ij|^2:
//             vx_i += eta u mx_i sum_j mq_j k_ij delta_ij
//             dc_i += eta u mx_i sum_j mq_j k_ij (u r2 - D)
//   dx        (cotangents gx of vx, gc of sum_i dc_i; Gx_i = mx_i gx_i)
//             dx_l = -u sum_j mq_j k_lj [(Gx_l + c_l delta_lj).p_j] delta_lj
//                    + c_l sum_j mq_j k_lj p_j,            c_l = gc u mx_l
//   dq, dp    dq_l = mq_l sum_i k_il [-u (Gx_i.p_l) + gc u^2 mx_i (p_l.e_li)] e_li
//                    - gc u mq_l (sum_i k_il mx_i) p_l
//             dp_l = mq_l sum_i k_il Gx_i - gc u mq_l sum_i k_il mx_i e_li
//
// (docs/MATH.md, "Ext RHS".)  Replaces the TPU kernels of
// difficp_tpu/ops/pallas_reductions.py:
//   forward:  _vx_mm_kernel (via _vx_fwd_pallas, eta = 0) and, as the ETA
//             instance, the any-eta streaming _vx_kernel (via _vx_fwd_pallas);
//   dx:       _ext_bwd_dx_mm_kernel   } both via _ext_bwd_pallas
//   dq, dp:   _ext_bwd_dqdp_mm_kernel }
//
// What bounds them on an H100: operations.  Every (x, q) pair costs one
// exponential on the MUFU ex2 unit (16 per SM per clock, 1/16 of the FP32
// lanes' rate) and 5 d + 1 (forward), 9 d + 1 (dx) and 9 d + 3 (dq, dp)
// FP32 operations at least (term lists in ops/rhs_ext.py): at d = 2 the
// exponential alone takes longer than the forward's FP32 work.  The bytes
// are O((N + M) d) per frame.  On the grid-support path the support is small
// (M ~ 342 at sigma = 0.05) and the data long (N = 65,536), so the work per
// launch is small (~2.2e8 pairs over 10 frames) and the launches are short.
//
// What the design does about it: a direct pair sum, as in rhs_self.cu.
// - forward and dx: one thread owns one data row in registers; a block of
//   128 rows stages 128-column tiles of the support (q, p, mq) in shared
//   memory; all sums stay in registers.  K x ceil(N / 128) blocks fill the
//   card.
// - dq, dp: the outputs are the short side (M support rows) and each sum
//   runs over the long side (N data points).  One thread per support row
//   would give K M / 128 ~ 27 blocks for 132 SMs, each thread looping over
//   65,536 points.  So the data axis is cut into chunks on a second grid
//   axis; each block writes its chunk's partial dq, dp, and the wrapper sums
//   the chunks in a fixed order: no float atomics, results reproducible.
// The TPU's payload-matmul tables and their per-frame re-centering
// (_mm_center) exist to feed its matrix unit; the direct form works in
// differences only, so neither is needed here.
// eta is a template switch of the forward: the ETA = false instance is the
// eta = 0 kernel as it was; the ETA = true instance adds three sums in the
// same pass (sum k, sum k r2, sum k delta), combined per row at the end, so
// that at eta = 0 it gives the ETA = false results bit for bit.  The
// gradcomponent terms add 2 D + 3 FP32 operations per pair to the function's
// least work (ops/rhs_ext.py, fwd_eta_ops_per_pair), still one exponential.

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

template <int D, bool ETA>
__global__ void __launch_bounds__(kThreads)
rhs_ext_fwd_kernel(const float* __restrict__ x, const float* __restrict__ mx,
                   const float* __restrict__ q, const float* __restrict__ p,
                   const float* __restrict__ mq, float* __restrict__ vx,
                   float* __restrict__ dc, int N, int M, float u,
                   int withlogdet, float eta) {
  constexpr int NF = 2 * D + 1;  // record: q_j, p_j, mq_j
  constexpr int NV = Record<NF>::kWords;
  __shared__ float4 tile[kThreads * NV];

  const size_t frame = blockIdx.y;
  x += frame * N * D;
  mx += frame * N;
  vx += frame * N * D;
  dc += frame * N;
  q += frame * M * D;
  p += frame * M * D;
  mq += frame * M;

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool row_ok = i < N;
  float xi[D];
#pragma unroll
  for (int d = 0; d < D; ++d) xi[d] = row_ok ? x[(size_t)i * D + d] : 0.f;
  const float mi = row_ok ? mx[i] : 0.f;
  const float c2 = -0.5f * u * kLog2e;

  float av[D], adc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) av[d] = 0.f;
  // gradcomponent sums: k, k r2, k delta
  float ek = 0.f, ekr2 = 0.f, ekd[D];
#pragma unroll
  for (int d = 0; d < D; ++d) ekd[d] = 0.f;

  for (int base = 0; base < M; base += kThreads) {
    const int j = base + threadIdx.x;
    float rec[NF];
    if (j < M) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        rec[d] = q[(size_t)j * D + d];
        rec[D + d] = p[(size_t)j * D + d];
      }
      rec[2 * D] = mq[j];
    } else {
#pragma unroll
      for (int e = 0; e < NF; ++e) rec[e] = 0.f;
    }
    store_record<NF>(&tile[threadIdx.x * NV], rec);
    __syncthreads();

    const int n = min(kThreads, M - base);
    float tv[D], tdc = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) tv[d] = 0.f;
    float tk = 0.f, tkr2 = 0.f, tkd[D];
#pragma unroll
    for (int d = 0; d < D; ++d) tkd[d] = 0.f;
#pragma unroll 4
    for (int jj = 0; jj < n; ++jj) {
      float f[4 * NV];
      load_record<NF>(&tile[jj * NV], f);
      float dd[D];
      float r2 = 0.f, pd = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dd[d] = xi[d] - f[d];
        r2 = fmaf(dd[d], dd[d], r2);
        pd = fmaf(f[D + d], dd[d], pd);
      }
      const float k = f[2 * D] * exp2f(c2 * r2);
#pragma unroll
      for (int d = 0; d < D; ++d) tv[d] = fmaf(k, f[D + d], tv[d]);
      tdc = fmaf(k, pd, tdc);
      if constexpr (ETA) {
        tk += k;
        tkr2 = fmaf(k, r2, tkr2);
#pragma unroll
        for (int d = 0; d < D; ++d) tkd[d] = fmaf(k, dd[d], tkd[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) av[d] += tv[d];
    adc += tdc;
    if constexpr (ETA) {
      ek += tk;
      ekr2 += tkr2;
#pragma unroll
      for (int d = 0; d < D; ++d) ekd[d] += tkd[d];
    }
    __syncthreads();
  }

  if (row_ok) {
    if constexpr (ETA) {
      // the eta = 0 parts as the ETA = false branch forms them
      const float me = mi * eta * u;
#pragma unroll
      for (int d = 0; d < D; ++d) vx[(size_t)i * D + d] = fmaf(me, ekd[d], mi * av[d]);
      dc[i] = withlogdet ? fmaf(me, fmaf(u, ekr2, -D * ek), u * mi * adc) : 0.f;
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) vx[(size_t)i * D + d] = mi * av[d];
      dc[i] = withlogdet ? u * mi * adc : 0.f;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
rhs_ext_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ mx,
                      const float* __restrict__ gx, const float* __restrict__ q,
                      const float* __restrict__ p, const float* __restrict__ mq,
                      const float* __restrict__ gc, float* __restrict__ dx,
                      int N, int M, float u, int withlogdet) {
  constexpr int NF = 2 * D + 1;  // record: q_j, p_j, mq_j
  constexpr int NV = Record<NF>::kWords;
  __shared__ float4 tile[kThreads * NV];

  const size_t frame = blockIdx.y;
  x += frame * N * D;
  mx += frame * N;
  gx += frame * N * D;
  dx += frame * N * D;
  q += frame * M * D;
  p += frame * M * D;
  mq += frame * M;
  // the cotangent of the frame's dcost, read on the device: no host sync
  const float gcb = withlogdet ? gc[frame] : 0.f;

  const int l = blockIdx.x * kThreads + threadIdx.x;
  const bool row_ok = l < N;
  const float ml = row_ok ? mx[l] : 0.f;
  float xl[D], gl[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    xl[d] = row_ok ? x[(size_t)l * D + d] : 0.f;
    gl[d] = row_ok ? ml * gx[(size_t)l * D + d] : 0.f;  // Gx_l
  }
  const float cl = gcb * u * ml;
  const float c2 = -0.5f * u * kLog2e;

  float ae[D], ap[D];
#pragma unroll
  for (int d = 0; d < D; ++d) ae[d] = ap[d] = 0.f;

  for (int base = 0; base < M; base += kThreads) {
    const int j = base + threadIdx.x;
    float rec[NF];
    if (j < M) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        rec[d] = q[(size_t)j * D + d];
        rec[D + d] = p[(size_t)j * D + d];
      }
      rec[2 * D] = mq[j];
    } else {
#pragma unroll
      for (int e = 0; e < NF; ++e) rec[e] = 0.f;
    }
    store_record<NF>(&tile[threadIdx.x * NV], rec);
    __syncthreads();

    const int n = min(kThreads, M - base);
    float te[D], tp[D];
#pragma unroll
    for (int d = 0; d < D; ++d) te[d] = tp[d] = 0.f;
#pragma unroll 4
    for (int jj = 0; jj < n; ++jj) {
      float f[4 * NV];
      load_record<NF>(&tile[jj * NV], f);
      float dd[D];
      float r2 = 0.f, wp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dd[d] = xl[d] - f[d];
        r2 = fmaf(dd[d], dd[d], r2);
        wp = fmaf(fmaf(cl, dd[d], gl[d]), f[D + d], wp);  // (Gx_l + c_l delta).p_j
      }
      const float k = f[2 * D] * exp2f(c2 * r2);
      const float coef = k * wp;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        te[d] = fmaf(coef, dd[d], te[d]);
        tp[d] = fmaf(k, f[D + d], tp[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ae[d] += te[d];
      ap[d] += tp[d];
    }
    __syncthreads();
  }

  if (row_ok) {
#pragma unroll
    for (int d = 0; d < D; ++d) dx[(size_t)l * D + d] = fmaf(-u, ae[d], cl * ap[d]);
  }
}

// One block: 128 support rows against the data rows [chunk * L, chunk * L +
// L) of its frame.  Writes that chunk's partial dq, dp to
// part[(frame * C + chunk) * M * D + l * D + d].
template <int D>
__global__ void __launch_bounds__(kThreads)
rhs_ext_bwd_dqdp_kernel(const float* __restrict__ x, const float* __restrict__ mx,
                        const float* __restrict__ gx, const float* __restrict__ q,
                        const float* __restrict__ p, const float* __restrict__ mq,
                        const float* __restrict__ gc, float* __restrict__ dq_part,
                        float* __restrict__ dp_part, int N, int M, int L, float u,
                        int withlogdet) {
  constexpr int NF = 2 * D + 1;  // record: x_i, Gx_i, mx_i
  constexpr int NV = Record<NF>::kWords;
  __shared__ float4 tile[kThreads * NV];

  const size_t frame = blockIdx.z;
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  x += frame * N * D;
  mx += frame * N;
  gx += frame * N * D;
  q += frame * M * D;
  p += frame * M * D;
  mq += frame * M;
  const size_t part = (frame * n_chunks + chunk) * (size_t)M * D;
  dq_part += part;
  dp_part += part;
  const float cg = (withlogdet ? gc[frame] : 0.f) * u;

  const int l = blockIdx.x * kThreads + threadIdx.x;
  const bool row_ok = l < M;
  float ql[D], pl[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    ql[d] = row_ok ? q[(size_t)l * D + d] : 0.f;
    pl[d] = row_ok ? p[(size_t)l * D + d] : 0.f;
  }
  const float ml = row_ok ? mq[l] : 0.f;
  const float c2 = -0.5f * u * kLog2e;

  float ae[D], ag[D], ame[D], akm = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) ae[d] = ag[d] = ame[d] = 0.f;

  const int lo = chunk * L;
  const int hi = min(N, lo + L);
  for (int base = lo; base < hi; base += kThreads) {
    const int i = base + threadIdx.x;
    float rec[NF];
    if (i < hi) {
      const float m = mx[i];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        rec[d] = x[(size_t)i * D + d];
        rec[D + d] = m * gx[(size_t)i * D + d];  // Gx_i
      }
      rec[2 * D] = m;
    } else {
#pragma unroll
      for (int e = 0; e < NF; ++e) rec[e] = 0.f;
    }
    store_record<NF>(&tile[threadIdx.x * NV], rec);
    __syncthreads();

    const int n = min(kThreads, hi - base);
    float te[D], tg[D], tme[D], tkm = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) te[d] = tg[d] = tme[d] = 0.f;
#pragma unroll 4
    for (int ii = 0; ii < n; ++ii) {
      float f[4 * NV];
      load_record<NF>(&tile[ii * NV], f);
      float e[D];
      float r2 = 0.f, gp = 0.f, pe = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        e[d] = ql[d] - f[d];
        r2 = fmaf(e[d], e[d], r2);
        gp = fmaf(f[D + d], pl[d], gp);
        pe = fmaf(pl[d], e[d], pe);
      }
      const float k = exp2f(c2 * r2);
      const float km = k * f[2 * D];
      const float coef = fmaf(-u, k * gp, cg * u * km * pe);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        te[d] = fmaf(coef, e[d], te[d]);
        tg[d] = fmaf(k, f[D + d], tg[d]);
        tme[d] = fmaf(km, e[d], tme[d]);
      }
      tkm += km;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      ae[d] += te[d];
      ag[d] += tg[d];
      ame[d] += tme[d];
    }
    akm += tkm;
    __syncthreads();
  }

  if (row_ok) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dq_part[(size_t)l * D + d] = ml * fmaf(-cg, akm * pl[d], ae[d]);
      dp_part[(size_t)l * D + d] = ml * fmaf(-cg, ame[d], ag[d]);
    }
  }
}

}  // namespace

extern "C" {

// x: (B, N, D), mx: (B, N); q, p: (B, M, D), mq: (B, M), all float32.
// Writes vx (B, N, D) and dc (B, N), the per-row partials of the divergence
// cost; the gradcomponent terms of eta when use_eta is nonzero (the ETA
// instance; use_eta = 0 runs the eta = 0 kernel).  Returns cudaGetLastError()
// after the launch.
int difficp_rhs_ext_fwd_eta(const void* x, const void* mx, const void* q,
                            const void* p, const void* mq, void* vx, void* dc,
                            int B, int N, int M, int D, float u, int withlogdet,
                            float eta, int use_eta, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* mxf = static_cast<const float*>(mx);
  const auto* qf = static_cast<const float*>(q);
  const auto* pf = static_cast<const float*>(p);
  const auto* mqf = static_cast<const float*>(mq);
  auto* vf = static_cast<float*>(vx);
  auto* df = static_cast<float*>(dc);
  if (D == 2 && use_eta) {
    rhs_ext_fwd_kernel<2, true><<<grid, kThreads, 0, s>>>(xf, mxf, qf, pf, mqf, vf,
                                                          df, N, M, u, withlogdet, eta);
  } else if (D == 2) {
    rhs_ext_fwd_kernel<2, false><<<grid, kThreads, 0, s>>>(xf, mxf, qf, pf, mqf, vf,
                                                           df, N, M, u, withlogdet, 0.f);
  } else if (D == 3 && use_eta) {
    rhs_ext_fwd_kernel<3, true><<<grid, kThreads, 0, s>>>(xf, mxf, qf, pf, mqf, vf,
                                                          df, N, M, u, withlogdet, eta);
  } else if (D == 3) {
    rhs_ext_fwd_kernel<3, false><<<grid, kThreads, 0, s>>>(xf, mxf, qf, pf, mqf, vf,
                                                           df, N, M, u, withlogdet, 0.f);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// gx: (B, N, D) cotangent of vx; gc: (B,) cotangent of each frame's dcost, on
// the device.  Writes dx (B, N, D).
int difficp_rhs_ext_bwd_dx(const void* x, const void* mx, const void* gx,
                           const void* q, const void* p, const void* mq,
                           const void* gc, void* dx, int B, int N, int M, int D,
                           float u, int withlogdet, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* mxf = static_cast<const float*>(mx);
  const auto* gxf = static_cast<const float*>(gx);
  const auto* qf = static_cast<const float*>(q);
  const auto* pf = static_cast<const float*>(p);
  const auto* mqf = static_cast<const float*>(mq);
  const auto* gcf = static_cast<const float*>(gc);
  auto* dxf = static_cast<float*>(dx);
  if (D == 2) {
    rhs_ext_bwd_dx_kernel<2><<<grid, kThreads, 0, s>>>(xf, mxf, gxf, qf, pf, mqf,
                                                       gcf, dxf, N, M, u, withlogdet);
  } else if (D == 3) {
    rhs_ext_bwd_dx_kernel<3><<<grid, kThreads, 0, s>>>(xf, mxf, gxf, qf, pf, mqf,
                                                       gcf, dxf, N, M, u, withlogdet);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// As difficp_rhs_ext_bwd_dx; the data axis is cut into C = ceil(N / L)
// chunks of L rows.  Writes the per-chunk partials dq_part, dp_part
// (B, C, M, D); their sum over C is (dq, dp).
int difficp_rhs_ext_bwd_dqdp(const void* x, const void* mx, const void* gx,
                             const void* q, const void* p, const void* mq,
                             const void* gc, void* dq_part, void* dp_part, int B,
                             int N, int M, int D, int L, float u, int withlogdet,
                             void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || L <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (N + L - 1) / L;
  if (n_chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kThreads - 1) / kThreads, n_chunks, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* mxf = static_cast<const float*>(mx);
  const auto* gxf = static_cast<const float*>(gx);
  const auto* qf = static_cast<const float*>(q);
  const auto* pf = static_cast<const float*>(p);
  const auto* mqf = static_cast<const float*>(mq);
  const auto* gcf = static_cast<const float*>(gc);
  auto* dqf = static_cast<float*>(dq_part);
  auto* dpf = static_cast<float*>(dp_part);
  if (D == 2) {
    rhs_ext_bwd_dqdp_kernel<2><<<grid, kThreads, 0, s>>>(
        xf, mxf, gxf, qf, pf, mqf, gcf, dqf, dpf, N, M, L, u, withlogdet);
  } else if (D == 3) {
    rhs_ext_bwd_dqdp_kernel<3><<<grid, kThreads, 0, s>>>(
        xf, mxf, gxf, qf, pf, mqf, gcf, dqf, dpf, N, M, L, u, withlogdet);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
