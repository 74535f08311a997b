// Fused LDDMM right-hand side (forward, any eta; rows against columns) and the
// self VJP at eta = 0 (backward), for sm_90a.  Plain C interface, loaded with
// ctypes by difficp_torch/ops/rhs_self.py and ops/rhs_cross.py.
//
// Notation: u = 1/sigma^2, k_ij = exp(-u |q_i - q_j|^2 / 2), d_ij = q_i - q_j,
// r2 = |d_ij|^2, c_ij = p_i - p_j, m the point mask.  Per frame b of a batch,
// rows i = 0..M-1 of (q, p, m) against columns j = 0..N-1 of (qc, pc, mc); the
// self RHS is the case (qc, pc, mc) = (q, p, m), N = M:
//
//   forward   v_i  = m_i sum_j m_j k_ij p_j
//             w_i  = u m_i sum_j m_j k_ij (p_i.p_j) d_ij           (= -Gq)
//             dc_i = -u m_i sum_j m_j k_ij (p_i.d_ij)  (0 without logdet)
//   and with the gradcomponent field (eta != 0; reference LDDMM.py:113-116,
//   196-216) the added terms
//             v_i  += eta u m_i sum_j m_j k_ij d_ij
//             w_i  += eta m_i sum_j m_j k_ij [u^2 (d_ij.c_ij) d_ij - u c_ij]
//                     - eta^2 u^2 m_i sum_j m_j k_ij (u r2 - (D + 2)) d_ij
//             dc_i += eta u m_i sum_j m_j k_ij (u r2 - D)
//   backward  (self only; cotangents a of v, b of w, c of sum_i dc_i)
//             dp_l = m_l sum_j m_j k_lj [a_j + u ((b_l-b_j).d_lj) p_j - u c d_lj]
//             dq_l = m_l u sum_j m_j k_lj [-S_lj d_lj + (p_l.p_j)(b_l-b_j)
//                                          - c (p_l-p_j)]
//             S_lj = a_l.p_j + a_j.p_l + u (p_l.p_j)((b_l-b_j).d_lj)
//                    - u c ((p_l-p_j).d_lj)
//
// Replaces the TPU kernels of difficp_tpu/ops/pallas_reductions.py:
//   forward:  _rhs_self_sym_mm_kernel (via _rhs_self_fwd_sym_mm),
//             _rhs_self_sym_pair_kernel mode="fwd" (via _sym_block_tables),
//             _rhs_self_mm_kernel (via _rhs_self_fwd_mm, and between two sets
//             via _rhs_cross_fwd_mm, the ring rotation's body at eta = 0); and,
//             as the ETA instance, the any-eta streaming _rhs_self_kernel (via
//             _rhs_self_fwd_pallas, and between two sets via
//             _rhs_cross_fwd_stream);
//   backward: _rhs_self_bwd_mm_kernel (via _rhs_self_bwd_mm),
//             _rhs_self_sym_pair_kernel mode="bwd" (via _sym_block_grads).
//
// What bounds it on an H100: arithmetic.  The self function needs 32 FP32
// operations per unordered pair forward at d = 2 (15 d + 2, an FMA counted as
// two, each term shared by (i, j) and (j, i) once) and 71 backward (34 d + 3):
// see fwd_ops_per_unordered_pair and bwd_ops_per_unordered_pair in
// ops/rhs_self.py.  Between two sets no term is shared: 11 d per ordered pair
// forward (ops/rhs_cross.py, cross_fwd_ops_per_pair).  It needs one
// exponential per unordered (self) or ordered (cross) pair, on the MUFU ex2
// unit (16 per SM per clock), which takes about half as long as the FP32
// work forward.  The bytes moved are O((M + N) d), a few MB.  The kernels
// take each ordered pair apart, 11 d + 5 FP32 operations forward and 29 d + 7
// backward, and one exponential each (exp2f of a prescaled argument): for the
// self RHS at d = 2, 1.69 and 1.83 times the least FP32 work and twice the
// exponentials.
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
// re-centering of the coordinates (the cross forward's _mm_center) is needed
// here.  The forward kernel takes the column set apart from the rows: the
// self entry passes its own arrays as both, so the self outputs are those of
// the kernel before it took two sets, bit for bit.
//
// eta is a template switch: the ETA = false instance is the eta = 0 kernel
// as it was, and the ETA = true instance adds five sums in the same pass
// (sum k, sum k d, sum k r2, sum k r2 d, sum k (d.c) d) and combines them per
// row at the end, so at eta = 0 its v, w and dc equal the ETA = false ones
// bit for bit.  The gradcomponent terms add 24 D + 4 FP32 operations per
// unordered pair to the self function's least work (ops/rhs_self.py,
// fwd_eta_ops_per_unordered_pair); the kernel adds about 7 D + 3 per ordered
// pair, and still one exponential.

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

template <int D, bool ETA>
__global__ void __launch_bounds__(kThreads)
rhs_fwd_kernel(const float* __restrict__ q, const float* __restrict__ p,
               const float* __restrict__ m, const float* __restrict__ qc,
               const float* __restrict__ pc, const float* __restrict__ mc,
               float* __restrict__ v, float* __restrict__ w, float* __restrict__ dc,
               int M, int N, float u, int withlogdet, float eta) {
  constexpr int NF = 2 * D + 1;  // record: q_j, p_j, m_j
  constexpr int NV = Record<NF>::kWords;
  __shared__ float4 tile[kThreads * NV];

  const size_t frame = blockIdx.y;
  q += frame * M * D;
  p += frame * M * D;
  m += frame * M;
  qc += frame * N * D;
  pc += frame * N * D;
  mc += frame * N;
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
  // gradcomponent sums: k, k r2, k d, k r2 d, k (d.c) d
  float ek = 0.f, ekr2 = 0.f, ekd[D], ekr2d[D], ekdc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) ekd[d] = ekr2d[d] = ekdc[d] = 0.f;

  for (int base = 0; base < N; base += kThreads) {
    const int j = base + threadIdx.x;
    float rec[NF];
    if (j < N) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        rec[d] = qc[(size_t)j * D + d];
        rec[D + d] = pc[(size_t)j * D + d];
      }
      rec[2 * D] = mc[j];
    } else {
#pragma unroll
      for (int e = 0; e < NF; ++e) rec[e] = 0.f;  // m_j = 0: no contribution
    }
    store_record<NF>(&tile[threadIdx.x * NV], rec);
    __syncthreads();

    float tv[D], tw[D], tdc = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) tv[d] = tw[d] = 0.f;
    float tk = 0.f, tkr2 = 0.f, tkd[D], tkr2d[D], tkdc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) tkd[d] = tkr2d[d] = tkdc[d] = 0.f;
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
      if constexpr (ETA) {
        float dcv = 0.f;  // d.c = d.p_i - d.p_j
#pragma unroll
        for (int d = 0; d < D; ++d) dcv = fmaf(dd[d], pi[d] - f[D + d], dcv);
        const float kr2 = k * r2;
        const float kdc = k * dcv;
        tk += k;
        tkr2 += kr2;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          tkd[d] = fmaf(k, dd[d], tkd[d]);
          tkr2d[d] = fmaf(kr2, dd[d], tkr2d[d]);
          tkdc[d] = fmaf(kdc, dd[d], tkdc[d]);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      av[d] += tv[d];
      aw[d] += tw[d];
    }
    adc += tdc;
    if constexpr (ETA) {
      ek += tk;
      ekr2 += tkr2;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        ekd[d] += tkd[d];
        ekr2d[d] += tkr2d[d];
        ekdc[d] += tkdc[d];
      }
    }
    __syncthreads();
  }

  if (row_ok) {
    if constexpr (ETA) {
      // sum_j k c_j = p_i sum k - sum k p_j;  sum k (u r2 - (D + 2)) d
      const float eu = eta * u;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float lap = fmaf(u, ekr2d[d], -(D + 2) * ekd[d]);
        const float kc = fmaf(pi[d], ek, -av[d]);
        const float extra = eu * (fmaf(u, ekdc[d], -kc) - eta * u * lap);
        // the eta = 0 parts as the ETA = false branch forms them
        v[(size_t)i * D + d] = fmaf(mi * eu, ekd[d], mi * av[d]);
        w[(size_t)i * D + d] = fmaf(mi, extra, u * mi * aw[d]);
      }
      dc[i] = withlogdet ? fmaf(mi * eu, fmaf(u, ekr2, -D * ek), -u * mi * adc) : 0.f;
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        v[(size_t)i * D + d] = mi * av[d];
        w[(size_t)i * D + d] = u * mi * aw[d];
      }
      dc[i] = withlogdet ? -u * mi * adc : 0.f;
    }
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

int launch_fwd(const void* q, const void* p, const void* m, const void* qc,
               const void* pc, const void* mc, void* v, void* w, void* dc, int B,
               int M, int N, int D, float u, int withlogdet, float eta, int use_eta,
               void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* pf = static_cast<const float*>(p);
  const auto* mf = static_cast<const float*>(m);
  const auto* qcf = static_cast<const float*>(qc);
  const auto* pcf = static_cast<const float*>(pc);
  const auto* mcf = static_cast<const float*>(mc);
  auto* vf = static_cast<float*>(v);
  auto* wf = static_cast<float*>(w);
  auto* df = static_cast<float*>(dc);
  if (D == 2 && use_eta) {
    rhs_fwd_kernel<2, true><<<grid, kThreads, 0, s>>>(qf, pf, mf, qcf, pcf, mcf, vf, wf,
                                                      df, M, N, u, withlogdet, eta);
  } else if (D == 2) {
    rhs_fwd_kernel<2, false><<<grid, kThreads, 0, s>>>(qf, pf, mf, qcf, pcf, mcf, vf, wf,
                                                       df, M, N, u, withlogdet, 0.f);
  } else if (D == 3 && use_eta) {
    rhs_fwd_kernel<3, true><<<grid, kThreads, 0, s>>>(qf, pf, mf, qcf, pcf, mcf, vf, wf,
                                                      df, M, N, u, withlogdet, eta);
  } else if (D == 3) {
    rhs_fwd_kernel<3, false><<<grid, kThreads, 0, s>>>(qf, pf, mf, qcf, pcf, mcf, vf, wf,
                                                       df, M, N, u, withlogdet, 0.f);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, p: (B, M, D) float32; m: (B, M); v, w: (B, M, D); dc: (B, M) per-row
// partials of the divergence cost; the gradcomponent terms of eta when use_eta
// is nonzero (the ETA instance; use_eta = 0 runs the eta = 0 kernel).  The
// rows are their own columns.  Returns cudaGetLastError() after launch.
int difficp_rhs_self_fwd_eta(const void* q, const void* p, const void* m, void* v,
                             void* w, void* dc, int B, int M, int D, float u,
                             int withlogdet, float eta, int use_eta, void* stream) {
  return launch_fwd(q, p, m, q, p, m, v, w, dc, B, M, M, D, u, withlogdet, eta,
                    use_eta, stream);
}

// The rows (qr, pr, mr: (B, M, D), (B, M)) against the columns (qc, pc, mc:
// (B, N, D), (B, N)); outputs as difficp_rhs_self_fwd_eta's, one per row.
int difficp_rhs_cross_fwd(const void* qr, const void* pr, const void* mr,
                          const void* qc, const void* pc, const void* mc, void* v,
                          void* w, void* dc, int B, int M, int N, int D, float u,
                          int withlogdet, float eta, int use_eta, void* stream) {
  return launch_fwd(qr, pr, mr, qc, pc, mc, v, w, dc, B, M, N, D, u, withlogdet, eta,
                    use_eta, stream);
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
