// Top-2 smallest squared distances (the KeOps Kmin(2) role) for sm_90a.
// Plain C interface, loaded with ctypes by difficp_torch/ops/kmin2.py.
//
// Per frame b: for every x_i, (m1_i, m2_i) = the two smallest |x_i - y_j|^2
// over the y_j with mask_j > 0, as a multiset (two equal minima give
// m2 = m1), +inf where fewer remain.  With exclude_self the pair j == i is
// skipped (x is y: the nearest neighbour other than the point itself).
//
// Replaces the TPU kernel _kmin2_kernel (via kmin2_pallas) of
// difficp_tpu/ops/pallas_reductions.py.  It serves the coverage check of the
// grid-support registration (every time step of every frame in one launch:
// all leading axes are frames) and second_min_sqdist above the dense pair
// limit.
//
// What bounds it on an H100: FP32 operations, 3 d + 2 a pair (the distance
// and three min/max updates); no exponential, and O((N + M) d) bytes.
//
// What the design does about it: one thread owns one x row and keeps
// (m1, m2) in registers; a block of 128 rows stages 128-row tiles of
// (y, mask) in shared memory.  The update is branch-free:
// m2 = min(m2, max(m1, d)), m1 = min(m1, d), which is the JAX kernel's
// "knock out one instance of the minimum" rule taken one element at a time.

#include <math.h>

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(kThreads)
kmin2_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const float* __restrict__ my, float* __restrict__ m1,
             float* __restrict__ m2, int N, int M, int exclude_self) {
  constexpr int NF = D + 1;  // record: y_j, mask_j
  constexpr int NV = Record<NF>::kWords;
  __shared__ float4 tile[kThreads * NV];

  const size_t frame = blockIdx.y;
  x += frame * N * D;
  y += frame * M * D;
  my += frame * M;
  m1 += frame * N;
  m2 += frame * N;

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool row_ok = i < N;
  float xi[D];
#pragma unroll
  for (int d = 0; d < D; ++d) xi[d] = row_ok ? x[(size_t)i * D + d] : 0.f;
  const int self = exclude_self ? i : -1;

  float a1 = INFINITY, a2 = INFINITY;
  for (int base = 0; base < M; base += kThreads) {
    const int j = base + threadIdx.x;
    float rec[NF];
    if (j < M) {
#pragma unroll
      for (int d = 0; d < D; ++d) rec[d] = y[(size_t)j * D + d];
      rec[D] = my[j];
    } else {
#pragma unroll
      for (int e = 0; e < NF; ++e) rec[e] = 0.f;
    }
    store_record<NF>(&tile[threadIdx.x * NV], rec);
    __syncthreads();

    const int n = min(kThreads, M - base);
#pragma unroll 4
    for (int jj = 0; jj < n; ++jj) {
      float f[4 * NV];
      load_record<NF>(&tile[jj * NV], f);
      float r2 = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float dd = xi[d] - f[d];
        r2 = fmaf(dd, dd, r2);
      }
      const bool ok = f[D] > 0.f && base + jj != self;
      r2 = ok ? r2 : INFINITY;
      a2 = fminf(a2, fmaxf(a1, r2));
      a1 = fminf(a1, r2);
    }
    __syncthreads();
  }

  if (row_ok) {
    m1[i] = a1;
    m2[i] = a2;
  }
}

}  // namespace

extern "C" {

// x: (B, N, D), y: (B, M, D), my: (B, M), all float32.  Writes m1, m2
// (B, N).  exclude_self needs N == M.  Returns cudaGetLastError().
int difficp_kmin2(const void* x, const void* y, const void* my, void* m1,
                  void* m2, int B, int N, int M, int D, int exclude_self,
                  void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (exclude_self && N != M) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  const auto* mf = static_cast<const float*>(my);
  auto* o1 = static_cast<float*>(m1);
  auto* o2 = static_cast<float*>(m2);
  if (D == 2) {
    kmin2_kernel<2><<<grid, kThreads, 0, s>>>(xf, yf, mf, o1, o2, N, M, exclude_self);
  } else if (D == 3) {
    kmin2_kernel<3><<<grid, kThreads, 0, s>>>(xf, yf, mf, o1, o2, N, M, exclude_self);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
