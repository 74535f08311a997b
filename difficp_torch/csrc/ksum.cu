// Generic Gaussian kernel-sum with a table of payload columns, for sm_90a.
// Plain C interface, loaded with ctypes by difficp_torch/ops/ksum.py.
//
// Per frame b, with u = 1/sigma^2, rows i of x (Nx points) and columns j of y
// (Ny points), the mask m of y and a payload table T of C columns:
//
//   A[c, i] = sum_j exp(-u |x_i - y_j|^2 / 2) m_j T[c, j]
//
// x: (B, Nx, D), y: (B, Ny, D) or (Ny, D) shared by every frame, m likewise
// (B, Ny) or (Ny) or none (all ones), T: (B, C, Ny) or (C, Ny) -- the table's
// rows are the payload columns, so that a warp's loads of one column are
// contiguous.  A: (B, S, C, Nx), where the y axis is cut into S splits of L
// columns; the wrapper sums the splits in a fixed order.
//
// Replaces the TPU kernels of difficp_tpu/ops/pallas_ksum.py:
//   _ksum_kernel (via pairwise_ksum), _ksum_blocked_kernel and
//   _ksum_blocked_scratch_kernel (via _pairwise_ksum_blocked: the same
//   function with the y block resident in VMEM), and _ksum_sym_pair_kernel
//   (via pairwise_ksum_sym: the self case x = y, here over ordered pairs).
//
// What bounds it on an H100: operations.  Per pair the function needs one
// exponential (MUFU) and 3 D - 1 + 2 C FP32 operations (ops/ksum.py,
// ops_per_pair); at C >= 9 the FP32 multiply-adds of the payload dominate.
// The bytes are O((Nx + Ny C) per frame), small beside that.
//
// What the design does about it:
// - (a) 121 or 333 accumulators do not fit in a thread's registers.  The
//   columns are split into chunks of CC <= 32 over a grid axis; a thread owns
//   R = 2 rows and one chunk, CC x R accumulators in registers (twice that with
//   the per-tile partial sums).  A chunk recomputes the exponentials of its
//   pairs: ceil(C / 32) exponentials per pair (4 at 121 columns, 11 at 333),
//   one exponential per R x CC = 64 multiply-adds at most.
// - A block of 128 threads covers 256 rows and stages 128-column tiles of y
//   (coordinates and mask as one float4) and of the chunk's payload in shared
//   memory; every thread reads the same record (a broadcast).  Sums are taken
//   per tile and then added to the running total.
// - (b) A short x side against a long y side (the support's dq/dp direction:
//   380 rows a frame against 65,536 columns) would leave most SMs idle, so
//   the y axis is also split over the grid; each split writes its partial
//   table and the wrapper sums them in a fixed order: no float atomics.
// The TPU's matrix-unit contraction of an exp tile with the table (and the
// symmetric variant's halved exponentials) is the natural later design here
// as a tensor-core (wgmma) product; this kernel is the plain direct form.

#include <cuda_runtime.h>

#include "tile.cuh"

namespace {

constexpr int kRows = 2;  // rows per thread

template <int D, int CC>
__global__ void __launch_bounds__(kThreads)
ksum_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ my, const float* __restrict__ t,
            float* __restrict__ out, int Nx, int Ny, int C, int L, int y_shared,
            float u) {
  static_assert(CC % 4 == 0 && CC <= 32, "CC: a multiple of 4, at most 32");
  constexpr int NV = CC / 4;
  __shared__ float4 ytile[kThreads];       // y_j (D coordinates), m_j
  __shared__ float4 ttile[kThreads * NV];  // T[c0 .. c0 + CC, j]

  const int n_chunks = (C + CC - 1) / CC;
  const int chunk = blockIdx.y % n_chunks;
  const int split = blockIdx.y / n_chunks;
  const int n_splits = gridDim.y / n_chunks;
  const size_t frame = blockIdx.z;
  const size_t fy = y_shared ? 0 : frame;
  x += frame * Nx * D;
  y += fy * Ny * D;
  if (my != nullptr) my += fy * Ny;
  t += fy * (size_t)C * Ny;
  out += (frame * n_splits + split) * (size_t)C * Nx;
  const int c0 = chunk * CC;
  const float c2 = -0.5f * u * kLog2e;

  int row[kRows];
  float xr[kRows][D];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    row[r] = blockIdx.x * (kThreads * kRows) + r * kThreads + threadIdx.x;
#pragma unroll
    for (int d = 0; d < D; ++d) xr[r][d] = row[r] < Nx ? x[(size_t)row[r] * D + d] : 0.f;
  }

  float acc[kRows][CC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[r][c] = 0.f;

  const int lo = split * L;
  const int hi = min(Ny, lo + L);
  for (int base = lo; base < hi; base += kThreads) {
    const int j = base + threadIdx.x;
    const bool col_ok = j < hi;
    float rec[4] = {0.f, 0.f, 0.f, 0.f};  // m_j = 0 past the end
    if (col_ok) {
#pragma unroll
      for (int d = 0; d < D; ++d) rec[d] = y[(size_t)j * D + d];
      rec[D] = my != nullptr ? my[j] : 1.f;
    }
    ytile[threadIdx.x] = make_float4(rec[0], rec[1], rec[2], rec[3]);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 4 * v + e;
        f[e] = (col_ok && c < C) ? t[(size_t)c * Ny + j] : 0.f;
      }
      ttile[threadIdx.x * NV + v] = make_float4(f[0], f[1], f[2], f[3]);
    }
    __syncthreads();

    const int n = min(kThreads, hi - base);
    float tacc[kRows][CC];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < CC; ++c) tacc[r][c] = 0.f;
#pragma unroll 2
    for (int jj = 0; jj < n; ++jj) {
      const float4 yr = ytile[jj];
      const float yv[4] = {yr.x, yr.y, yr.z, yr.w};
      float k[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float r2 = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float dd = xr[r][d] - yv[d];
          r2 = fmaf(dd, dd, r2);
        }
        k[r] = yv[D] * exp2f(c2 * r2);
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float4 tv = ttile[jj * NV + v];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          tacc[r][4 * v] = fmaf(k[r], tv.x, tacc[r][4 * v]);
          tacc[r][4 * v + 1] = fmaf(k[r], tv.y, tacc[r][4 * v + 1]);
          tacc[r][4 * v + 2] = fmaf(k[r], tv.z, tacc[r][4 * v + 2]);
          tacc[r][4 * v + 3] = fmaf(k[r], tv.w, tacc[r][4 * v + 3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < CC; ++c) acc[r][c] += tacc[r][c];
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row[r] >= Nx) continue;
#pragma unroll
    for (int c = 0; c < CC; ++c)
      if (c0 + c < C) out[(size_t)(c0 + c) * Nx + row[r]] = acc[r][c];
  }
}

template <int D, int CC>
void launch(dim3 grid, cudaStream_t s, const float* x, const float* y,
            const float* my, const float* t, float* out, int Nx, int Ny, int C,
            int L, int y_shared, float u) {
  ksum_kernel<D, CC><<<grid, kThreads, 0, s>>>(x, y, my, t, out, Nx, Ny, C, L,
                                               y_shared, u);
}

template <int D>
int launch_cc(int CC, dim3 grid, cudaStream_t s, const float* x, const float* y,
              const float* my, const float* t, float* out, int Nx, int Ny, int C,
              int L, int y_shared, float u) {
  switch (CC) {
    case 4: launch<D, 4>(grid, s, x, y, my, t, out, Nx, Ny, C, L, y_shared, u); break;
    case 8: launch<D, 8>(grid, s, x, y, my, t, out, Nx, Ny, C, L, y_shared, u); break;
    case 12: launch<D, 12>(grid, s, x, y, my, t, out, Nx, Ny, C, L, y_shared, u); break;
    case 16: launch<D, 16>(grid, s, x, y, my, t, out, Nx, Ny, C, L, y_shared, u); break;
    case 20: launch<D, 20>(grid, s, x, y, my, t, out, Nx, Ny, C, L, y_shared, u); break;
    case 24: launch<D, 24>(grid, s, x, y, my, t, out, Nx, Ny, C, L, y_shared, u); break;
    case 28: launch<D, 28>(grid, s, x, y, my, t, out, Nx, Ny, C, L, y_shared, u); break;
    case 32: launch<D, 32>(grid, s, x, y, my, t, out, Nx, Ny, C, L, y_shared, u); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, Nx, D); y: (B, Ny, D), or (Ny, D) with y_shared; my: like y without
// D, or null for all ones; t: (B, C, Ny) or (C, Ny).  Writes out (B, S, C, Nx)
// with S = ceil(Ny / L) splits of the y axis.  CC: columns per chunk, a
// multiple of 4 up to 32.  Returns cudaGetLastError() after the launch.
int difficp_ksum(const void* x, const void* y, const void* my, const void* t,
                 void* out, int B, int Nx, int Ny, int D, int C, int CC, int L,
                 int y_shared, float u, void* stream) {
  if (B <= 0 || Nx <= 0 || Ny <= 0 || C <= 0 || L <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (C + CC - 1) / CC;
  const int n_splits = (Ny + L - 1) / L;
  if ((long long)n_chunks * n_splits > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((Nx + kThreads * kRows - 1) / (kThreads * kRows),
                  n_chunks * n_splits, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  const auto* mf = static_cast<const float*>(my);
  const auto* tf = static_cast<const float*>(t);
  auto* of = static_cast<float*>(out);
  if (D == 2) return launch_cc<2>(CC, grid, s, xf, yf, mf, tf, of, Nx, Ny, C, L, y_shared, u);
  if (D == 3) return launch_cc<3>(CC, grid, s, xf, yf, mf, tf, of, Nx, Ny, C, L, y_shared, u);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
