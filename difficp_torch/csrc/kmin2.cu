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
// grid- and decim-support registration (every time step of every frame in
// one launch: all leading axes are frames) and second_min_sqdist above the
// dense pair limit.
//
// What bounds it on an H100: issue slots.  A pair at d = 2 is four FP32
// instructions (two FADD, FMUL, FFMA: |x_i - y_j|^2 in the difference
// form) and the two-minimum update, three min/max one pair at a time, for
// its 3 d + 2 = 8 FP32 operations: at best 4/7 of the FP32 peak.  The
// min/max issue at half FADD's rate on a pipe of their own (ops/kmin2.py
// ops_per_pair); no exponential, and O((N + M) d) bytes.
//
// What the design does about it:
// - Rows a thread: a block is kK2Warps warps over 32 kK2Warps R rows, row
//   row0 + t + 128 r in register slot r of thread t, so one shared-memory
//   record load (LDS.64 at d = 2) serves R pairs.
// - The mask folded into the staged tile: the block stages tiles of T = 128 R
//   columns, a masked or padded column with NaN coordinates.  Its squared
//   distance is NaN, and min.f32 / max.f32 return the other operand of a
//   NaN, so with the update written as
//       m2 = max(m1, min(m2, r)),  m1 = min(m1, r)
//   (the old m1 in the first; the JAX kernel's "knock out one instance of
//   the minimum" rule taken one element at a time, equal to
//   m2 = min(m2, max(m1, r)) for every r that is a number) a masked column
//   leaves (m1, m2) as they were, for any coordinates: no select a pair, no
//   sentinel distance to compare, +inf where fewer than two columns are
//   valid.  (A finite far sentinel would need every real distance below its
//   own and a compare of each output with it.)
// - Two columns a step in the integer domain: a squared distance is +0,
//   positive, +inf or a positive NaN, all of which order as their bits do
//   as int32 (a NaN above +inf, so an integer min passes over it too), and
//   Hopper's three-input integer min (__vimin3_s32, one VIMNMX3) takes the
//   update of (m1, m2) by the pair (r, s) in five instructions where one
//   column at a time takes six:
//       m1 = min3(m1, r, s),  m2 = min3(max(m1, min(r, s)), m2, max(r, s))
//   (the second smallest of two sorted pairs; the old m1 in both).  The
//   loop over a tile's columns is unrolled by 16; a frame's last tile runs
//   to its columns rounded up to 16, the rest staged as NaN.
// - Self-exclusion as a template parameter: with EXCL the tiles are aligned
//   to the block's rows, and only the one tile that holds the block's own
//   indices (base == row0) runs the loop that replaces the pair j == i by
//   NaN; every other tile runs the plain loop.
// - One launch shape: a block a row block of a frame (grid: row blocks x
//   frames), each block over all of its frame's columns.  The result is one
//   sequence of exact min/max, so two launches give the same bits.

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kK2Warps = 4;                // warps a block
constexpr int kK2Threads = 32 * kK2Warps;  // threads a block
constexpr int kK2Rows = 4;                 // rows a thread (ops/kmin2.py ROWS_PER_THREAD)
constexpr int kK2Tile = kK2Threads * kK2Rows;  // rows a block, columns a tile
constexpr int kK2MinBlocks = 8;            // blocks an SM (ops/kmin2.py BLOCKS_PER_SM)
constexpr int kK2Unroll = 16;              // columns a step of the pair loop (even)
static_assert(kK2Tile % kK2Unroll == 0, "a tile is whole steps of the pair loop");

// A staged column: the coordinates, NaN where the column is masked or past
// the frame.
template <int D>
struct Col;
template <>
struct Col<2> {
  using T = float2;
  static __device__ __forceinline__ T make(const float* y, bool ok) {
    return ok ? make_float2(y[0], y[1]) : make_float2(NAN, NAN);
  }
};
template <>
struct Col<3> {
  using T = float4;
  static __device__ __forceinline__ T make(const float* y, bool ok) {
    return ok ? make_float4(y[0], y[1], y[2], 0.f) : make_float4(NAN, NAN, NAN, 0.f);
  }
};

template <int D>
__device__ __forceinline__ float sqdist(const float (&x)[D], const typename Col<D>::T& c) {
  const float dx = x[0] - c.x, dy = x[1] - c.y;
  float r = dx * dx;
  r = fmaf(dy, dy, r);
  if constexpr (D == 3) {
    const float dz = x[2] - c.z;
    r = fmaf(dz, dz, r);
  }
  return r;
}

// (m1, m2) after one column of distance r (NaN: no change)
__device__ __forceinline__ void push(float& a1, float& a2, float r) {
  a2 = fmaxf(a1, fminf(a2, r));
  a1 = fminf(a1, r);
}

// (m1, m2) after two columns of distances r and s, on their bits as int32
// (the same values as push(r) then push(s))
__device__ __forceinline__ void push2(float& a1, float& a2, float r, float s) {
  const int ri = __float_as_int(r), si = __float_as_int(s);
  const int b1 = __float_as_int(a1), b2 = __float_as_int(a2);
  a2 = __int_as_float(__vimin3_s32(max(b1, min(ri, si)), b2, max(ri, si)));
  a1 = __int_as_float(__vimin3_s32(b1, ri, si));
}

struct K2Args {
  const float* x;   // (B, N, D)
  const float* y;   // (B, M, D)
  const float* my;  // (B, M)
  float* m1;        // (B, N)
  float* m2;
  int N, M;         // rows and columns a frame
};

template <int D, bool EXCL>
__global__ void __launch_bounds__(kK2Threads, kK2MinBlocks)
kmin2_kernel(const K2Args a) {
  using C = Col<D>;
  constexpr int R = kK2Rows, T = kK2Tile;
  __shared__ typename C::T tile[T];

  const size_t frame = blockIdx.y;
  const int t = threadIdx.x;
  const int N = a.N, M = a.M;
  const int row0 = blockIdx.x * T;
  const float* x = a.x + frame * N * D;
  const float* y = a.y + frame * M * D;
  const float* my = a.my + frame * M;

  float xr[R][D], a1[R], a2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + t + kK2Threads * r;
#pragma unroll
    for (int e = 0; e < D; ++e) xr[r][e] = i < N ? x[(size_t)i * D + e] : 0.f;
    a1[r] = INFINITY;
    a2[r] = INFINITY;
  }

  for (int base = 0; base < M; base += T) {
    const int n = min(T, M - base);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int jj = t + kK2Threads * r;
      const int j = base + jj;
      tile[jj] = C::make(y + (size_t)j * D, jj < n && my[j] > 0.f);  // y read only where valid
    }
    __syncthreads();
    // the tile's columns rounded up to whole steps of the pair loop (NaN past n)
    const int nu = (n + kK2Unroll - 1) & ~(kK2Unroll - 1);
    if (EXCL && base == row0) {
      // the block's own tile: column t + 128 r is row r's own index
      for (int jj = 0; jj < nu; ++jj) {
        const typename C::T c = tile[jj];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float d2 = sqdist<D>(xr[r], c);
          push(a1[r], a2[r], jj == t + kK2Threads * r ? NAN : d2);
        }
      }
    } else {
      for (int j0 = 0; j0 < nu; j0 += kK2Unroll) {
#pragma unroll
        for (int u = 0; u < kK2Unroll; u += 2) {
          const typename C::T c = tile[j0 + u], e = tile[j0 + u + 1];
#pragma unroll
          for (int r = 0; r < R; ++r) push2(a1[r], a2[r], sqdist<D>(xr[r], c), sqdist<D>(xr[r], e));
        }
      }
    }
    __syncthreads();  // the tile's reads are done before it is staged again
  }

  float* m1 = a.m1 + frame * N;
  float* m2 = a.m2 + frame * N;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + t + kK2Threads * r;
    if (i < N) {
      m1[i] = a1[r];
      m2[i] = a2[r];
    }
  }
}

template <int D>
int launch(const K2Args& a, dim3 grid, bool excl, cudaStream_t s) {
  if (excl) {
    kmin2_kernel<D, true><<<grid, kK2Threads, 0, s>>>(a);
  } else {
    kmin2_kernel<D, false><<<grid, kK2Threads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, N, D), y: (B, M, D), my: (B, M), all float32.  Writes m1, m2
// (B, N).  exclude_self needs N == M.  rows_per_block is the caller's tile,
// checked against the kernel's.  Returns cudaGetLastError().
int difficp_kmin2(const void* x, const void* y, const void* my, void* m1, void* m2, int B,
                  int N, int M, int D, int rows_per_block, int exclude_self, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || B > 65535 || rows_per_block != kK2Tile)
    return (int)cudaErrorInvalidValue;
  if (exclude_self && N != M) return (int)cudaErrorInvalidValue;
  K2Args a{static_cast<const float*>(x), static_cast<const float*>(y),
           static_cast<const float*>(my), static_cast<float*>(m1), static_cast<float*>(m2),
           N, M};
  const dim3 grid((N + kK2Tile - 1) / kK2Tile, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 2) return launch<2>(a, grid, exclude_self != 0, s);
  if (D == 3) return launch<3>(a, grid, exclude_self != 0, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
