// Generic Gaussian kernel-sum with a table of payload columns, for sm_90a, on
// the tensor cores.  Plain C interface, loaded with ctypes by
// difficp_torch/ops/ksum.py.
//
// Per frame b, with u = 1/sigma^2, rows i of x (Nx points) and columns j of y
// (Ny points), the mask m of y and a payload table T of C columns:
//
//   A[c, i] = sum_j exp(-u |x_i - y_j|^2 / 2) m_j T[c, j]
//
// x: (B, Nx, D), y: (B, Ny, D) or (Ny, D) shared by every frame, m likewise
// (B, Ny) or (Ny) or none (all ones), T: (B, C, Ny) or (C, Ny).  A: (B, S,
// C, Nx), where the y axis is cut into S splits of L columns; the wrapper
// sums the splits in a fixed order.  No float atomics: two calls give the
// same bits.
//
// Replaces the TPU kernels of difficp_tpu/ops/pallas_ksum.py:
//   _ksum_kernel (via pairwise_ksum), _ksum_blocked_kernel and
//   _ksum_blocked_scratch_kernel (via _pairwise_ksum_blocked: the same
//   function with the y block resident in VMEM), and _ksum_sym_pair_kernel
//   (via pairwise_ksum_sym: the self case x = y, here over ordered pairs).
// Like the TPU kernel, it contracts a tile of exponentials with the table on
// the matrix unit.  It replaces a direct form that ran every multiply-add of
// the table on the FP32 pipe, 2 rows and at most 32 columns a thread, and
// recomputed the exponentials for each 32-column chunk.
//
// What bounds it on an H100: operations.  Per pair one exponential (MUFU,
// 4.1875e12/s), 3 x 2 C tensor-core FLOP (three TF32 products keep float32
// accuracy; 495 TFLOP/s dense) and the distance, scale and split on the FP32
// pipe (3 D + 2, ops/ksum.py); the bytes are O(Nx + C Ny) a frame.  Tables of
// up to 19 columns are bound by the MUFU, wider ones by the tensor cores.
//
// What the design does about it:
// - The product runs on the tensor cores as FlashAttention's P V, with
//   wgmma.mma_async m64nNk8 TF32 (N = 8 NT, NT n-tiles of 8 payload
//   columns): A, the tile of exponentials (64 rows of x by 8 columns of y),
//   is computed in registers directly in its fragment layout, each warp of
//   the warpgroup 16 rows; B, the table, is read from shared memory through
//   a matrix descriptor.  wgmma rather than mma.sync m16n8k8: one
//   asynchronous instruction covers a warpgroup's 64 rows by up to 128
//   columns, and the next k-step's exponentials are computed while it runs.
// - 3xTF32: k = k_hi + k_lo and T = T_hi + T_lo, the hi parts rounded to
//   TF32 (nearest, ties away), and k_lo T_hi + k_hi T_lo + k_hi T_hi summed
//   in float32 (k_lo T_lo, 2^-22 of the product, is dropped).  One TF32
//   product alone is off by ~4e-4; the generated polynomials recombine these
//   sums with cancellation, so float32 accuracy is kept.  The split of k
//   costs three instructions: the rounding of k_hi in two integer ones
//   (cvt.rna.tf32.f32 adds an infinity test and a select), k_lo = k - k_hi,
//   passed as it is (the tensor cores read a TF32 operand's top 19 bits).
// - The tensor cores truncate as they accumulate (summed over all 65,536
//   columns in the accumulators, the ring's sums miss TOL_FWD by far), so
//   each 64-column tile is summed in its own accumulators (24 products deep)
//   and then added to the running totals in float32 on the FP32 pipe.
// - One exponential per pair up to 128 columns: wider tables go in chunks of
//   at most 128 columns over the grid's y axis; C is padded to a multiple of
//   8 with zero columns that are never written back.
// - A small prep kernel lays the table out once per call, with the mask
//   folded in and already split, as the wgmma B operand wants it: per k-step
//   of 8 columns of y, a T_hi and a T_lo matrix of NT x 2 core matrices (8
//   payload columns by 4 columns of y, 128 contiguous bytes each; no swizzle,
//   and no bank conflicts in reading them); and the y points as float4
//   records.  Zero table entries past Ny make the padded columns of y
//   contribute nothing.
// - A block is 4 consumer warpgroups (2 above 64 columns, where the
//   accumulators take twice the registers) and one producer warp.  One
//   thread of the producer keeps 3 (2) tiles of y records and table words in
//   flight with bulk copies (cp.async.bulk) completing on an mbarrier per
//   stage; each warpgroup waits for a stage on its own and releases it on a
//   second mbarrier, so the warpgroups are never held in step, and while one
//   drains its products another computes exponentials.  Within a warpgroup
//   the A fragments are double-buffered: the exponentials of k-step s + 1
//   are computed while the products of k-step s run.
// - A short x side against a long y side (the support's dq/dp direction: 380
//   rows a frame against 65,536 columns) would leave most SMs idle, so the y
//   axis is also split over the grid; each split writes its partial table
//   and the wrapper sums them in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kTileJ = 64;           // columns of y a staged tile holds
constexpr int kSteps = kTileJ / 8;   // k-steps of 8 columns a tile
constexpr int kMaxNT = 16;           // n-tiles of 8 payload columns a chunk
constexpr float kLog2e = 1.4426950408889634f;

// The y records (B_y, Nyp) float4 {y, 0...} and the table ptab: (B_y,
// n_chunks, Nyp / 8) k-steps of 32 NT 16-byte words, the T_hi matrix, then
// the T_lo matrix, each NT x 2 core matrices (nt, kh) at word (2 nt + kh) 8,
// of 8 rows c (16 bytes each) by 4 columns j = 8 k-step + 4 kh + 0..3, with
// P = m T split into hi = rna(P) and lo = rna(P - hi), c = chunk 8 NT + 8 nt
// + row; zeros past Ny and past C.  One thread a word of T_hi; the first B_y
// Nyp threads also write a y record.
__global__ void ksum_prep_kernel(const float* __restrict__ y, const float* __restrict__ my,
                                 const float* __restrict__ t, float4* __restrict__ yrec,
                                 uint4* __restrict__ ptab, int fy, int Ny, int Nyp, int D,
                                 int C, int NT, int n_chunks) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int n_steps = Nyp / 8;
  const long long total = (long long)fy * n_chunks * n_steps * NT * 16;
  if (idx >= total) return;
  if (idx < (long long)fy * Nyp) {
    const int f = (int)(idx / Nyp), j = (int)(idx % Nyp);
    float r[3] = {0.f, 0.f, 0.f};
    if (j < Ny)
      for (int d = 0; d < D; ++d) r[d] = y[((size_t)f * Ny + j) * D + d];
    yrec[idx] = make_float4(r[0], r[1], r[2], 0.f);
  }
  const int row = (int)(idx % 8);
  long long rest = idx / 8;
  const int kh = (int)(rest % 2);
  rest /= 2;
  const int nt = (int)(rest % NT);
  const long long step = rest / NT;  // (f, chunk, k-step)
  const int ks = (int)(step % n_steps);
  const int chunk = (int)(step / n_steps % n_chunks);
  const int f = (int)(step / n_steps / n_chunks);
  const int c = chunk * NT * 8 + 8 * nt + row;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = 8 * ks + 4 * kh + e;
    float v = 0.f;
    if (c < C && j < Ny)
      v = (my != nullptr ? my[(size_t)f * Ny + j] : 1.f) * t[((size_t)f * C + c) * Ny + j];
    hi[e] = tf32_rna(v);
    lo[e] = tf32_rna(v - __uint_as_float(hi[e]));
  }
  uint4* w = ptab + step * (32 * NT) + (2 * nt + kh) * 8 + row;
  w[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  w[16 * NT] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

template <int NT>
struct Shape {
  static constexpr int kGroups = NT <= 8 ? 4 : 2;      // consumer warpgroups a block
  static constexpr int kRows = 64 * kGroups;           // rows a block
  static constexpr int kStages = NT <= 8 ? 3 : 2;      // tiles in flight
  static constexpr int kStage = kTileJ + kSteps * NT * 32;  // 16-byte words a tile
  static constexpr int kSmem = kStages * kStage * 16;
  static constexpr int kThreads = 128 * kGroups + 32;  // and one producer warp
};

template <int D, int NT>
__global__ void __launch_bounds__(Shape<NT>::kThreads, 1)
ksum_kernel(const float* __restrict__ x, const float4* __restrict__ yrec,
            const uint4* __restrict__ ptab, float* __restrict__ out, int Nx, int Nyp,
            int C, int L, int n_chunks, int y_shared, float c2) {
  constexpr int N = 8 * NT, ND = N / 2;
  constexpr int G = Shape<NT>::kGroups;
  constexpr int S = Shape<NT>::kStages;
  constexpr int kStage = Shape<NT>::kStage;
  extern __shared__ __align__(1024) uint4 smem[];
  __shared__ uint64_t full[S], empty[S];

  const int chunk = blockIdx.y % n_chunks;
  const int split = blockIdx.y / n_chunks;
  const int n_splits = gridDim.y / n_chunks;
  const size_t frame = blockIdx.z;
  const size_t fy = y_shared ? 0 : frame;
  // L and Nyp are multiples of kTileJ
  const int j_lo = split * L;
  const int n_tiles = (min(Nyp, j_lo + L) - j_lo) / kTileJ;
  const int jt0 = j_lo / kTileJ;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * G);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * G) {
    // the producer warp: one thread keeps S tiles in flight, refilling a
    // stage once every consumer warp released it
    if (threadIdx.x == 128 * G) {
      const uint4* gy = reinterpret_cast<const uint4*>(yrec + fy * Nyp) + (size_t)jt0 * kTileJ;
      const uint4* gb = ptab + (fy * n_chunks + chunk) * (size_t)(Nyp / 8) * NT * 32 +
                        (size_t)jt0 * kSteps * NT * 32;
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int st = tile % S;
        if (tile >= S) mbar_wait(&empty[st], ((tile / S) - 1) & 1);
        uint4* dst = smem + st * kStage;
        mbar_expect_tx(&full[st], kStage * 16);
        bulk_copy(dst, gy + (size_t)tile * kTileJ, kTileJ * 16, &full[st]);
        bulk_copy(dst + kTileJ, gb + (size_t)tile * kSteps * NT * 32, kSteps * NT * 512,
                  &full[st]);
      }
    }
    return;
  }

  const int group = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  x += frame * Nx * D;
  out += (frame * n_splits + split) * (size_t)C * Nx;

  // this lane's rows of its warpgroup's 64: row0 + g and row0 + g + 8
  const int row0 = blockIdx.x * Shape<NT>::kRows + 64 * group + 16 * warp;
  float xr[2][D];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
#pragma unroll
    for (int d = 0; d < D; ++d) xr[h][d] = r < Nx ? x[(size_t)r * D + d] : 0.f;
  }

  // running totals, and the tile's sums (the wgmma accumulators)
  float acc[ND], part[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    acc[i] = 0.f;
    part[i] = 0.f;
  }
  // A fragments, {A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]} of
  // the k-step's 16 x 8 share, double-buffered
  uint32_t ahi[2][4], alo[2][4];

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % S;
    mbar_wait(&full[st], (tile / S) & 1);
    const uint4* sm = smem + st * kStage;
    const float4* ys = reinterpret_cast<const float4*>(sm);
    const uint32_t bsh = smem_addr(sm + kTileJ);

#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int buf = ks & 1;
      if (ks >= 2) {
        // the products of k-step ks - 2 read this A buffer
        wgmma_wait<1>();
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          pin(ahi[buf][v]);
          pin(alo[buf][v]);
        }
      }
      const float4 ya = ys[8 * ks + t], yb = ys[8 * ks + t + 4];
      const float yv[2][3] = {{ya.x, ya.y, ya.z}, {yb.x, yb.y, yb.z}};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int h = v & 1, col = v >> 1;
        float r2 = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float dd = xr[h][d] - yv[col][d];
          r2 = fmaf(dd, dd, r2);
        }
        const float k = ex2(c2 * r2);
        ahi[buf][v] = tf32_rna(k);
        alo[buf][v] = __float_as_uint(k - __uint_as_float(ahi[buf][v]));
      }
      const uint64_t dhi = smem_desc(bsh + ks * NT * 512);
      const uint64_t dlo = smem_desc(bsh + ks * NT * 512 + NT * 256);
      wgmma_fence();
      Wgmma<N>::run(part, alo[buf], dhi, ks > 0);  // k_lo T_hi (a fresh sum at ks = 0)
      Wgmma<N>::run(part, ahi[buf], dlo, 1);       // k_hi T_lo
      Wgmma<N>::run(part, ahi[buf], dhi, 1);       // k_hi T_hi
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < ND; ++i) pin(part[i]);
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        pin(ahi[b][v]);
        pin(alo[b][v]);
      }
    // this warp is done with the stage: its reads of the y records and its
    // share of the products have completed
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] += part[i];
  }

  // accumulator i: row g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2
  const int c0 = chunk * N;
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const int r = row0 + g + 8 * ((i >> 1) & 1);
    const int c = c0 + 8 * (i >> 2) + 2 * t + (i & 1);
    if (r < Nx && c < C) out[(size_t)c * Nx + r] = acc[i];
  }
}

template <int D, int NT>
int launch(dim3 grid, cudaStream_t s, const float* x, const float4* yrec,
           const uint4* ptab, float* out, int Nx, int Nyp, int C, int L, int n_chunks,
           int y_shared, float c2) {
  constexpr int smem = Shape<NT>::kSmem;
  if (smem > 48 * 1024) {
    static bool raised = false;
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          ksum_kernel<D, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      raised = true;
    }
  }
  ksum_kernel<D, NT><<<grid, Shape<NT>::kThreads, smem, s>>>(x, yrec, ptab, out, Nx, Nyp, C,
                                                              L, n_chunks, y_shared, c2);
  return (int)cudaGetLastError();
}

template <int D, int NT = 1>
int launch_nt(int nt, dim3 grid, cudaStream_t s, const float* x, const float4* yrec,
              const uint4* ptab, float* out, int Nx, int Nyp, int C, int L, int n_chunks,
              int y_shared, float c2) {
  if constexpr (NT > kMaxNT) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (nt == NT)
      return launch<D, NT>(grid, s, x, yrec, ptab, out, Nx, Nyp, C, L, n_chunks, y_shared, c2);
    return launch_nt<D, NT + 1>(nt, grid, s, x, yrec, ptab, out, Nx, Nyp, C, L, n_chunks,
                                y_shared, c2);
  }
}

}  // namespace

extern "C" {

// x: (B, Nx, D); y: (B, Ny, D), or (Ny, D) with y_shared; my: like y without
// D, or null for all ones; t: (B, C, Ny) or (C, Ny).  Scratch from the
// caller: yrec (B_y, Nyp) float4 and ptab (B_y, n_chunks, Nyp / 8, NT, 32)
// 16-byte words, with Nyp = Ny rounded up to 64 and B_y = 1 with y_shared,
// else B.  Writes out (B, S, C, Nx) with S = ceil(Ny / L) splits of the y
// axis; L a multiple of 64.  NT: n-tiles of 8 columns a chunk, 1 to 16, with
// n_chunks = ceil(C / (8 NT)).  Returns cudaGetLastError() after the
// launches.
int difficp_ksum(const void* x, const void* y, const void* my, const void* t, void* yrec,
                 void* ptab, void* out, int B, int Nx, int Ny, int D, int C, int NT, int L,
                 int y_shared, float u, void* stream) {
  if (B <= 0 || Nx <= 0 || Ny <= 0 || C <= 0 || L <= 0 || L % kTileJ != 0 || B > 65535 ||
      NT < 1 || NT > kMaxNT || (D != 2 && D != 3))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (C + 8 * NT - 1) / (8 * NT);
  const int n_splits = (Ny + L - 1) / L;
  if ((long long)n_chunks * n_splits > 65535) return (int)cudaErrorInvalidValue;
  const int Nyp = (Ny + kTileJ - 1) / kTileJ * kTileJ;
  const int fy = y_shared ? 1 : B;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long threads = (long long)fy * n_chunks * (Nyp / 8) * NT * 16;
  const long long prep_blocks = (threads + 255) / 256;
  if (prep_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ksum_prep_kernel<<<(unsigned)prep_blocks, 256, 0, s>>>(
      static_cast<const float*>(y), static_cast<const float*>(my),
      static_cast<const float*>(t), static_cast<float4*>(yrec), static_cast<uint4*>(ptab),
      fy, Ny, Nyp, D, C, NT, n_chunks);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rows = NT <= 8 ? Shape<1>::kRows : Shape<kMaxNT>::kRows;
  const dim3 grid((Nx + rows - 1) / rows, n_chunks * n_splits, B);
  const float c2 = -0.5f * u * kLog2e;
  const auto* xf = static_cast<const float*>(x);
  const auto* yr = static_cast<const float4*>(yrec);
  const auto* pt = static_cast<const uint4*>(ptab);
  auto* of = static_cast<float*>(out);
  if (D == 2)
    return launch_nt<2>(NT, grid, s, xf, yr, pt, of, Nx, Nyp, C, L, n_chunks, y_shared, c2);
  return launch_nt<3>(NT, grid, s, xf, yr, pt, of, Nx, Nyp, C, L, n_chunks, y_shared, c2);
}

}  // extern "C"
