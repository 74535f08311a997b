// The direct forward pair sums of rhs_self.cu (rows against columns, any eta)
// and rhs_ext.cu (the ext forward, both instances): the block, its warps'
// column tiles and the fixed-order reductions, around a policy P that holds
// the pair's arithmetic (SelfEta in rhs_self.cu, ExtFwd in rhs_ext.cu).
//
// A block is kDirectWarps warps over 32 R rows of one frame (R = P::kRows
// rows a thread: row 32 r + lane of the block in registers r of that lane)
// and one chunk of the frame's columns, [L chunk, L chunk + L) (gridDim.y
// chunks; ops/rhs_self.py direct_chunk_cols).  The warps take the chunk's
// tiles of 32 columns in turn (warp w the tiles w, w + kDirectWarps, ...):
// lane l loads column l of its warp's next tile while the tile before it is
// summed, forms its record (P::column: the coordinates prescaled, the mask
// folded in) and stores it in the warp's own shared-memory slots; after a
// __syncwarp every lane reads each record (a broadcast) and adds the pair to
// each of its R rows.  One record load serves R pairs.  Each tile is summed
// in its own registers and then added to the warp's running totals.  The
// warps' totals are summed through shared memory in warp order, the policy's
// epilogue forms a row's outputs from its sums, and with one chunk they are
// written; with C > 1 chunks each block writes its rows' outputs to a
// scratch buffer, and the last block of a row block to finish (an integer
// ticket per row block, atomicAdd after a fence) sums the C partials in
// chunk order, writes the outputs and sets its ticket back to 0 (the pattern
// of rhs_ext.cu's dq/dp).  No float atomics: two launches give the same
// bits, in one launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kDirectWarps = 4;  // warps a block (ops/rhs_self.py DIRECT_WARPS)
// blocks an SM holds at least (the registers' cap: 128 a thread); a launch
// with chunks takes at most this many blocks an SM, one wave
// (ops/rhs_self.py DIRECT_BLOCKS_PER_SM)
constexpr int kDirectMinBlocks = 4;
constexpr int kDirectTile = 32;  // columns a warp stages at once, one a lane

struct DirectArgs {
  const float* q;   // rows: coordinates (B, M, D), payload (B, M, D), mask (B, M)
  const float* p;
  const float* m;
  const float* qc;  // columns: coordinates (B, N, D), payload (B, N, D), mask (B, N)
  const float* pc;
  const float* mc;
  float* o0;        // outputs, one a row (the policy's store)
  float* o1;
  float* o2;
  float* part;      // chunk partials (B, row blocks, C, 32 R, P::kOut), when C > 1
  int* ticket;      // (B, row blocks): 0 at the launch, left 0
  int M, N, L;      // rows and columns a frame; L: columns a chunk
  float u, eta;
  int withlogdet;
};

// The scale of the prescaled coordinates, s = sqrt(u log2(e) / 2): with q' =
// s q, k = exp(-u |q_i - q_j|^2 / 2) = 2^(-|q'_i - q'_j|^2), one ex2 of the
// negated squared distance.  us = u / s and us2 = u / s^2 undo it on the sums
// that need d and r2 (d = d' / s, u r2 = us2 r2').
struct Scale {
  float s, us, us2;
};

__device__ __forceinline__ Scale make_scale(float u) {
  const float s = sqrtf(0.5f * u * kLog2e);
  const float us = u / s;
  return {s, us, us / s};
}

// A record's NF floats from its words in shared memory: one LDS.128, and
// one LDS.32, .64 or .128 for the rest.
template <int NF>
__device__ __forceinline__ void read_record(const float4* w, float (&f)[NF]) {
  static_assert(NF >= 4 && NF <= 8, "a record takes one or two words");
  const float4 a = w[0];
  f[0] = a.x;
  f[1] = a.y;
  f[2] = a.z;
  f[3] = a.w;
  if constexpr (NF == 5) {
    f[4] = reinterpret_cast<const float*>(w + 1)[0];
  } else if constexpr (NF == 6) {
    const float2 b = reinterpret_cast<const float2*>(w + 1)[0];
    f[4] = b.x;
    f[5] = b.y;
  } else if constexpr (NF >= 7) {
    const float4 b = w[1];
    f[4] = b.x;
    f[5] = b.y;
    f[6] = b.z;
    if constexpr (NF == 8) f[7] = b.w;
  }
}

template <int NF>
__device__ __forceinline__ void write_record(float4* w, const float (&f)[NF]) {
  constexpr int NW = (NF + 3) / 4;
#pragma unroll
  for (int v = 0; v < NW; ++v) {
    float g[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) g[e] = 4 * v + e < NF ? f[4 * v + e] : 0.f;
    w[v] = make_float4(g[0], g[1], g[2], g[3]);
  }
}

template <class P>
__global__ void __launch_bounds__(32 * kDirectWarps, kDirectMinBlocks)
direct_kernel(const DirectArgs a) {
  constexpr int D = P::kD, R = P::kRows, NF = P::kFields, NS = P::kSums, NO = P::kOut;
  constexpr int NW = (NF + 3) / 4, kRowsBlock = 32 * R;
  __shared__ float4 recs[kDirectWarps][kDirectTile * NW];
  __shared__ float red[kDirectWarps * NS * kRowsBlock];
  __shared__ int last;

  const size_t frame = blockIdx.z;
  const int chunk = blockIdx.y, n_chunks = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int M = a.M, N = a.N;
  const int row0 = blockIdx.x * kRowsBlock;
  const Scale sc = make_scale(a.u);
  const typename P::Consts c = P::consts(a, sc);
  const float* q = a.q + frame * M * D;
  const float* p = a.p + frame * M * D;
  const float* m = a.m + frame * M;
  const float* qc = a.qc + frame * N * D;
  const float* pc = a.pc + frame * N * D;
  const float* mc = a.mc + frame * N;

  typename P::Row rows[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + 32 * r + lane;
    P::row(c, q, p, i < M ? i : -1, rows[r]);
  }
  float tot[R][NS];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int s = 0; s < NS; ++s) tot[r][s] = 0.f;

  const int lo = chunk * a.L;
  const int hi = min(N, lo + a.L);
  const int n_tiles = (hi - lo + kDirectTile - 1) / kDirectTile;
  float4* mine = recs[warp];
  // the record of this lane's column of tile t (zeros past the chunk: such a
  // column adds exact zeros to every sum)
  float nxt[NF];
  auto fetch = [&](int t) {
    const int j = lo + kDirectTile * t + lane;
    P::column(c, qc, pc, mc, j < hi ? j : -1, nxt);
  };
  if (warp < n_tiles) fetch(warp);
  for (int t = warp; t < n_tiles; t += kDirectWarps) {
    write_record<NF>(mine + lane * NW, nxt);
    __syncwarp();
    if (t + kDirectWarps < n_tiles) fetch(t + kDirectWarps);
    float part[R][NS];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 0; s < NS; ++s) part[r][s] = 0.f;
    // eight columns an unrolled step: a full unroll let ptxas hoist the
    // records of the whole tile and spill (the ext forward at d = 2)
#pragma unroll 8
    for (int jj = 0; jj < kDirectTile; ++jj) {
      float f[NF];
      read_record<NF>(mine + jj * NW, f);
#pragma unroll
      for (int r = 0; r < R; ++r) P::pair(c, rows[r], f, part[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 0; s < NS; ++s) tot[r][s] += part[r][s];
    __syncwarp();  // the warp's reads of the tile are done before it is written again
  }

  // the warps' totals, summed in warp order; block row b = 32 r + lane
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int s = 0; s < NS; ++s) red[(warp * NS + s) * kRowsBlock + 32 * r + lane] = tot[r][s];
  __syncthreads();
  const size_t rb = frame * gridDim.x + blockIdx.x;
  float* part_rb = a.part + rb * n_chunks * kRowsBlock * NO;
  for (int b = tid; b < kRowsBlock; b += 32 * kDirectWarps) {
    float S[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      S[s] = red[s * kRowsBlock + b];
#pragma unroll
      for (int w = 1; w < kDirectWarps; ++w) S[s] += red[(w * NS + s) * kRowsBlock + b];
    }
    const int i = row0 + b;
    float out[NO];
#pragma unroll
    for (int o = 0; o < NO; ++o) out[o] = 0.f;
    if (i < M) P::epilogue(c, a, p, m, i, S, out);
    if (n_chunks == 1) {
      if (i < M) P::store(a, frame, i, out);
    } else {
#pragma unroll
      for (int o = 0; o < NO; ++o) part_rb[((size_t)chunk * kRowsBlock + b) * NO + o] = out[o];
    }
  }
  if (n_chunks == 1) return;
  // the last block of the row block to finish sums the chunks' partials in
  // chunk order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&a.ticket[rb], 1) == n_chunks - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  for (int b = tid; b < kRowsBlock; b += 32 * kDirectWarps) {
    const int i = row0 + b;
    if (i >= M) continue;
    float s[NO];
#pragma unroll
    for (int o = 0; o < NO; ++o) s[o] = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch)
#pragma unroll
      for (int o = 0; o < NO; ++o) s[o] += __ldcg(&part_rb[((size_t)ch * kRowsBlock + b) * NO + o]);
    P::store(a, frame, i, s);
  }
  if (tid == 0) a.ticket[rb] = 0;
}

// One launch over B frames of M rows against N columns, C = ceil(N / L)
// chunks; rows: the rows a block takes as the caller sized its scratch (it
// must be P's 32 R).  Returns cudaGetLastError() after the launch.
template <class P>
int launch_direct(const DirectArgs& a, int B, int rows, cudaStream_t s) {
  if (a.L <= 0 || a.L % kDirectTile != 0 || rows != 32 * P::kRows)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (a.N + a.L - 1) / a.L;
  if (n_chunks > 65535 || (n_chunks > 1 && (a.part == nullptr || a.ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.M + rows - 1) / rows, n_chunks, B);
  direct_kernel<P><<<grid, 32 * kDirectWarps, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
