// Shared pieces of the pair-sum kernels: log2(e) for the exponentials of a
// prescaled argument, and kmin2.cu's block width and the float4 records in
// which its block stages one tile of the column side in shared memory (every
// thread then reads the same record: a broadcast).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // rows per block, and columns per tile
constexpr float kLog2e = 1.4426950408889634f;

template <int NF>
struct Record {
  static constexpr int kWords = (NF + 3) / 4;  // float4 words per column
};

// Copies a column's NF floats (zeros past the end) into its tile slot.
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

}  // namespace
