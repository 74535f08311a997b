// Hopper building blocks shared by the tensor-core kernels (ksum.cu,
// rhs_self.cu, rhs_ext.cu): the TF32 split, the MUFU exponential, wgmma with
// its fences and waits, shared-memory matrix descriptors and the staged
// tables' core-matrix stride, mbarriers and bulk copies.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cvt.rna.tf32.f32 for finite v (nearest, ties away from zero), in two
// integer operations: add half of the 13 dropped mantissa bits (a carry moves
// into the exponent), then clear them.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins a register's value at this point of the program: the asynchronous
// wgmma reads its A registers and writes its accumulators behind the
// compiler's back, so they are kept live, and read, only after a wait.
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// 16-byte words a core matrix takes in a table staged for wgmma's B by the
// table kernels (rhs_self.cu, rhs_ext.cu): its 8 rows and one unused word, so
// that the core matrices beside it in K start 144 bytes on (LBO) and the
// next 8 rows 288 bytes on (SBO)
constexpr int kCoreWords = 9;

template <int I>
struct Int {
  static constexpr int value = I;
};

// f(Int<I>{}) for I = I0 .. END - 1, each I a constant expression
template <int I0, int END, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I0 < END) {
    f(Int<I0>{});
    static_for<I0 + 1, END>(f);
  }
}

// Shared-memory matrix descriptor of a K-major B without swizzle: 8-row by
// 16-byte core matrices of 128 contiguous bytes, the one beside it in K at
// lbo bytes (LBO), the next 8 rows at sbo bytes (SBO); both multiples of 16.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo = 128,
                                              uint32_t sbo = 256) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// the producer's arrival, announcing the bytes its bulk copies will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{ .reg .pred p; WAIT: mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1; "
      "@p bra DONE; bra WAIT; DONE: }" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// one contiguous copy global -> shared by the bulk-copy engine, completing
// its bytes on the barrier
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// d (+)= a b for one warpgroup: m64nNk8 with N = 8 NT, A (this warp's 16
// rows, the m16n8k8 A fragment) from registers, B (N x 8, K-major, no
// swizzle) from shared memory through its descriptor; scale_d = 0
// overwrites d.  The accumulators d: 4 a thread for each 8 columns of N.
template <int N>
struct Wgmma;

// The 16 widths come from one macro, WGMMA(NT, NT + 1, 8 NT).  The asm
// operands are numbered in the order they are listed: the 4 NT accumulators
// from %0, then the four A registers, the descriptor and scale_d.  WG_N<k>
// is the k-th group of four consecutive operand numbers, WG_REP_<n>(m, s)
// expands m(0) s() m(1) ... s() m(n - 1); the accumulators' constraints and
// their operand numbers in the asm string both come from it.
#define WG_N0 0, 1, 2, 3
#define WG_N1 4, 5, 6, 7
#define WG_N2 8, 9, 10, 11
#define WG_N3 12, 13, 14, 15
#define WG_N4 16, 17, 18, 19
#define WG_N5 20, 21, 22, 23
#define WG_N6 24, 25, 26, 27
#define WG_N7 28, 29, 30, 31
#define WG_N8 32, 33, 34, 35
#define WG_N9 36, 37, 38, 39
#define WG_N10 40, 41, 42, 43
#define WG_N11 44, 45, 46, 47
#define WG_N12 48, 49, 50, 51
#define WG_N13 52, 53, 54, 55
#define WG_N14 56, 57, 58, 59
#define WG_N15 60, 61, 62, 63
#define WG_N16 64, 65, 66, 67
#define WG_N17 68, 69, 70, 71
#define WG_CALL(m, ...) m(__VA_ARGS__)
#define WG_STR4(a, b, c, e) "%" #a ", %" #b ", %" #c ", %" #e
#define WG_FIRST(a, ...) "%" #a
#define WG_SECOND(a, b, ...) "%" #b
#define WG_Q(k) WG_CALL(WG_STR4, WG_N##k)
#define WG_D4(k) "+f"(d[4 * (k)]), "+f"(d[4 * (k) + 1]), "+f"(d[4 * (k) + 2]), "+f"(d[4 * (k) + 3])
#define WG_SEP() ", "
#define WG_COMMA() ,
#define WG_REP_1(m, s) m(0)
#define WG_REP_2(m, s) WG_REP_1(m, s) s() m(1)
#define WG_REP_3(m, s) WG_REP_2(m, s) s() m(2)
#define WG_REP_4(m, s) WG_REP_3(m, s) s() m(3)
#define WG_REP_5(m, s) WG_REP_4(m, s) s() m(4)
#define WG_REP_6(m, s) WG_REP_5(m, s) s() m(5)
#define WG_REP_7(m, s) WG_REP_6(m, s) s() m(6)
#define WG_REP_8(m, s) WG_REP_7(m, s) s() m(7)
#define WG_REP_9(m, s) WG_REP_8(m, s) s() m(8)
#define WG_REP_10(m, s) WG_REP_9(m, s) s() m(9)
#define WG_REP_11(m, s) WG_REP_10(m, s) s() m(10)
#define WG_REP_12(m, s) WG_REP_11(m, s) s() m(11)
#define WG_REP_13(m, s) WG_REP_12(m, s) s() m(12)
#define WG_REP_14(m, s) WG_REP_13(m, s) s() m(13)
#define WG_REP_15(m, s) WG_REP_14(m, s) s() m(14)
#define WG_REP_16(m, s) WG_REP_15(m, s) s() m(15)
#define WG_ASM(NT, NT1, N)                                                          \
  "{ .reg .pred p; setp.ne.b32 p, " WG_CALL(WG_SECOND, WG_N##NT1) ", 0; "             \
  "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 "                          \
  "{" WG_REP_##NT(WG_Q, WG_SEP) "}, {" WG_Q(NT) "}, " WG_CALL(WG_FIRST, WG_N##NT1)     \
  ", p, 1, 1; }"

// Whether a generated asm string reads m64n<8 nt> and its operands in the
// order scale_d (%(4 nt + 5)), then %0, %1, ..., %(4 nt + 4): checked when
// each width is compiled, so a slip in the tables above fails the build.
constexpr bool wgmma_asm_ok(const char* s, int nt) {
  int want = 4 * nt + 5, seen = 0, width = -1;
  for (int i = 0; s[i] != 0; ++i) {
    if (s[i] == 'm' && s[i + 1] == '6' && s[i + 2] == '4' && s[i + 3] == 'n') {
      width = 0;
      for (i += 4; s[i] >= '0' && s[i] <= '9'; ++i) width = 10 * width + (s[i] - '0');
    }
    if (s[i] == '%') {
      int v = 0;
      while (s[i + 1] >= '0' && s[i + 1] <= '9') v = 10 * v + (s[++i] - '0');
      if (v != want) return false;
      want = seen == 0 ? 0 : want + 1;
      ++seen;
    }
  }
  return width == 8 * nt && seen == 4 * nt + 6;
}

#define WGMMA(NT, NT1, N)                                                          \
  static_assert(wgmma_asm_ok(WG_ASM(NT, NT1, N), NT), "wgmma m64n" #N " operands"); \
  template <>                                                                      \
  struct Wgmma<N> {                                                                \
    static __device__ __forceinline__ void run(float (&d)[4 * NT], const uint32_t (&a)[4], \
                                               uint64_t desc, int scale_d) {       \
      asm volatile(WG_ASM(NT, NT1, N)                                              \
                   : WG_REP_##NT(WG_D4, WG_COMMA)                                  \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)); \
    }                                                                              \
  };

WGMMA(1, 2, 8)
WGMMA(2, 3, 16)
WGMMA(3, 4, 24)
WGMMA(4, 5, 32)
WGMMA(5, 6, 40)
WGMMA(6, 7, 48)
WGMMA(7, 8, 56)
WGMMA(8, 9, 64)
WGMMA(9, 10, 72)
WGMMA(10, 11, 80)
WGMMA(11, 12, 88)
WGMMA(12, 13, 96)
WGMMA(13, 14, 104)
WGMMA(14, 15, 112)
WGMMA(15, 16, 120)
WGMMA(16, 17, 128)

}  // namespace
