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
// The forward is a direct pair sum (ExtFwd below, on direct.cuh's
// direct_kernel), one pair loop for both kinds: ETA = false is the eta = 0
// kernel; ETA = true adds three sums in the same pass (sum k~, sum k~ r2,
// sum k~ delta) and combines them per row at the end, so that at eta = 0 it
// gives the ETA = false results bit for bit.
//
// What bounds the forward on an H100: operations.  Per pair one exponential
// (MUFU, 16 a SM and clock) and 5 d + 1 FP32 operations of least work (7 d
// + 4 with the gradcomponent terms; ops/rhs_ext.py fwd_ops_per_pair): the
// MUFU's rate leaves 8 issue slots a pair, so each instruction of the pair
// loop counts; and v_field's 10 frames of 380 rows against 65,536 columns
// give too few blocks of rows to fill the card.
//
// What the design does about it:
// - About 10 issue slots a pair at d = 2 for eta = 0: coordinates prescaled
//   by s = sqrt(u log2(e) / 2), so k = ex2(-|delta'|^2), one
//   ex2.approx.ftz and no multiply; the support's mask folded into its
//   payload (p~ = mq p) in the record, so the eta = 0 record is q', p~ (one
//   LDS.128 at d = 2) and the pair is 2 d subtractions and multiply-adds for
//   the exponent, d for vx and d + 1 for dcost's p~.delta'; one record load
//   for four rows.  The scale comes off per row (dcost times u / s).
// - Every SM busy at every main-path shape: blocks of 4 warps over 128 data
//   rows, the support axis cut into chunks where the rows alone would not
//   give each SM a few blocks (v_field; ops/rhs_self.py direct_chunk_cols:
//   one chunk at the grid main path's 10 x 65,536 rows, which fill the card).
// - Per-tile partial sums; the prescaled coordinates round relative to |s x|
//   (rhs_self.cu).
//
// The VJP kernels are, as those TPU kernels, a table kernel-sum followed by
// a per-row epilogue:
//
//   A[c]_l = sum_j k_lj m_j T_c(j)
//
//   dx:    rows l the data, columns j the support, m = mq; the table of
//          _ext_bwd_dx_mm_kernel on y = q_j - c:  p_e | y_a p_e | y.p |
//          y_a (y.p)  (9 columns at D = 2, 16 at D = 3);
//   dq/dp: rows l the support, columns j the data, m = mx; the table of
//          _ext_bwd_dqdp_mm_kernel on y = x_j - c:  gx_f | y_a gx_f | 1 |
//          y_f | y_a y_b (a <= b)  (12 columns at D = 2, 22 at D = 3);
//
// where c is the masked centroid of the block's rows.  Every output depends
// only on differences x - q, so the shift is exact; the epilogues (DxSpec,
// DqdpSpec below) recombine A with the row's centred coordinates through the
// identities of those TPU kernels.  The recombination cancels terms of up to
// degree 2 in the coordinates, which amplifies the sums' rounding by up to
// (R / sigma)^2 for a block of radius R: so each block's table is centred on
// its own rows, and both kernels take their rows through a spatial order
// (ops/rhs_self.py row_order: Morton order cut where the Z-curve jumps; an
// int32 index per frame, -1 in padding slots): dq/dp the support's, the
// self kernels' own, and dx the data points', computed once per shoot or
// optimisation at the start points (ops/rhs_ext.py data_order, with a
// larger padding budget, so that a sparse cloud at a small sigma is cut too).
// The data points come in random order: a block of them in their own order
// spans the whole cloud, and dx's error then grows about 9x at 16,384 points
// (tests/test_torch_rhs_ext.py, the CPU emulation of this arithmetic); the
// gathered row loads and scattered writes cost dx about 5% (PERF.md).
//
// What bounds them on an H100: operations.  Per (x, q) pair one exponential
// (MUFU, 4.1875e12/s), 3 x 2 x 16 tensor-core FLOP (the table padded to
// n-tiles of 8 columns, 16 at D = 2; three TF32 products for float32
// accuracy; 495 TFLOP/s dense) and 3 D + 2 FP32 operations for the distance,
// the exponent's scale and the split of k: at D = 2 the MUFU bounds both.
// The functions' own least work (ops/rhs_ext.py dx_ops_per_pair,
// dqdp_ops_per_pair: 9 D + 1 and 9 D + 3 FP32 operations and one
// exponential per pair) is the bound the kernel table states.  The direct
// pair sums these replace issued ~18 instructions per pair against 16
// exponentials per SM per clock, so issue, not the MUFU, set their pace.
//
// What the design does about it (the wgmma pieces are rhs_self.cu's table
// kernels', from wgmma.cuh):
// - One exponential per pair and about seven issue slots, the sums on the
//   tensor cores: wgmma m64nNk8 TF32, A the tile of exponentials (64 rows by
//   8 columns, computed in registers in its fragment layout,
//   double-buffered, two k-steps' exponentials before their products), B
//   the table from shared memory; 3xTF32, k_lo T_hi + k_hi T_lo + k_hi T_hi
//   with k_hi = k truncated to TF32 (as the tensor cores read it) and the
//   two small products in accumulators of their own; each tile of 64
//   columns summed apart and then added to the running totals in float32
//   (the tensor cores truncate as they accumulate).  k = 2^(-|x - y|^2) on
//   coordinates centred on the block's centroid and scaled by
//   sqrt(u log2(e) / 2): a difference, two FMAs and the exponential.
// - The table depends on the row block (its centroid): a producer warpgroup
//   builds it tile by tile into a ring of 3 shared-memory stages, each
//   released on an mbarrier; each consumer warpgroup waits for a stage and
//   gives it back on a second mbarrier.  A block's G warpgroups (64 G rows)
//   share one centroid and one table.
// - The epilogue needs a row's whole set of columns: the sums are staged
//   through shared memory, one row a thread.
// - dx: K x ceil(No / rows) blocks of rows = 64 or 128 slots of the data
//   order (ops/rhs_ext.py dx_block_rows), two blocks an SM, each over all
//   the support's columns, its outputs written at the rows' own index.
// - dq/dp: the support is short (M ~ 380 at sigma = 0.05), so its K M / 64
//   row blocks would leave the card idle: the data axis is cut into C
//   chunks on a second grid axis (ops/rhs_ext.py dqdp_chunk_cols: about 16
//   blocks per SM).  Each block runs the epilogue on its chunk's sums and
//   writes the partial (dq, dp) of its rows to a scratch buffer; the last
//   block of a row block to finish (an integer ticket per row block,
//   atomicAdd after a fence) sums the C partials in chunk order and writes
//   (dq, dp), then sets its ticket back to 0.  No float atomics: the
//   results are the same bit for bit from run to run, in one launch.
// At the grid main path's shape a whole launch runs at about a quarter of
// the MUFU's rate: 27% for dx and for dq/dp by device time in a profiler
// trace (chip_smoke.py, PERF.md), 22-24% by CUDA events, which take the
// wrapper's host time too; timestamps per block of a development build read
// about a third for the main loop alone.  Where the rest goes was not
// measured (no profiler of the SM's stalls on that machine).  Deeper A
// buffering with a second set of accumulators across tiles made ptxas
// serialize the wgmmas (C7511, C7514) and ran slower.

#include <cuda_runtime.h>
#include <stdint.h>

#include "direct.cuh"
#include "tile.cuh"
#include "wgmma.cuh"

namespace {

// The forward's pair arithmetic: data rows x (the rows of DirectArgs: q = x,
// m = mx) against the support (the columns: qc = q, pc = p, mc = mq).  Sums
// a row, on prescaled coordinates (delta' = s delta, r2n = -s^2 r2, k~ = mq_j
// k): V = sum k p~ (D), DC = sum k p~.delta'; with ETA K = sum k~, KR2 = sum
// k~ r2n, KD = sum k~ delta' (D).
template <int D, bool ETA>
struct ExtFwd {
  static constexpr int kD = D, kRows = 4, kFields = 2 * D + (ETA ? 1 : 0);
  static constexpr int kSums = ETA ? 2 * D + 3 : D + 1, kOut = D + 1;
  static constexpr int kV = 0, kDC = D, kK = D + 1, kKR2 = D + 2, kKD = D + 3;
  struct Consts {
    Scale sc;
  };
  struct Row {
    float x[D];  // s x_i
  };

  __device__ static Consts consts(const DirectArgs&, const Scale& sc) { return {sc}; }

  __device__ static void row(const Consts& c, const float* x, const float*, int i, Row& r) {
#pragma unroll
    for (int d = 0; d < D; ++d) r.x[d] = i >= 0 ? c.sc.s * x[(size_t)i * D + d] : 0.f;
  }

  // the record: s q_j, mq_j p_j, and mq_j with ETA (zeros for j = -1)
  __device__ static void column(const Consts& c, const float* q, const float* p,
                                const float* mq, int j, float (&f)[kFields]) {
    const float mj = j >= 0 ? mq[j] : 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      f[d] = j >= 0 ? c.sc.s * q[(size_t)j * D + d] : 0.f;
      f[D + d] = j >= 0 ? mj * p[(size_t)j * D + d] : 0.f;
    }
    if constexpr (ETA) f[2 * D] = mj;
  }

  __device__ static void pair(const Consts&, const Row& r, const float (&f)[kFields],
                              float (&S)[kSums]) {
    float dd[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dd[d] = r.x[d] - f[d];
    float r2n = __fmul_rn(-dd[0], dd[0]);
#pragma unroll
    for (int d = 1; d < D; ++d) r2n = fmaf(-dd[d], dd[d], r2n);
    const float k = ex2(r2n);
    float pd = __fmul_rn(f[D], dd[0]);
#pragma unroll
    for (int d = 1; d < D; ++d) pd = fmaf(f[D + d], dd[d], pd);
#pragma unroll
    for (int d = 0; d < D; ++d) S[kV + d] = fmaf(k, f[D + d], S[kV + d]);
    S[kDC] = fmaf(k, pd, S[kDC]);
    if constexpr (ETA) {
      const float km = __fmul_rn(k, f[2 * D]);
      S[kK] += km;
      S[kKR2] = fmaf(km, r2n, S[kKR2]);
#pragma unroll
      for (int d = 0; d < D; ++d) S[kKD + d] = fmaf(km, dd[d], S[kKD + d]);
    }
  }

  // vx = mx_i V (+ eta u mx_i KD / s); dc = u mx_i DC / s (+ eta u mx_i (-u
  // KR2 / s^2 - D K)), 0 without logdet: the eta = 0 parts formed as the ETA
  // = false kind forms them, the eta terms added by one fma each
  __device__ static void epilogue(const Consts& c, const DirectArgs& a, const float*,
                                  const float* mx, int i, const float (&S)[kSums],
                                  float (&out)[kOut]) {
    const float mi = mx[i];
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = __fmul_rn(mi, S[kV + d]);
    out[D] = a.withlogdet ? __fmul_rn(__fmul_rn(c.sc.us, mi), S[kDC]) : 0.f;
    if constexpr (ETA) {
      const float me = mi * (a.eta * a.u);
      const float mv = me / c.sc.s;
#pragma unroll
      for (int d = 0; d < D; ++d) out[d] = fmaf(mv, S[kKD + d], out[d]);
      if (a.withlogdet) out[D] = fmaf(me, fmaf(-c.sc.us2, S[kKR2], -D * S[kK]), out[D]);
    }
  }

  __device__ static void store(const DirectArgs& a, size_t frame, int i, const float (&o)[kOut]) {
    const size_t at = frame * a.M + i;
#pragma unroll
    for (int d = 0; d < D; ++d) a.o0[at * D + d] = o[d];
    a.o1[at] = o[D];
  }
};

// ---------------------------------------------------------------------------
// the VJP: table kernel-sums on the tensor cores and their epilogues
// ---------------------------------------------------------------------------

// Columns a staged tile holds: each tile is summed in its own accumulators,
// which the tensor cores truncate after every product
constexpr int kTileCols = 64;

// The values of a column j that its table entries are products of: 1, y =
// (its coordinates) - c, v (its payload: p for dx, gx for dq/dp) and y.v.
template <int D>
struct Base {
  static constexpr int kOne = 0;
  static constexpr int kY = 1;
  static constexpr int kV = 1 + D;
  static constexpr int kYV = 1 + 2 * D;
  static constexpr int kCount = 2 + 2 * D;
};

// A table entry: the product of up to three base values (kOne where fewer).
struct Term {
  int f0, f1, f2;
};

// dx: rows the data (coordinates x, payload gx, mask mx), columns the
// support (q, p, mq); the table of _ext_bwd_dx_mm_kernel in its order.
template <int D>
struct DxSpec {
  using B = Base<D>;
  static constexpr int kC = D + D * D + 1 + D;
  static constexpr int kOut = D;  // dx
  __host__ __device__ static constexpr int p(int e) { return e; }
  __host__ __device__ static constexpr int qp(int a, int e) { return D + a * D + e; }
  __host__ __device__ static constexpr int qdp() { return D + D * D; }
  __host__ __device__ static constexpr int qqdp(int a) { return D + D * D + 1 + a; }
  __host__ __device__ static constexpr Term term(int c) {
    constexpr int one = B::kOne;
    if (c < D) return {B::kV + c, one, one};
    if (c < qdp()) return {B::kY + (c - D) / D, B::kV + (c - D) % D, one};
    if (c == qdp()) return {B::kYV, one, one};
    return {B::kY + c - qqdp(0), B::kYV, one};
  }
  // dx of one row from its sums A, x = x_l - c, gx_l and mx_l (the identities
  // of _ext_bwd_dx_mm_kernel):
  //   dx_f = -u (x_f sum_e Gx_e A[p_e] - sum_e Gx_e A[q_f p_e])
  //          - u cl (x_f sum_e x_e A[p_e] - x_f A[q.p] - sum_e x_e A[q_f p_e]
  //                  + A[q_f (q.p)])
  //          + cl A[p_f],          Gx = mx gx,  cl = u gc mx
  __host__ __device__ static void epilogue(const float* A, const float* x, const float* g,
                                           float m, float u, float cc, float* out) {
    float big_g[D], sgp = 0.f, sxp = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) {
      big_g[e] = m * g[e];
      sgp = fmaf(big_g[e], A[p(e)], sgp);
      sxp = fmaf(x[e], A[p(e)], sxp);
    }
    const float cl = u * cc * m;
#pragma unroll
    for (int f = 0; f < D; ++f) {
      float s1 = x[f] * sgp;
      float s2 = fmaf(x[f], sxp - A[qdp()], A[qqdp(f)]);
#pragma unroll
      for (int e = 0; e < D; ++e) {
        s1 = fmaf(-big_g[e], A[qp(f, e)], s1);
        s2 = fmaf(-x[e], A[qp(f, e)], s2);
      }
      out[f] = fmaf(cl, A[p(f)], -u * fmaf(cl, s2, s1));
    }
  }
};

// dq/dp: rows the support (coordinates q, payload p, mask mq), columns the
// data (x, gx, mx); the table of _ext_bwd_dqdp_mm_kernel in its order.
template <int D>
struct DqdpSpec {
  using B = Base<D>;
  static constexpr int kPairs = D * (D + 1) / 2;
  static constexpr int kC = D + D * D + 1 + D + kPairs;
  static constexpr int kOut = 2 * D;  // dq, dp
  __host__ __device__ static constexpr int pair(int a, int b) {
    return a <= b ? a * D - a * (a - 1) / 2 + (b - a) : pair(b, a);
  }
  __host__ __device__ static constexpr int G(int f) { return f; }
  __host__ __device__ static constexpr int xG(int a, int f) { return D + a * D + f; }
  __host__ __device__ static constexpr int m() { return D + D * D; }
  __host__ __device__ static constexpr int mx(int f) { return D + D * D + 1 + f; }
  __host__ __device__ static constexpr int mxx(int a, int b) {
    return D + D * D + 1 + D + pair(a, b);
  }
  __host__ __device__ static constexpr Term term(int c) {
    constexpr int one = B::kOne;
    if (c < D) return {B::kV + c, one, one};
    if (c < m()) return {B::kY + (c - D) / D, B::kV + (c - D) % D, one};
    if (c == m()) return {one, one, one};
    if (c < mxx(0, 0)) return {B::kY + c - mx(0), one, one};
    const int r = c - mxx(0, 0);
    int a = 0;
    while (pair(a, D - 1) < r) ++a;
    return {B::kY + a, B::kY + a + r - pair(a, a), one};
  }
  // dq, dp of one row from its sums A, x = q_l - c, p_l and mq_l (the
  // identities of _ext_bwd_dqdp_mm_kernel):
  //   dp_f = m [A[G_f] + u gc (A[m x_f] - x_f A[m])]
  //   dq_e = m [u sum_f p_f (A[x_e G_f] - x_e A[G_f])
  //             + u^2 gc (sum_f p_f A[m x_e x_f] - (x.p) A[m x_e]
  //                       - x_e sum_f p_f A[m x_f] + x_e (x.p) A[m])
  //             - u gc p_e A[m]]
  __host__ __device__ static void epilogue(const float* A, const float* x, const float* pl,
                                           float ml, float u, float cc, float* out) {
    float xp = 0.f, spx = 0.f;
#pragma unroll
    for (int f = 0; f < D; ++f) {
      xp = fmaf(x[f], pl[f], xp);
      spx = fmaf(pl[f], A[mx(f)], spx);
    }
    const float am = A[m()];
#pragma unroll
    for (int e = 0; e < D; ++e) {
      float s1 = 0.f;
      float s2 = fmaf(x[e], fmaf(xp, am, -spx), -xp * A[mx(e)]);
#pragma unroll
      for (int f = 0; f < D; ++f) {
        s1 = fmaf(pl[f], fmaf(-x[e], A[G(f)], A[xG(e, f)]), s1);
        s2 = fmaf(pl[f], A[mxx(e, f)], s2);
      }
      out[e] = ml * u * fmaf(cc, fmaf(u, s2, -pl[e] * am), s1);
      out[D + e] = ml * fmaf(u * cc, fmaf(-x[e], am, A[mx(e)]), A[G(e)]);
    }
  }
};

// the entries the epilogues read are those the producer writes
static_assert(DxSpec<2>::kC == 9 && DxSpec<3>::kC == 16 && DqdpSpec<2>::kC == 12 &&
                  DqdpSpec<3>::kC == 22,
              "_ext_bwd_*_mm_kernel table widths");
static_assert(DxSpec<3>::term(DxSpec<3>::qp(2, 1)).f0 == Base<3>::kY + 2 &&
                  DxSpec<3>::term(DxSpec<3>::qp(2, 1)).f1 == Base<3>::kV + 1 &&
                  DxSpec<2>::term(DxSpec<2>::qqdp(1)).f0 == Base<2>::kY + 1 &&
                  DqdpSpec<3>::term(DqdpSpec<3>::mxx(1, 2)).f1 == Base<3>::kY + 2 &&
                  DqdpSpec<3>::term(DqdpSpec<3>::mxx(2, 2)).f0 == Base<3>::kY + 2 &&
                  DqdpSpec<2>::term(DqdpSpec<2>::mx(1)).f0 == Base<2>::kY + 1 &&
                  DqdpSpec<2>::term(DqdpSpec<2>::m()).f0 == Base<2>::kOne,
              "table entries");

template <class Sp, int G, int J>
struct ExtShape {
  static constexpr int kSteps = J / 8;          // k-steps of 8 columns a tile
  static constexpr int kProdGroups = 128 / J;   // producer warps a column
  static constexpr int kNT = (Sp::kC + 7) / 8;  // n-tiles of 8 (zero columns past kC)
  static constexpr int kN = 8 * kNT;
  static constexpr int kStages = 3;
  // 16-byte words of one k-step of T_hi (or T_lo): NT x 2 core matrices, then
  // padding to 2 (mod 8) words (as rhs_self.cu's TabShape)
  static constexpr int kKSW =
      kNT * 2 * kCoreWords + ((2 - kNT * 2 * kCoreWords) % 8 + 8) % 8;
  static constexpr int kTabWords = kSteps * kKSW;        // T_hi (or T_lo) of a tile
  static constexpr int kStageWords = J + 2 * kTabWords;  // column records, T_hi, T_lo
  static constexpr int kAStride = kN + 1;  // floats a row of the staged sums
  static constexpr int kRows = 64 * G;
  static constexpr int kThreads = 128 * G + 128;  // and one producer warpgroup
  static constexpr int kSmem = kStages * kStageWords * 16 + kRows * kAStride * 4;
  // two blocks an SM where their registers fit without spilling (the
  // 24-column dq/dp table at d = 3 spilled at two blocks of 128 rows)
  static constexpr int kMinBlocks = G == 4 || kNT > 2 ? 1 : 2;
};

struct ExtArgs {
  const float* rq;   // rows: coordinates (B, R, D), payload (B, R, D), mask (B, R)
  const float* rv;
  const float* rm;
  const float* cq;   // columns: coordinates (B, Nc, D), payload (B, Nc, D), mask (B, Nc)
  const float* cv;
  const float* cm;
  const float* gc;   // (B) cotangent of each frame's dcost, on the device
  const int* order;  // (B, Ro) rows in spatial order, -1 for a padding slot
  float* o0;         // outputs (B, R, D): dx; or dq and dp
  float* o1;
  float* part;       // chunk partials (B, row blocks, C, 64 G, kOut), when C > 1
  int* ticket;       // (B, row blocks): 0 at the launch, left 0
  int R, Nc, Ro, L;  // L: columns a chunk (gridDim.y chunks)
  float u;
  int withlogdet;
};

// One block: 64 G slots of the rows' order of one frame against the columns
// [chunk L, chunk L + L) of that frame, in tiles of J columns.  Threads
// 0 .. 128 G - 1 are the consumer warpgroups, the last 128 the producer.
template <class Sp, int D, int G, int J>
__global__ void __launch_bounds__(ExtShape<Sp, G, J>::kThreads, ExtShape<Sp, G, J>::kMinBlocks)
ext_table_kernel(const ExtArgs args) {
  using S = ExtShape<Sp, G, J>;
  using Bs = Base<D>;
  constexpr int N8 = S::kN, ND = N8 / 2, ST = S::kStages, KSW = S::kKSW;
  constexpr int NO = Sp::kOut;
  extern __shared__ __align__(128) uint4 smem[];
  __shared__ uint64_t full[ST], empty[ST];
  __shared__ float red[2 * G][D + 1];
  __shared__ float cen[D];
  __shared__ int last;

  const size_t frame = blockIdx.z;
  const int chunk = blockIdx.y, n_chunks = gridDim.y;
  const int R = args.R, Nc = args.Nc, Ro = args.Ro;
  const int* order = args.order + frame * Ro;
  const float* rq = args.rq + frame * R * D;
  const float* rm = args.rm + frame * R;
  const int row_base = blockIdx.x * S::kRows;
  const int tid = threadIdx.x;
  // the row of slot r, -1 past the end and for padding
  auto row_of = [&](int r) { return r >= Ro ? -1 : order[r]; };

  // zero the stages (the table's columns past kC, and the unused words,
  // stay zero), and set up the barriers
  for (int i = tid; i < ST * S::kStageWords; i += blockDim.x) smem[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 128);
      mbar_init(&empty[i], 4 * G);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the masked centroid of the block's rows, in a fixed order
  {
    float s[D + 1];
#pragma unroll
    for (int e = 0; e <= D; ++e) s[e] = 0.f;
    const int i = tid < S::kRows ? row_of(row_base + tid) : -1;
    if (i >= 0) {
      const float mi = rm[i];
#pragma unroll
      for (int d = 0; d < D; ++d) s[d] = mi * rq[(size_t)i * D + d];
      s[D] = mi;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int e = 0; e <= D; ++e) s[e] += __shfl_xor_sync(0xffffffffu, s[e], off);
    if (tid < S::kRows && (tid & 31) == 0)
#pragma unroll
      for (int e = 0; e <= D; ++e) red[tid >> 5][e] = s[e];
  }
  // the zeroed stages are read by the tensor cores (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    float s[D + 1];
#pragma unroll
    for (int e = 0; e <= D; ++e) s[e] = 0.f;
    for (int w = 0; w < 2 * G; ++w)
#pragma unroll
      for (int e = 0; e <= D; ++e) s[e] += red[w][e];
    const float inv = 1.f / fmaxf(s[D], 1.f);
#pragma unroll
    for (int d = 0; d < D; ++d) cen[d] = s[d] * inv;
  }
  __syncthreads();

  // coordinates centred on cen and scaled by sc, so that k = 2^(-|x - y|^2)
  // (the columns' in their staged records, the rows' in the consumers)
  const float sc = sqrtf(0.5f * args.u * kLog2e);
  const int lo = chunk * args.L;
  const int n_cols = min(Nc, lo + args.L) - lo;
  const int n_tiles = (n_cols + J - 1) / J;
  if (tid >= 128 * G) {
    // the producer: thread pt builds column jj of each tile, the entries c =
    // grp (mod 128 / J) (grp the same for a whole warp)
    const int pt = tid - 128 * G;
    const int jj = pt & (J - 1);
    const int grp = pt / J;
    const size_t fo = frame * Nc + lo;
    // a column's values: coordinates, payload, mask
    auto load = [&](int tile, float (&v)[2 * D + 1]) {
      const int j = tile * J + jj;
      const bool ok = j < n_cols;
      const size_t o = (fo + j) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        v[d] = ok ? args.cq[o + d] : 0.f;
        v[D + d] = ok ? args.cv[o + d] : 0.f;
      }
      v[2 * D] = ok ? args.cm[fo + j] : 0.f;  // m = 0: no contribution
    };
    float c[D];
#pragma unroll
    for (int d = 0; d < D; ++d) c[d] = cen[d];
    const int ks = jj >> 3, kh = (jj >> 2) & 1;
    // float offset of column jj's entry in row 0 of n-tile 0 of a matrix
    const int col_off = (ks * KSW + kh * kCoreWords) * 4 + (jj & 3);
    float cur[2 * D + 1], nxt[2 * D + 1];
    load(0, cur);
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int st = tile % ST;
      if (tile + 1 < n_tiles) load(tile + 1, nxt);
      if (tile >= ST) mbar_wait(&empty[st], ((tile / ST) - 1) & 1);
      uint4* sm = smem + st * S::kStageWords;
      float base[Bs::kCount];
      base[Bs::kOne] = 1.f;
      float yv = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float y = cur[d] - c[d];
        base[Bs::kY + d] = y;
        base[Bs::kV + d] = cur[D + d];
        yv = fmaf(y, cur[D + d], yv);
      }
      base[Bs::kYV] = yv;
      const float mj = cur[2 * D];
      if (grp == 0)
        reinterpret_cast<float4*>(sm)[jj] = make_float4(
            base[Bs::kY] * sc, base[Bs::kY + 1] * sc, D == 3 ? base[Bs::kY + D - 1] * sc : 0.f, 0.f);
      float* hi = reinterpret_cast<float*>(sm + J) + col_off;
      float* lo_ = hi + 4 * S::kTabWords;
      static_for<0, Sp::kC>([&](auto ci) {
        constexpr int cc = decltype(ci)::value;
        if (cc % S::kProdGroups != grp) return;
        constexpr Term tm = Sp::term(cc);
        const float v = mj * base[tm.f0] * base[tm.f1] * base[tm.f2];
        const uint32_t h = tf32_rna(v);
        constexpr int o = ((cc >> 3) * 2 * kCoreWords + (cc & 7)) * 4;
        hi[o] = __uint_as_float(h);
        lo_[o] = __uint_as_float(tf32_rna(v - __uint_as_float(h)));
      });
      // written by the generic proxy, read by wgmma through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(&full[st]);
#pragma unroll
      for (int e = 0; e < 2 * D + 1; ++e) cur[e] = nxt[e];
    }
    return;
  }

  const int group = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  // this lane's rows of its warpgroup's 64: row0 + g and row0 + g + 8
  const int row0 = 64 * group + 16 * warp;
  float xr[2][D];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row_of(row_base + row0 + g + 8 * h);
#pragma unroll
    for (int d = 0; d < D; ++d) xr[h][d] = i >= 0 ? (rq[(size_t)i * D + d] - cen[d]) * sc : 0.f;
  }

  // running totals, and the tile's sums (the wgmma accumulators): pa the
  // k_hi T_hi products, pb the two small ones
  float acc[ND], pa[ND], pb[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    acc[i] = 0.f;
    pa[i] = 0.f;
    pb[i] = 0.f;
  }
  // A fragments, {A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]} of
  // the k-step's 16 x 8 share, double-buffered
  uint32_t ahi[2][4], alo[2][4];

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile % ST;
    mbar_wait(&full[st], (tile / ST) & 1);
    const uint4* sm = smem + st * S::kStageWords;
    const float4* ys = reinterpret_cast<const float4*>(sm);
    const uint32_t bhi = smem_addr(sm + J);
    const uint32_t blo = bhi + S::kTabWords * 16;

    // k-steps in pairs: the exponentials of both first, then their products
#pragma unroll
    for (int k2 = 0; k2 < S::kSteps; k2 += 2) {
      float kv2[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ks = k2 + j;
        const float4 ya = ys[8 * ks + t], yb = ys[8 * ks + t + 4];
        const float yv[2][3] = {{ya.x, ya.y, ya.z}, {yb.x, yb.y, yb.z}};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int h = v & 1, col = v >> 1;
          float r2n = 0.f;  // u log2(e) / 2 times -|x_l - y_j|^2
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float dd = xr[h][d] - yv[col][d];
            r2n = fmaf(-dd, dd, r2n);
          }
          kv2[j][v] = ex2(r2n);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ks = k2 + j, buf = j;
        const float* kv = kv2[j];
        if (ks >= 2) {
          // the products of k-step ks - 2 read this A buffer
          wgmma_wait<1>();
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            pin(ahi[buf][v]);
            pin(alo[buf][v]);
          }
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          // k_hi: k truncated to TF32, as the tensor cores read it; k_lo = k -
          // k_hi, exact, read truncated in its turn
          ahi[buf][v] = __float_as_uint(kv[v]) & 0xffffe000u;
          alo[buf][v] = __float_as_uint(kv[v] - __uint_as_float(ahi[buf][v]));
        }
        const uint64_t dhi =
            smem_desc(bhi + ks * KSW * 16, kCoreWords * 16, 2 * kCoreWords * 16);
        const uint64_t dlo =
            smem_desc(blo + ks * KSW * 16, kCoreWords * 16, 2 * kCoreWords * 16);
        wgmma_fence();
        Wgmma<N8>::run(pb, alo[buf], dhi, ks > 0);  // k_lo T_hi (a fresh sum at ks = 0)
        Wgmma<N8>::run(pb, ahi[buf], dlo, 1);       // k_hi T_lo
        Wgmma<N8>::run(pa, ahi[buf], dhi, ks > 0);  // k_hi T_hi
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      pin(pa[i]);
      pin(pb[i]);
    }
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        pin(ahi[b][v]);
        pin(alo[b][v]);
      }
    // this warp is done with the stage: its reads of the column records and
    // its share of the products have completed
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] += pb[i] + pa[i];
  }

  // stage the sums, one row of kN columns a row: accumulator i holds row
  // g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2
  float* abuf = reinterpret_cast<float*>(smem + ST * S::kStageWords);
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const int r = row0 + g + 8 * ((i >> 1) & 1);
    abuf[r * S::kAStride + 8 * (i >> 2) + 2 * t + (i & 1)] = acc[i];
  }
  asm volatile("bar.sync 1, %0;" ::"n"(128 * G) : "memory");  // the consumers only

  const int ir = tid < S::kRows ? row_of(row_base + tid) : -1;
  float out[NO];
#pragma unroll
  for (int e = 0; e < NO; ++e) out[e] = 0.f;
  if (ir >= 0) {
    const float* A = abuf + tid * S::kAStride;
    const size_t i = ir;
    float x[D], v[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = rq[i * D + d] - cen[d];
      v[d] = args.rv[(frame * R + i) * D + d];
    }
    const float cc = args.withlogdet ? args.gc[frame] : 0.f;
    Sp::epilogue(A, x, v, rm[i], args.u, cc, out);
  }
  const size_t o = (frame * R + (ir < 0 ? 0 : ir)) * D;
  if (n_chunks == 1) {
    if (ir >= 0)
#pragma unroll
      for (int e = 0; e < NO; ++e) (e < D ? args.o0 : args.o1)[o + e % D] = out[e];
    return;
  }
  // a chunk of the columns: its partial outputs, then the last block of the
  // row block to finish sums the chunks' partials in chunk order
  const size_t rb = frame * gridDim.x + blockIdx.x;
  float* part_rb = args.part + rb * n_chunks * S::kRows * NO;
  if (tid < S::kRows) {
#pragma unroll
    for (int e = 0; e < NO; ++e)
      part_rb[((size_t)chunk * S::kRows + tid) * NO + e] = out[e];
  }
  __threadfence();
  asm volatile("bar.sync 1, %0;" ::"n"(128 * G) : "memory");
  if (tid == 0) {
    last = atomicAdd(&args.ticket[rb], 1) == n_chunks - 1;
    __threadfence();
  }
  asm volatile("bar.sync 1, %0;" ::"n"(128 * G) : "memory");
  if (!last) return;
  if (ir >= 0) {
    float s[NO];
#pragma unroll
    for (int e = 0; e < NO; ++e) s[e] = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch)
#pragma unroll
      for (int e = 0; e < NO; ++e) s[e] += __ldcg(&part_rb[((size_t)ch * S::kRows + tid) * NO + e]);
#pragma unroll
    for (int e = 0; e < NO; ++e) (e < D ? args.o0 : args.o1)[o + e % D] = s[e];
  }
  if (tid == 0) args.ticket[rb] = 0;
}

template <class Sp, int D, int G, int J>
int launch_table(const ExtArgs& args, int B, int n_chunks, cudaStream_t s) {
  using S = ExtShape<Sp, G, J>;
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        ext_table_kernel<Sp, D, G, J>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  const dim3 grid((args.Ro + S::kRows - 1) / S::kRows, n_chunks, B);
  ext_table_kernel<Sp, D, G, J><<<grid, S::kThreads, S::kSmem, s>>>(args);
  return (int)cudaGetLastError();
}

// A block of `rows` slots of the rows' order (64 G), as ops/rhs_ext.py
// chooses it: 64 or 128 for dx (dx_block_rows), 64, 128 or 256 for dq/dp
// (ops/rhs_self.py block_rows).
template <class Sp, int D, int kMaxRows>
int launch_rows(const ExtArgs& args, int B, int rows, int n_chunks, cudaStream_t s) {
  if (rows == 64) return launch_table<Sp, D, 1, kTileCols>(args, B, n_chunks, s);
  if (rows == 128) return launch_table<Sp, D, 2, kTileCols>(args, B, n_chunks, s);
  if constexpr (kMaxRows >= 256) {
    if (rows == 256) return launch_table<Sp, D, 4, kTileCols>(args, B, n_chunks, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: (B, N, D), mx: (B, N); q, p: (B, M, D), mq: (B, M), all float32.
// Writes vx (B, N, D) and dc (B, N), the per-row partials of the divergence
// cost; the gradcomponent terms of eta when use_eta is nonzero (the ETA
// kind, at any eta, 0 included; use_eta = 0 runs the eta = 0 kind).  rows:
// the block's 128 data rows; the support cut into C = ceil(M / L) chunks of
// L columns (a multiple of 32); with C > 1 part holds B ceil(N / 128) C 128
// (D + 1) floats of scratch and ticket B ceil(N / 128) int32, all 0 at the
// call and left 0 (part and ticket may be null with one chunk).  Returns
// cudaGetLastError() after the launch.
int difficp_rhs_ext_fwd_eta(const void* x, const void* mx, const void* q,
                            const void* p, const void* mq, void* vx, void* dc,
                            void* part, void* ticket, int rows, int L, int B, int N,
                            int M, int D, float u, int withlogdet, float eta,
                            int use_eta, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || B > 65535 || (D != 2 && D != 3))
    return (int)cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const DirectArgs a{xf,
                     xf,
                     static_cast<const float*>(mx),
                     static_cast<const float*>(q),
                     static_cast<const float*>(p),
                     static_cast<const float*>(mq),
                     static_cast<float*>(vx),
                     static_cast<float*>(dc),
                     nullptr,
                     static_cast<float*>(part),
                     static_cast<int*>(ticket),
                     N,
                     M,
                     L,
                     u,
                     use_eta ? eta : 0.f,
                     withlogdet};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 2)
    return use_eta ? launch_direct<ExtFwd<2, true>>(a, B, rows, s)
                   : launch_direct<ExtFwd<2, false>>(a, B, rows, s);
  return use_eta ? launch_direct<ExtFwd<3, true>>(a, B, rows, s)
                 : launch_direct<ExtFwd<3, false>>(a, B, rows, s);
}

// gx: (B, N, D) cotangent of vx; gc: (B,) cotangent of each frame's dcost, on
// the device.  The data rows through order (B, No) (each row once, -1 in
// padding slots) in blocks of `rows` slots, 64 or 128 (two blocks an SM;
// blocks of 256 ran slower on an H100).  Writes dx (B, N, D).
int difficp_rhs_ext_bwd_dx(const void* x, const void* mx, const void* gx,
                           const void* q, const void* p, const void* mq,
                           const void* gc, const void* order, int No, int rows,
                           void* dx, int B, int N, int M, int D, float u,
                           int withlogdet, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || B > 65535 || (D != 2 && D != 3) ||
      order == nullptr || No < N)
    return (int)cudaErrorInvalidValue;
  const ExtArgs args{static_cast<const float*>(x),  static_cast<const float*>(gx),
                     static_cast<const float*>(mx), static_cast<const float*>(q),
                     static_cast<const float*>(p),  static_cast<const float*>(mq),
                     static_cast<const float*>(gc), static_cast<const int*>(order),
                     static_cast<float*>(dx),       nullptr,
                     nullptr,                       nullptr,
                     N,                             M,
                     No,                            M,
                     u,                             withlogdet};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 2 ? launch_rows<DxSpec<2>, 2, 128>(args, B, rows, 1, s)
                : launch_rows<DxSpec<3>, 3, 128>(args, B, rows, 1, s);
}

// As difficp_rhs_ext_bwd_dx; the support's rows through order (B, Mo) (each
// row once, -1 in padding slots) in blocks of `rows` slots, the data axis cut
// into C = ceil(N / L) chunks of L columns (C <= 65535).  part: scratch of
// B ceil(Mo / rows) C rows 2 D floats; ticket: B ceil(Mo / rows) int32, all 0
// at the call and left 0.  Writes dq, dp (B, M, D).
int difficp_rhs_ext_bwd_dqdp(const void* x, const void* mx, const void* gx,
                             const void* q, const void* p, const void* mq,
                             const void* gc, const void* order, int Mo, int rows,
                             void* dq, void* dp, void* part, void* ticket, int B,
                             int N, int M, int D, int L, float u, int withlogdet,
                             void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || L <= 0 || B > 65535 || (D != 2 && D != 3) ||
      order == nullptr || Mo < M)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (N + L - 1) / L;
  if (n_chunks > 65535 || (n_chunks > 1 && (part == nullptr || ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  const ExtArgs args{static_cast<const float*>(q),  static_cast<const float*>(p),
                     static_cast<const float*>(mq), static_cast<const float*>(x),
                     static_cast<const float*>(gx), static_cast<const float*>(mx),
                     static_cast<const float*>(gc), static_cast<const int*>(order),
                     static_cast<float*>(dq),       static_cast<float*>(dp),
                     static_cast<float*>(part),     static_cast<int*>(ticket),
                     M,                             N,
                     Mo,                            L,
                     u,                             withlogdet};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 2 ? launch_rows<DqdpSpec<2>, 2, 256>(args, B, rows, n_chunks, s)
                : launch_rows<DqdpSpec<3>, 3, 256>(args, B, rows, n_chunks, s);
}

}  // extern "C"
