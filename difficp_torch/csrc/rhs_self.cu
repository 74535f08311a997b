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
//             _rhs_self_sym_pair_kernel mode="bwd" (via _sym_block_grads), and
//             the streaming _rhs_self_bwd_kernel (via _rhs_self_bwd_pallas).
//
// The eta = 0 forward and the backward are, as in those TPU kernels, a table
// kernel-sum followed by a per-row epilogue:
//
//   A[c]_i = sum_j k_ij m_j T_c(j)
//
// with a table T of payload columns built from the column j: the JAX
// package's _fwd_col_table (1, y, p, y p^T: 1 + 2D + D^2 columns, 9 at D = 2)
// forward and _bwd_col_table (45 columns at D = 2, 104 at D = 3) backward,
// where y = q_j - c and c is the masked centroid of the row block.  Every
// output depends only on differences q_i - q_j, so the shift by c is exact;
// the epilogues (Fwd and Bwd below) recombine A with the row's x = q_i - c,
// p_i (and a_i, b_i backward) through the identities of _rhs_self_mm_kernel
// and _rhs_self_bwd_mm_kernel.  The recombination cancels terms of up to
// degree 1 (forward) and 3 (backward) in the coordinates, which amplifies the
// sums' rounding by up to (R / sigma)^2 for a row block of radius R: so the
// rows are taken in a spatial order, and each block re-centres its table on
// its own rows.  The order is an int32 index per frame that ops/rhs_self.py
// computes once per shoot, optimisation or solve: the rows sorted by Morton
// code (as the JAX wrappers sort by _morton_order), cut where the Z-curve
// jumps and padded there with empty slots (-1), so that no block straddles
// two distant parts of the cloud (row_order).  Blocks read their rows, and
// write their outputs, through that index; columns stay in natural order.
//
// What bounds it on an H100: operations.  Per ordered pair one exponential
// (MUFU, 4.1875e12/s), 3 x 2 x 8 NT tensor-core FLOP (the table padded to NT
// n-tiles of 8 columns: 16 columns forward, 48 backward at D = 2; three TF32
// products for float32 accuracy; 495 TFLOP/s dense) and 3 D + 2 FP32
// operations for the distance, the exponent's scale and the split of k.  At
// D = 2 the forward is bound by the MUFU, the backward by the tensor cores.
// The function's own least work (ops/rhs_self.py fwd_ops_per_unordered_pair,
// bwd_ops_per_unordered_pair: 15 D + 2 and 34 D + 3 FP32 operations and one
// exponential per unordered pair) is the bound the kernel table states.
//
// What the design does about it (the wgmma pieces are ksum.cu's, from
// wgmma.cuh):
// - The product runs on the tensor cores: wgmma m64nNk8 TF32, A the tile of
//   exponentials (64 rows by 8 columns, computed in registers in its fragment
//   layout, double-buffered), B the table from shared memory; 3xTF32, k_lo
//   T_hi + k_hi T_lo + k_hi T_hi; each tile of J columns summed in its own
//   accumulators and then added to the running totals in float32 (the tensor
//   cores truncate as they accumulate).  k is formed from differences, never
//   from |q_i|^2 + |q_j|^2 - 2 q_i.q_j.
// - The table depends on the row block (its centroid), so it cannot be laid
//   out once per call.  A producer warpgroup builds it, tile by tile, into a
//   ring of 3 or 4 shared-memory stages (2 or 3 for the widest table): it
//   loads the columns' values a tile ahead, forms the entries, splits them
//   into T_hi and T_lo in the B core-matrix layout and releases the stage on
//   an mbarrier; each consumer warpgroup waits for a stage on its own and
//   gives it back on a second mbarrier, so the warpgroups are not held in
//   step.  A block's
//   warpgroups share one centroid and one table.  The build costs C entries
//   per column against 64 G exponentials per column (G consumer warpgroups).
//   Each core matrix is followed by one unused 16-byte word (LBO 144, SBO 288
//   bytes), so that a warp writing one entry of 32 consecutive columns hits
//   32 different banks.
// - The epilogue needs a row's whole set of columns, which the wgmma
//   fragment spreads over a quad of threads: the sums are staged through
//   shared memory, one row a thread, and the row-side values are read there
//   from global memory, not kept live through the main loop.
// - A block is G = 4 consumer warpgroups (256 slots of the order; at most 2
//   for the 104-column table, whose accumulators take twice the registers),
//   fewer when the grid would not fill the SMs (the grid support's 10 frames
//   of 380 points run 64 a block): ops/rhs_self.py block_rows chooses, and
//   pads the order's runs to whole blocks, without adding a wave.
// - Tiles of J = 64 columns from kLongJMinCols columns on, 32 below (kLongJ,
//   kShortJ): a long tile costs fewer drains and sums, a short one truncates
//   less where a row's neighbours fall in few tiles.
//
// The any-eta forward (rows against columns: SelfEta below, on direct.cuh's
// direct_kernel) replaces the streaming _rhs_self_kernel (via
// _rhs_self_fwd_pallas, and between two sets via _rhs_cross_fwd_stream).  It
// stays a direct pair sum: at eta != 0 a table form needs monomials of degree
// 3 in the columns' coordinates, whose cancellation in float32 is the fault
// ROADMAP.md section 3 logs for the generated forward.
//
// What bounds it on an H100: operations.  The function's least work is 24 D
// + 7 FP32 operations and one exponential per unordered pair
// (ops/rhs_self.py fwd_eta_ops_per_unordered_pair); the kernel takes each
// ordered pair apart, one ex2 and 9 D + 6 FP32 instructions each, so the FP32
// pipe's issue slots set its pace, not the MUFU; and the main paths' row
// counts are small (8,192, and the grid eta path's 10 x 380): blocks of rows
// alone would leave most SMs idle.
//
// What the design does about it:
// - Every SM busy at every main-path shape: blocks of 4 warps over 64 rows
//   (2 a thread), the column axis cut into chunks on a second grid axis where
//   the row blocks alone would not give each SM a few blocks
//   (ops/rhs_self.py direct_chunk_cols), the chunks' partials summed in chunk
//   order after an integer ticket (direct.cuh).
// - Few issue slots a pair.  Coordinates prescaled by s = sqrt(u log2(e) /
//   2), so k = ex2(-|d'|^2) with no multiply, one ex2.approx.ftz a pair; the
//   column mask folded into the record's payload (p~ = m p) for the sums of
//   p, one multiply km = k m for the others; one record load for two rows.
//   Five running sums a row beside v (3 D + 2 in all, where the header's
//   terms take 5 D + 3): with c = p_i - p_j, w's three vector sums, sum k~
//   (p_i.p_j) d, sum k~ (d.c) d and sum k~ r2 d, are one sum, sum_j t_ij d',
//   with
//     t = k p~.(alpha p_i - beta d') + km (beta p_i.d' + gamma r2'),
//   alpha = u / s, beta = eta u^2 / s^2 and gamma = -eta^2 u^3 / s^3
//   constants of the launch; dcost's sum k~ (p_i.d) is p_i.(sum k~ d), a sum
//   the eta terms take anyway.  The scale comes off per row in the epilogue.
// - Each tile of 32 columns is summed in its own registers and then added to
//   the warp's totals.  The prescaled coordinates round relative to |s q|,
//   not to |d|: a pair's exponent moves by up to about 2^-23 |s q| |d'|, a
//   relative error of the sums of a few 1e-7 at the main paths' |s q| < 20.
// The ETA kind is the only one: eta = 0 takes the table kernels at every
// shape.

#include <cuda_runtime.h>
#include <stdint.h>

#include "direct.cuh"
#include "tile.cuh"
#include "wgmma.cuh"

namespace {

// The any-eta forward's pair arithmetic (rows q, p, m against columns qc,
// pc, mc; the header's forward with its gradcomponent terms).  Sums a row,
// on prescaled coordinates (d' = s d, r2' = s^2 r2, r2n = -r2', k~ = m_j k):
// V = sum k p~ (D), T = sum t d' (D, t above), K = sum k~, KD = sum k~ d'
// (D), KR2 = sum k~ r2n.
template <int D>
struct SelfEta {
  static constexpr int kD = D, kRows = 2, kFields = 2 * D + 1, kSums = 3 * D + 2;
  static constexpr int kOut = 2 * D + 1;
  static constexpr int kV = 0, kT = D, kK = 2 * D, kKD = 2 * D + 1, kKR2 = 3 * D + 1;
  struct Consts {
    Scale sc;
    float alpha, beta, gamma;
  };
  struct Row {
    float x[D], ap[D], bp[D];  // s q_i, alpha p_i, beta p_i
  };

  __device__ static Consts consts(const DirectArgs& a, const Scale& sc) {
    const float beta = a.eta * a.u * sc.us2;
    return {sc, sc.us, beta, -beta * a.eta * a.u / sc.s};
  }

  __device__ static void row(const Consts& c, const float* q, const float* p, int i, Row& r) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float qi = i >= 0 ? q[(size_t)i * D + d] : 0.f;
      const float pi = i >= 0 ? p[(size_t)i * D + d] : 0.f;
      r.x[d] = c.sc.s * qi;
      r.ap[d] = c.alpha * pi;
      r.bp[d] = c.beta * pi;
    }
  }

  // the record: s qc_j, mc_j pc_j, mc_j (zeros for j = -1)
  __device__ static void column(const Consts& c, const float* qc, const float* pc,
                                const float* mc, int j, float (&f)[kFields]) {
    const float mj = j >= 0 ? mc[j] : 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      f[d] = j >= 0 ? c.sc.s * qc[(size_t)j * D + d] : 0.f;
      f[D + d] = j >= 0 ? mj * pc[(size_t)j * D + d] : 0.f;
    }
    f[2 * D] = mj;
  }

  __device__ static void pair(const Consts& c, const Row& r, const float (&f)[kFields],
                              float (&S)[kSums]) {
    float dd[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dd[d] = r.x[d] - f[d];
    float r2n = __fmul_rn(-dd[0], dd[0]);
#pragma unroll
    for (int d = 1; d < D; ++d) r2n = fmaf(-dd[d], dd[d], r2n);
    const float k = ex2(r2n);
    const float km = __fmul_rn(k, f[2 * D]);
    // t = k p~.(alpha p_i - beta d') + km (beta p_i.d' + gamma r2')
    float g = __fmul_rn(f[D], fmaf(-c.beta, dd[0], r.ap[0]));
    float b = __fmul_rn(dd[0], r.bp[0]);
#pragma unroll
    for (int d = 1; d < D; ++d) {
      g = fmaf(f[D + d], fmaf(-c.beta, dd[d], r.ap[d]), g);
      b = fmaf(dd[d], r.bp[d], b);
    }
    const float t = fmaf(k, g, __fmul_rn(km, fmaf(-c.gamma, r2n, b)));
#pragma unroll
    for (int d = 0; d < D; ++d) {
      S[kV + d] = fmaf(k, f[D + d], S[kV + d]);
      S[kT + d] = fmaf(t, dd[d], S[kT + d]);
      S[kKD + d] = fmaf(km, dd[d], S[kKD + d]);
    }
    S[kK] += km;
    S[kKR2] = fmaf(km, r2n, S[kKR2]);
  }

  // v = m_i (V + eta u KD / s)
  // w = m_i (T - eta u (p_i K - V) + eta^2 u^2 (D + 2) KD / s)
  // dc = m_i (-u p_i.KD / s + eta u (-u KR2 / s^2 - D K))  (0 without logdet)
  __device__ static void epilogue(const Consts& c, const DirectArgs& a, const float* p,
                                  const float* m, int i, const float (&S)[kSums],
                                  float (&out)[kOut]) {
    const float mi = m[i];
    const float eu = a.eta * a.u;
    const float cv = eu / c.sc.s;
    const float cw = eu * cv * (D + 2);
    float pkd = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float pi = p[(size_t)i * D + d];
      const float kc = fmaf(pi, S[kK], -S[kV + d]);  // sum k~ c
      out[d] = mi * fmaf(cv, S[kKD + d], S[kV + d]);
      out[D + d] = mi * fmaf(cw, S[kKD + d], fmaf(-eu, kc, S[kT + d]));
      pkd = fmaf(pi, S[kKD + d], pkd);
    }
    out[2 * D] = a.withlogdet
                     ? mi * fmaf(eu, fmaf(-c.sc.us2, S[kKR2], -D * S[kK]), -c.sc.us * pkd)
                     : 0.f;
  }

  __device__ static void store(const DirectArgs& a, size_t frame, int i, const float (&o)[kOut]) {
    const size_t at = (frame * a.M + i) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      a.o0[at + d] = o[d];
      a.o1[at + d] = o[D + d];
    }
    a.o2[frame * a.M + i] = o[2 * D];
  }
};

// ---------------------------------------------------------------------------
// eta = 0: the table kernel-sum on the tensor cores and its epilogues
// ---------------------------------------------------------------------------

// Columns a staged tile holds, J: each tile is summed in its own
// accumulators, which the tensor cores truncate after every product.  64
// where the columns are many (the per-tile drain and sums cost less), 32
// where they are few: the grid support's 380 columns put a row's neighbours
// in one or two tiles, and at 64 that tile's truncation took dq to ~2e-4.
constexpr int kLongJ = 64;
constexpr int kShortJ = 32;
constexpr int kLongJMinCols = 8192;  // columns from which a launch takes kLongJ
// The values of a column j that its table entries are products of.
template <int D>
struct Base {
  static constexpr int kOne = 0;         // 1
  static constexpr int kY = 1;           // y = q_j - c (D)
  static constexpr int kP = 1 + D;       // p_j (D)
  static constexpr int kA = 1 + 2 * D;   // a_j (D), backward
  static constexpr int kB = 1 + 3 * D;   // b_j (D), backward
  static constexpr int kYB = 1 + 4 * D;  // y.b_j
  static constexpr int kYP = 2 + 4 * D;  // y.p_j
  static constexpr int kCount = 3 + 4 * D;
};

// A table entry: the product of three base values (kOne where fewer).
struct Term {
  int f0, f1, f2;
};

// The table's columns in the order of the JAX package's _fwd_col_table (the
// first kFwd) and _bwd_col_table (all kBwd), with names as there: G = a, H =
// b, and q the centred coordinates y.
template <int D>
struct Table {
  using B = Base<D>;
  static constexpr int kPairs = D * (D + 1) / 2;  // (a, b), a <= b
  static constexpr int kFwd = 1 + 2 * D + D * D;
  static constexpr int oG = kFwd;
  static constexpr int oQG = oG + D;
  static constexpr int oHP = oQG + D * D;
  static constexpr int oHQP = oHP + D * D;
  static constexpr int oQHP = oHQP + D;
  static constexpr int oQHQP = oQHP + D * D * D;
  static constexpr int oQQP = oQHQP + D * D;
  static constexpr int oQQ = oQQP + kPairs * D;
  static constexpr int oPQ = oQQ + kPairs;
  static constexpr int oQPQ = oPQ + 1;
  static constexpr int kBwd = oQPQ + D;

  __host__ __device__ static constexpr int pair(int a, int b) {
    return a <= b ? a * D - a * (a - 1) / 2 + (b - a) : pair(b, a);
  }
  __host__ __device__ static constexpr int one() { return 0; }
  __host__ __device__ static constexpr int q(int e) { return 1 + e; }
  __host__ __device__ static constexpr int p(int f) { return 1 + D + f; }
  __host__ __device__ static constexpr int qp(int e, int f) { return 1 + 2 * D + e * D + f; }
  __host__ __device__ static constexpr int G(int f) { return oG + f; }
  __host__ __device__ static constexpr int qG(int e, int f) { return oQG + e * D + f; }
  __host__ __device__ static constexpr int Hp(int e, int f) { return oHP + e * D + f; }
  __host__ __device__ static constexpr int Hqp(int f) { return oHQP + f; }
  __host__ __device__ static constexpr int qHp(int a, int e, int f) {
    return oQHP + a * D * D + e * D + f;
  }
  __host__ __device__ static constexpr int qHqp(int a, int f) { return oQHQP + a * D + f; }
  __host__ __device__ static constexpr int qqp(int a, int b, int f) {
    return oQQP + pair(a, b) * D + f;
  }
  __host__ __device__ static constexpr int qq(int a, int b) { return oQQ + pair(a, b); }
  __host__ __device__ static constexpr int pq() { return oPQ; }
  __host__ __device__ static constexpr int qpq(int a) { return oQPQ + a; }

  __host__ __device__ static constexpr Term term(int c) {
    constexpr int one = B::kOne;
    if (c == 0) return {one, one, one};
    if (c < 1 + D) return {B::kY + c - 1, one, one};
    if (c < 1 + 2 * D) return {B::kP + c - 1 - D, one, one};
    if (c < kFwd) return {B::kY + (c - 1 - 2 * D) / D, B::kP + (c - 1 - 2 * D) % D, one};
    if (c < oQG) return {B::kA + c - oG, one, one};
    if (c < oHP) return {B::kY + (c - oQG) / D, B::kA + (c - oQG) % D, one};
    if (c < oHQP) return {B::kB + (c - oHP) / D, B::kP + (c - oHP) % D, one};
    if (c < oQHP) return {B::kYB, B::kP + c - oHQP, one};
    if (c < oQHQP)
      return {B::kY + (c - oQHP) / (D * D), B::kB + (c - oQHP) / D % D, B::kP + (c - oQHP) % D};
    if (c < oQQP) return {B::kY + (c - oQHQP) / D, B::kYB, B::kP + (c - oQHQP) % D};
    if (c < oPQ) {
      const bool cubic = c < oQQ;
      const int r = cubic ? (c - oQQP) / D : c - oQQ;
      int a = 0;
      while (pair(a, D - 1) < r) ++a;
      const int b = a + r - pair(a, a);
      return {B::kY + a, B::kY + b, cubic ? B::kP + (c - oQQP) % D : one};
    }
    if (c == oPQ) return {B::kYP, one, one};
    return {B::kY + c - oQPQ, B::kYP, one};
  }
};

// the entries the epilogues read are those the producer writes
static_assert(Table<2>::kBwd == 45 && Table<3>::kBwd == 104, "_bwd_col_table widths");
static_assert(Table<2>::term(Table<2>::qqp(0, 1, 1)).f1 == Base<2>::kY + 1 &&
                  Table<2>::term(Table<2>::qq(1, 1)).f0 == Base<2>::kY + 1 &&
                  Table<3>::term(Table<3>::qHp(2, 1, 0)).f0 == Base<3>::kY + 2 &&
                  Table<3>::term(Table<3>::qpq(2)).f1 == Base<3>::kYP,
              "table entries");

// The forward's epilogue of one row from its sums A (the table's columns),
// x = q_i - c, p_i and m_i (the identities of _rhs_self_mm_kernel):
//   v = A[p];  w = u (x sum_e p_e A[p_e] - sum_e p_e A[q p_e]);
//   dc = -u ((p.x) A[1] - sum_e p_e A[q_e])  (0 without logdet)
template <int D>
__host__ __device__ inline void fwd_epilogue(const float* A, const float* x, const float* pi,
                                             float mi, float u, int withlogdet, float* v,
                                             float* w, float* dc) {
  using T = Table<D>;
  float pap = 0.f, px = 0.f, paq = 0.f;
#pragma unroll
  for (int e = 0; e < D; ++e) {
    pap = fmaf(pi[e], A[T::p(e)], pap);
    px = fmaf(pi[e], x[e], px);
    paq = fmaf(pi[e], A[T::q(e)], paq);
  }
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) s = fmaf(pi[e], A[T::qp(dd, e)], s);
    v[dd] = mi * A[T::p(dd)];
    w[dd] = u * mi * fmaf(x[dd], pap, -s);
  }
  *dc = withlogdet ? -u * mi * fmaf(px, A[T::one()], -paq) : 0.f;
}

// The backward's epilogue of one row: dq and dp from its sums A, x = q_l -
// c, p_l, a_l, b_l, m_l and the dcost cotangent cc (0 without logdet), the
// header's VJP with each k-sum expanded in the table's columns (the
// recombination of _rhs_self_bwd_mm_kernel).
template <int D>
__host__ __device__ inline void bwd_epilogue(const float* A, const float* x, const float* pi,
                                             const float* al, const float* bl, float mi,
                                             float u, float cc, float* dq, float* dp) {
  using T = Table<D>;
  // dp_f = A[G_f] + u (sum_e b_e (x_e A[p_f] - A[q_e p_f])
  //                    - sum_e x_e A[H_e p_f] + A[(H.q) p_f])
  //        - u c (x_f A[1] - A[q_f])
#pragma unroll
  for (int f = 0; f < D; ++f) {
    float s = A[T::Hqp(f)];
#pragma unroll
    for (int e = 0; e < D; ++e) {
      s = fmaf(bl[e], fmaf(x[e], A[T::p(f)], -A[T::qp(e, f)]), s);
      s = fmaf(-x[e], A[T::Hp(e, f)], s);
    }
    const float lap = fmaf(x[f], A[T::one()], -A[T::q(f)]);
    dp[f] = mi * fmaf(u, fmaf(-cc, lap, s), A[T::G(f)]);
  }
  // dq = u (T1 + T2 + T3 + T4 + T5 + T6), the k-sums of the terms of -S d +
  // (p.p_j)(b - b_j) - c (p - p_j): T1, T2 of -(a.p_j + a_j.p) d; T3 =
  // -u (T3a - T3b) of -u (p.p_j)((b - b_j).d) d; T4 = u c (T4a - T4b) of
  // u c ((p - p_j).d) d; T5 of (p.p_j)(b - b_j); T6 of -c (p - p_j)
  float xap = 0.f;  // sum_e x_e A[p_e]
#pragma unroll
  for (int e = 0; e < D; ++e) xap = fmaf(x[e], A[T::p(e)], xap);
#pragma unroll
  for (int dd = 0; dd < D; ++dd) {
    const float xd = x[dd];
    float t125 = 0.f, t3a = 0.f, t3b = 0.f, t4a = 0.f;
#pragma unroll
    for (int f = 0; f < D; ++f) {
      // T1: -a_f (x_d A[p_f] - A[q_d p_f]);  T2: -p_f (x_d A[G_f] - A[q_d G_f]);
      // T5: p_f (b_d A[p_f] - A[H_d p_f])
      t125 = fmaf(-al[f], fmaf(xd, A[T::p(f)], -A[T::qp(dd, f)]), t125);
      t125 = fmaf(-pi[f], fmaf(xd, A[T::G(f)], -A[T::qG(dd, f)]), t125);
      t125 = fmaf(pi[f], fmaf(bl[dd], A[T::p(f)], -A[T::Hp(dd, f)]), t125);
      // T3a: p_f sum_e b_e sum_j k p_j,f (x_e - y_e)(x_d - y_d)
      // T3b: p_f sum_j k p_j,f (b_j.(x - y)) (x_d - y_d)
      float sa = 0.f;
      float sb = fmaf(-xd, A[T::Hqp(f)], A[T::qHqp(dd, f)]);
#pragma unroll
      for (int e = 0; e < D; ++e) {
        const float quad = fmaf(x[e], fmaf(xd, A[T::p(f)], -A[T::qp(dd, f)]),
                                fmaf(-xd, A[T::qp(e, f)], A[T::qqp(e, dd, f)]));
        sa = fmaf(bl[e], quad, sa);
        sb = fmaf(x[e], fmaf(xd, A[T::Hp(e, f)], -A[T::qHp(dd, e, f)]), sb);
      }
      t3a = fmaf(pi[f], sa, t3a);
      t3b = fmaf(pi[f], sb, t3b);
      // T4a: p_f sum_j k (x_f - y_f)(x_d - y_d)
      const float quad1 = fmaf(x[f], fmaf(xd, A[T::one()], -A[T::q(dd)]),
                               fmaf(-xd, A[T::q(f)], A[T::qq(f, dd)]));
      t4a = fmaf(pi[f], quad1, t4a);
    }
    // T4b: sum_j k (p_j.(x - y)) (x_d - y_d)
    float t4b = fmaf(xd, xap, fmaf(-xd, A[T::pq()], A[T::qpq(dd)]));
#pragma unroll
    for (int e = 0; e < D; ++e) t4b = fmaf(-x[e], A[T::qp(dd, e)], t4b);
    // T6: -c (p_d A[1] - A[p_d])
    const float t6 = -cc * fmaf(pi[dd], A[T::one()], -A[T::p(dd)]);
    const float t = t125 + t6 + u * (cc * (t4a - t4b) - (t3a - t3b));
    dq[dd] = mi * u * t;
  }
}

template <int D, bool BWD, int G, int J>
struct TabShape {
  static constexpr int kSteps = J / 8;          // k-steps of 8 columns a tile
  static constexpr int kProdGroups = 128 / J;   // producer warps a column
  static constexpr int kC = BWD ? Table<D>::kBwd : Table<D>::kFwd;  // columns
  static constexpr int kNT = (kC + 7) / 8;  // n-tiles of 8 (zero columns past kC)
  static constexpr int kN = 8 * kNT;
  static constexpr int kStages = J == 64 ? (kNT <= 8 ? 3 : 2) : (kNT <= 8 ? 4 : 3);
  // 16-byte words of one k-step of T_hi (or T_lo): NT x 2 core matrices, then
  // padding to 2 (mod 8) words, so that the four k-steps of a tile, like the
  // two core matrices of a k-step in K, fall in different banks
  static constexpr int kKSW =
      kNT * 2 * kCoreWords + ((2 - kNT * 2 * kCoreWords) % 8 + 8) % 8;
  static constexpr int kTabWords = kSteps * kKSW;     // T_hi (or T_lo) of a tile
  static constexpr int kStageWords = J + 2 * kTabWords;  // column records, T_hi, T_lo
  static constexpr int kAStride = kN + 1;  // floats a row of the staged sums
  static constexpr int kRows = 64 * G;
  static constexpr int kThreads = 128 * G + 128;  // and one producer warpgroup
  static constexpr int kSmem = kStages * kStageWords * 16 + kRows * kAStride * 4;
  static constexpr int kMinBlocks = G == 1 && kNT <= 8 ? 2 : 1;
};

struct TabArgs {
  const float* q;      // rows (B, M, D), (B, M)
  const float* p;
  const float* m;
  const float* qc;     // columns (B, N, D), (B, N)
  const float* pc;
  const float* mc;
  const float* a;      // backward: cotangents of v and w (B, M, D), of dcost (B)
  const float* b;
  const float* gc;
  const int* order;    // (B, Mo) rows in spatial order, -1 for a padding slot
  float* o0;           // forward v, w, dc; backward dq, dp
  float* o1;
  float* o2;
  int M, N, Mo;
  float u;
  int withlogdet;
};

// The eta = 0 forward (BWD = false: rows against columns) or the self
// backward (BWD = true: columns = rows, with the cotangents a and b) of one
// block of 64 G slots of the rows' order of one frame, with tiles of J
// columns.  Threads 0 .. 128 G - 1 are the consumer warpgroups, the last 128
// the producer.
template <int D, bool BWD, int G, int J>
__global__ void __launch_bounds__(TabShape<D, BWD, G, J>::kThreads,
                                  TabShape<D, BWD, G, J>::kMinBlocks)
rhs_table_kernel(const TabArgs args) {
  using S = TabShape<D, BWD, G, J>;
  using T = Table<D>;
  using Bs = Base<D>;
  constexpr int N8 = S::kN, ND = N8 / 2, ST = S::kStages, KSW = S::kKSW;
  extern __shared__ __align__(128) uint4 smem[];
  __shared__ uint64_t full[ST], empty[ST];
  __shared__ float red[2 * G][D + 1];
  __shared__ float cen[D];

  const size_t frame = blockIdx.y;
  const int M = args.M, N = args.N, Mo = args.Mo;
  const int* order = args.order + frame * Mo;
  const float* q = args.q + frame * M * D;
  const float* p = args.p + frame * M * D;
  const float* m = args.m + frame * M;
  const int row_base = blockIdx.x * S::kRows;
  const int tid = threadIdx.x;
  // the row of slot r of the order, -1 past its end and for padding
  auto row_of = [&](int r) { return r < Mo ? order[r] : -1; };

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
      const float mi = m[i];
#pragma unroll
      for (int d = 0; d < D; ++d) s[d] = mi * q[(size_t)i * D + d];
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

  const int n_tiles = (N + J - 1) / J;
  if (tid >= 128 * G) {
    // the producer: thread pt builds column jj of each tile, the entries c =
    // grp (mod 128 / J) (grp the same for a whole warp)
    const int pt = tid - 128 * G;
    const int jj = pt & (J - 1);
    const int grp = pt / J;
    const size_t fo = frame * N;
    // a column's values: q, p, m, and a, b backward
    constexpr int NV = BWD ? 4 * D + 1 : 2 * D + 1;
    auto load = [&](int tile, float (&v)[NV]) {
      const int j = tile * J + jj;
      const bool ok = j < N;
      const size_t o = (fo + j) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        v[d] = ok ? args.qc[o + d] : 0.f;
        v[D + d] = ok ? args.pc[o + d] : 0.f;
        if constexpr (BWD) {
          v[2 * D + 1 + d] = ok ? args.a[o + d] : 0.f;
          v[3 * D + 1 + d] = ok ? args.b[o + d] : 0.f;
        }
      }
      v[2 * D] = ok ? args.mc[fo + j] : 0.f;  // m = 0: no contribution
    };
    float c[D];
#pragma unroll
    for (int d = 0; d < D; ++d) c[d] = cen[d];
    const int ks = jj >> 3, kh = (jj >> 2) & 1;
    // float offset of column jj's entry in row 0 of n-tile 0 of a matrix
    const int col_off = (ks * KSW + kh * kCoreWords) * 4 + (jj & 3);
    float cur[NV], nxt[NV];
    load(0, cur);
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int st = tile % ST;
      if (tile + 1 < n_tiles) load(tile + 1, nxt);
      if (tile >= ST) mbar_wait(&empty[st], ((tile / ST) - 1) & 1);
      uint4* sm = smem + st * S::kStageWords;
      float base[Bs::kCount];
      base[Bs::kOne] = 1.f;
      float yb = 0.f, yp = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float y = cur[d] - c[d];
        base[Bs::kY + d] = y;
        base[Bs::kP + d] = cur[D + d];
        yp = fmaf(y, cur[D + d], yp);
        if constexpr (BWD) {
          base[Bs::kA + d] = cur[2 * D + 1 + d];
          base[Bs::kB + d] = cur[3 * D + 1 + d];
          yb = fmaf(y, cur[3 * D + 1 + d], yb);
        }
      }
      base[Bs::kYB] = yb;
      base[Bs::kYP] = yp;
      const float mj = cur[2 * D];
      if (grp == 0)
        reinterpret_cast<float4*>(sm)[jj] = make_float4(cur[0], cur[1], D == 3 ? cur[2] : 0.f, 0.f);
      float* hi = reinterpret_cast<float*>(sm + J) + col_off;
      float* lo = hi + 4 * S::kTabWords;
      static_for<0, S::kC>([&](auto ci) {
        constexpr int cc = decltype(ci)::value;
        if (cc % S::kProdGroups != grp) return;
        constexpr Term tm = T::term(cc);
        const float v = mj * base[tm.f0] * base[tm.f1] * base[tm.f2];
        const uint32_t h = tf32_rna(v);
        constexpr int o = ((cc >> 3) * 2 * kCoreWords + (cc & 7)) * 4;
        hi[o] = __uint_as_float(h);
        lo[o] = __uint_as_float(tf32_rna(v - __uint_as_float(h)));
      });
      // written by the generic proxy, read by wgmma through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(&full[st]);
#pragma unroll
      for (int e = 0; e < NV; ++e) cur[e] = nxt[e];
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
    for (int d = 0; d < D; ++d) xr[h][d] = i >= 0 ? q[(size_t)i * D + d] : 0.f;
  }
  const float c2 = -0.5f * args.u * kLog2e;

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
    const int st = tile % ST;
    mbar_wait(&full[st], (tile / ST) & 1);
    const uint4* sm = smem + st * S::kStageWords;
    const float4* ys = reinterpret_cast<const float4*>(sm);
    const uint32_t bhi = smem_addr(sm + J);
    const uint32_t blo = bhi + S::kTabWords * 16;

#pragma unroll
    for (int ks = 0; ks < S::kSteps; ++ks) {
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
      const uint64_t dhi =
          smem_desc(bhi + ks * KSW * 16, kCoreWords * 16, 2 * kCoreWords * 16);
      const uint64_t dlo =
          smem_desc(blo + ks * KSW * 16, kCoreWords * 16, 2 * kCoreWords * 16);
      wgmma_fence();
      Wgmma<N8>::run(part, alo[buf], dhi, ks > 0);  // k_lo T_hi (a fresh sum at ks = 0)
      Wgmma<N8>::run(part, ahi[buf], dlo, 1);       // k_hi T_lo
      Wgmma<N8>::run(part, ahi[buf], dhi, 1);       // k_hi T_hi
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
    // this warp is done with the stage: its reads of the column records and
    // its share of the products have completed
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] += part[i];
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
  if (ir < 0) return;
  const float* A = abuf + tid * S::kAStride;
  const size_t i = ir;
  float x[D], pi[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    x[d] = q[i * D + d] - cen[d];
    pi[d] = p[i * D + d];
  }
  const size_t o = frame * M * D + i * D;
  if constexpr (!BWD) {
    fwd_epilogue<D>(A, x, pi, m[i], args.u, args.withlogdet, args.o0 + o, args.o1 + o,
                    args.o2 + frame * M + i);
  } else {
    const float cc = args.withlogdet ? args.gc[frame] : 0.f;
    bwd_epilogue<D>(A, x, pi, args.a + o, args.b + o, m[i], args.u, cc, args.o0 + o,
                    args.o1 + o);
  }
}

template <int D, bool BWD, int G, int J>
int launch_table(const TabArgs& args, int B, cudaStream_t s) {
  using S = TabShape<D, BWD, G, J>;
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        rhs_table_kernel<D, BWD, G, J>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  const dim3 grid((args.Mo + S::kRows - 1) / S::kRows, B);
  rhs_table_kernel<D, BWD, G, J><<<grid, S::kThreads, S::kSmem, s>>>(args);
  return (int)cudaGetLastError();
}

template <int D, bool BWD, int G>
int launch_cols(const TabArgs& args, int B, cudaStream_t s) {
  return args.N >= kLongJMinCols ? launch_table<D, BWD, G, kLongJ>(args, B, s)
                                 : launch_table<D, BWD, G, kShortJ>(args, B, s);
}

// A block of `rows` slots of the order (64 G: 256, 128 or 64; at most 128
// for the 104-column table, whose accumulators take twice the registers), as
// ops/rhs_self.py block_rows chooses it and pads the order's runs for it.
template <int D, bool BWD>
int launch_rows(const TabArgs& args, int B, int rows, cudaStream_t s) {
  constexpr int kMaxG = TabShape<D, BWD, 1, kLongJ>::kNT <= 8 ? 4 : 2;
  if (rows == 64) return launch_cols<D, BWD, 1>(args, B, s);
  if (rows == 128) return launch_cols<D, BWD, 2>(args, B, s);
  if constexpr (kMaxG == 4) {
    if (rows == 256) return launch_cols<D, BWD, 4>(args, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_fwd(const void* q, const void* p, const void* m, const void* qc,
               const void* pc, const void* mc, const void* order, int Mo, int rows, void* v,
               void* w, void* dc, void* part, void* ticket, int L, int B, int M, int N,
               int D, float u, int withlogdet, float eta, int use_eta, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || B > 65535 || (D != 2 && D != 3))
    return (int)cudaErrorInvalidValue;
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
  if (use_eta) {
    const DirectArgs a{qf, pf, mf, qcf, pcf, mcf, vf, wf, df, static_cast<float*>(part),
                       static_cast<int*>(ticket), M, N, L, u, eta, withlogdet};
    return D == 2 ? launch_direct<SelfEta<2>>(a, B, rows, s)
                  : launch_direct<SelfEta<3>>(a, B, rows, s);
  }
  if (order == nullptr || Mo < M) return (int)cudaErrorInvalidValue;
  const TabArgs args{qf,      pf,      mf,      qcf, pcf, mcf, nullptr, nullptr,
                     nullptr, static_cast<const int*>(order), vf, wf, df, M, N, Mo, u,
                     withlogdet};
  return D == 2 ? launch_rows<2, false>(args, B, rows, s)
                : launch_rows<3, false>(args, B, rows, s);
}

}  // namespace

extern "C" {

// q, p: (B, M, D) float32; m: (B, M); v, w: (B, M, D); dc: (B, M) per-row
// partials of the divergence cost.  use_eta = 0 runs the eta = 0 table
// kernel: order (B, Mo) int32, each frame's rows in spatial order, each row
// once, -1 in padding slots, taken in blocks of `rows` slots (64, 128 or
// 256).  use_eta != 0 runs the any-eta kernel (at any eta, 0 included), the
// gradcomponent terms of eta with it: `rows` is its block's 64 rows, the
// columns are cut into C = ceil(N / L) chunks of L columns (a multiple of
// 32), and with C > 1 part holds B ceil(M / 64) C 64 (2 D + 1) floats of
// scratch and ticket B ceil(M / 64) int32, all 0 at the call and left 0
// (order, part and ticket may be null where not read).  The rows are their
// own columns.  Returns cudaGetLastError() after launch.
int difficp_rhs_self_fwd_eta(const void* q, const void* p, const void* m, const void* order,
                             int Mo, int rows, void* v, void* w, void* dc, void* part,
                             void* ticket, int L, int B, int M, int D, float u, int withlogdet,
                             float eta, int use_eta, void* stream) {
  return launch_fwd(q, p, m, q, p, m, order, Mo, rows, v, w, dc, part, ticket, L, B, M, M, D,
                    u, withlogdet, eta, use_eta, stream);
}

// The rows (qr, pr, mr: (B, M, D), (B, M); order, rows, part, ticket and L as
// above) against the columns (qc, pc, mc: (B, N, D), (B, N)); outputs as
// difficp_rhs_self_fwd_eta's, one per row.
int difficp_rhs_cross_fwd(const void* qr, const void* pr, const void* mr,
                          const void* qc, const void* pc, const void* mc, const void* order,
                          int Mo, int rows, void* v, void* w, void* dc, void* part,
                          void* ticket, int L, int B, int M, int N, int D, float u,
                          int withlogdet, float eta, int use_eta, void* stream) {
  return launch_fwd(qr, pr, mr, qc, pc, mc, order, Mo, rows, v, w, dc, part, ticket, L, B, M,
                    N, D, u, withlogdet, eta, use_eta, stream);
}

// a, b: cotangents of v and w, (B, M, D); gc: (B,) cotangent of each frame's
// dcost, on the device; order (B, Mo) and rows as above.  Writes dq, dp
// (B, M, D).
int difficp_rhs_self_bwd(const void* q, const void* p, const void* m, const void* a,
                         const void* b, const void* gc, const void* order, int Mo, int rows,
                         void* dq, void* dp, int B, int M, int D, float u, int withlogdet,
                         void* stream) {
  if (B <= 0 || M <= 0 || B > 65535 || (D != 2 && D != 3) || order == nullptr || Mo < M)
    return (int)cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* pf = static_cast<const float*>(p);
  const auto* mf = static_cast<const float*>(m);
  const TabArgs args{qf,
                     pf,
                     mf,
                     qf,
                     pf,
                     mf,
                     static_cast<const float*>(a),
                     static_cast<const float*>(b),
                     static_cast<const float*>(gc),
                     static_cast<const int*>(order),
                     static_cast<float*>(dq),
                     static_cast<float*>(dp),
                     nullptr,
                     M,
                     M,
                     Mo,
                     u,
                     withlogdet};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 2 ? launch_rows<2, true>(args, B, rows, s)
                : launch_rows<3, true>(args, B, rows, s);
}

}  // extern "C"
