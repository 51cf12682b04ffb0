// Negacyclic NTT and inverse NTT of a batch of RNS limbs: kernel K1 of the
// PyTorch/CUDA port (wrapper and plain version: ops/ntt_cuda.py).
//
// Replaces gpufhe_tpu/ops/ntt_pallas.py fourstep_pallas_v3 (reached through
// gpufhe_tpu/ops/ntt.py _fourstep_v3), and computes the same function as that
// file's fourstep_pallas_v2 and fourstep_pallas. Same contract: int32 limb
// indices into FULL per-prime tables, so one build serves every limb
// selection; canonical output in natural order; the inverse has 1/N folded in.
//
// Split. A limb of N = 2^16 residues (512 KB as int64, 256 KB as u32) is
// more than a block's shared memory, so the transform is the four-step split
// N = n1 * n2 (256 x 256), in two passes over device memory:
//   pass A: for each column j2, an n1-point transform over j1 (stride n2),
//           with the psi1^j1 pre-twist and the four-step twiddle
//           psi^(j2 (2 k1 + 1)) folded in;
//   pass B: for each row k1, an n2-point transform over j2, written back in
//           the transposed (natural) order.
// The inverse runs the two passes the other way round with inverse roots.
// The interface is int64; the scratch between the passes is u32.
//
// What bounds it on the H100: each pass reads and writes every limb once,
// so the floor is device-memory bandwidth (24 bytes per residue for the two
// passes with a u32 scratch). The design keeps everything between one read
// and one write in registers or in one conflict-free shared-memory exchange:
//   * Registers. An R-point sub-transform (R = 2^LOGR, 8 to 256) belongs to
//     T = 2^floor(LOGR/2) threads of P = R / T points each (16 x 16 for
//     R = 256). Radix-2 Cooley-Tukey on bit-reversed input: thread i loads
//     t = T brev_P(r) + brev_T(i) into register r, i.e. positions i P + r of
//     the bit-reversed order, so the first log2 P stages are butterflies
//     between its own registers (the bit reversal is in the register index,
//     not a strided store). One exchange through shared memory gives thread
//     j the positions i P + m, m = j + T g, for every i; the last log2 T
//     stages run in registers again and thread j stores outputs i P + m.
//     Two barriers per pass: tables loaded, exchange written.
//   * The exchange tile. Column c, index i, register r live at
//     c COL + i (P + 1) + r with COL = T (P + 1) + 1 (odd). A warp either
//     takes 32 columns at one index (the lane-fast side: loads and stores
//     along the contiguous axis) or T indices of 32 / T columns that lie T
//     apart (the t-fast side of pass B); both hit 32 distinct banks on the
//     write and on the read.
//   * Arithmetic in 32-bit words (every prime below 2^30, so 4q < 2^32).
//     Harvey's lazy butterflies keep values in [0, 4q) and multiply by a
//     table root with its Shoup companion (modarith.cuh mul_shoup_lazy).
//     The twist psi1^j1 is a table constant with its companion. The
//     four-step twiddle psi^e = lo[e mod R] hi[e div R] is formed as
//     mul_mod_shoup32(hi_mont, lo, lo') = lo hi 2^32 mod q from the
//     Montgomery-form hi, and applied with one REDC (mont_mul_lazy), valid
//     because v tw < 4q q < q 2^32. One canonical correction before each
//     store. Every product is a 32-bit one.
// Global access: lanes along the contiguous axis, a warp's 32 lanes one
// segment of 256 bytes (int64) or 128 bytes (u32). On pass B's t-fast side
// (the u32 scratch) a column's T threads take 2T consecutive words of one
// row per access, two each (a uint2), and each trades one word of its pair
// with the thread T/2 away by a warp shuffle: 128 bytes per row segment at
// R = 256 (T = 16), where one word per thread would be 64.
// Not done here: one pass per limb through a cluster's distributed shared
// memory, and 32-bit storage at the interface.
//
// One pass at a time (ntt_pass, the distributed four-step of
// gpufhe_tpu_torch/parallel/sharded.py): a mesh shard holds a block of a
// limb, and the passes run between two all_to_all exchanges. Pass A takes a
// block of columns [n1][width] (row-major, width columns from col0), whose
// twiddle reads the global column col0 + lane; pass B takes a block of rows
// [width][n2] and leaves it row-major, both sides t-fast: the forward
// writes [k1][k2] (the mesh's eval layout), the inverse reads it. The
// int64 side of a t-fast pass reads or writes one word per thread (T
// consecutive words of 8 bytes per row segment); only a u32 side pairs.

#include <type_traits>

#include "modarith.cuh"

// Timing-only variants for the K1 ablation probe (ops/probes.py, the
// counterpart of scripts/ntt_ablate.py), selected at build time. Without
// NTT_ABLATE (the production build) every switch below is off.
//   1 no_modmul      every modular product (butterfly, twist, twiddle) is
//                    one plain 32-bit multiply
//   2 no_twiddle     the twist and twiddle products (and their tables'
//                    loads into shared memory) are skipped
//   3 copy_only      the loads, the exchange through shared memory and the
//                    stores only: no stages, no twist, no twiddle
//   4 natural_store  the exchange tile without padding and the t-fast side
//                    without the column spread: the bank conflicts that the
//                    production layout removes (its output is still the NTT)
//   5 narrow_tfast   the t-fast side one word per thread (T words, 4T
//                    bytes, per row segment) and no shuffle: the segment
//                    width that the pairs double (its output is the NTT)
// The other variants' outputs are wrong by design; copy_only computes two
// bit-reversed transposes (ops/probes.py copy_only_plain).
#ifndef NTT_ABLATE
#define NTT_ABLATE 0
#endif

namespace {

constexpr bool kModmul = NTT_ABLATE != 1;
constexpr bool kTwists = NTT_ABLATE != 2 && NTT_ABLATE != 3;
constexpr bool kStages = NTT_ABLATE != 3;
constexpr bool kPadded = NTT_ABLATE != 4;
constexpr bool kPairs = NTT_ABLATE != 5;
constexpr int kMaxLanes = 32;  // columns per block
constexpr int kMinLogR = 3, kMaxLogR = 8;

// The four passes: forward A and B, inverse B and A; and pass B over a block
// of rows that stays row-major (ntt_pass).
//   kFwdA      in x int64 lane-fast, out scratch u32 lane-fast, twist 1
//   kFwdB      in scratch u32 t-fast, out y int64 lane-fast
//   kInvB      in x int64 lane-fast, out scratch u32 t-fast
//   kInvA      in scratch u32 lane-fast, out y int64 lane-fast, twist 2
//   kFwdBRows  in u32 t-fast, out int64 t-fast
//   kInvBRows  in int64 t-fast, out u32 t-fast
// Twist 1: psi1^t pre-twist on load, four-step twiddle on store; twist 2:
// the twiddle on load, psi1^-t / N on store. Lane-fast: element (t, lane)
// at t * stride + lane; t-fast: at t + lane * stride.
enum Kind { kFwdA, kFwdB, kInvB, kInvA, kFwdBRows, kInvBRows };

template <int LOGR>
struct Geometry {
  static constexpr int R = 1 << LOGR;
  static constexpr int LOGT = LOGR / 2, LOGP = LOGR - LOGT;
  static constexpr int T = 1 << LOGT, P = 1 << LOGP;
  static constexpr int ROW = kPadded ? P + 1 : P;        // tile stride of index i
  static constexpr int COL = kPadded ? T * ROW + 1 : R;  // tile stride of a column
};

struct Pass {
  const void* in;
  void* out;
  const int* idx;  // chain row of data row r is idx[r % L]
  int L;
  int n;          // limb length N (the twiddle's exponents are mod 2N)
  int blk;        // the row stride of in/out: n, or the block's size
  int col0;       // global column of the first lane of pass A (0 for a whole limb)
  int lanes;      // columns per block (a power of two, at most kMaxLanes)
  int log_lanes;
  int in_st, out_st;  // the strided axis of each side (see Kind)
  int tstride;        // row length of roots, t1d, lo tables (n1)
  int nhi;            // row length of hi_mont (2 n / n1)
  // the tables (ops/context.py K1Tables), u32 like every value the kernel computes
  const unsigned* q;
  const unsigned* qinv_neg;
  const unsigned* roots;  // stage-ordered: roots[2^s + k] for butterfly k of stage s
  const unsigned* roots_shoup;
  const unsigned* t1d;
  const unsigned* t1d_shoup;
  const unsigned* lo;
  const unsigned* lo_shoup;
  const unsigned* hi_mont;
};

__host__ __device__ constexpr int brev(int x, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((x >> b) & 1) << (bits - 1 - b);
  return r;
}

// Harvey's lazy Cooley-Tukey butterfly: x, y in [0, 4q) -> x + w y and
// x - w y, both in [0, 4q); w y up to one q by Shoup's product.
__device__ __forceinline__ void bfly(unsigned& x, unsigned& y, unsigned w, unsigned wp,
                                     unsigned q) {
  const unsigned q2 = 2 * q;
  const unsigned a = x >= q2 ? x - q2 : x;
  const unsigned t = kModmul ? mul_shoup_lazy(y, w, wp, q) : y * w;
  x = a + t;
  y = a - t + q2;
}

// the same with w = 1
__device__ __forceinline__ void bfly1(unsigned& x, unsigned& y, unsigned q) {
  const unsigned q2 = 2 * q;
  const unsigned a = x >= q2 ? x - q2 : x;
  const unsigned t = y >= q2 ? y - q2 : y;
  x = a + t;
  y = a - t + q2;
}

// The pairs of the t-fast side: thread s of a column's T (s < T/2 "low",
// else "high") handles the residue class m = 2 (s mod T/2) + [s high] of
// t mod T, and trades with thread s ^ T/2, whose class is m ^ 1.
template <int LOGT>
__device__ __forceinline__ int pair_class(int s) {
  constexpr int h = 1 << (LOGT - 1);
  return 2 * (s & (h - 1)) + (s >= h);
}

// Thread tid's column c and index i. Lane-fast: consecutive threads take
// consecutive columns at one index. Index-fast: T consecutive threads take
// the T indices of one column, and thread group g takes column
// (g mod (lanes / T)) T + g div (lanes / T), so a warp's 32 / T columns lie
// T apart and, with the tile's odd column stride, on distinct banks. With
// the pairs, the index of thread s of a group is brev_T(pair_class(s)) on
// the input side (its inputs are t = u T + pair_class(s)) and
// pair_class(s) on the output side (its outputs are k = m mod T of that
// class): a permutation within the group, so the tile's banks stay distinct.
template <bool INDEX_FAST, bool OUT, bool PAIRS, int LOGT>
__device__ __forceinline__ void split(int tid, int lanes, int log_lanes, int& c, int& i) {
  if (!INDEX_FAST) {
    c = tid & (lanes - 1);
    i = tid >> log_lanes;
    return;
  }
  i = tid & ((1 << LOGT) - 1);
  if (PAIRS) i = OUT ? pair_class<LOGT>(i) : brev(pair_class<LOGT>(i), LOGT);
  const int g = tid >> LOGT;
  if (!kPadded) {
    c = g;
    return;
  }
  const int log_per = log_lanes - LOGT;
  c = ((g & ((1 << log_per) - 1)) << LOGT) + (g >> log_per);
}

template <int LOGR, int KIND>
__global__ void __launch_bounds__(kMaxLanes << (LOGR / 2)) k1_pass(const Pass p) {
  using G = Geometry<LOGR>;
  constexpr int R = G::R, LOGT = G::LOGT, LOGP = G::LOGP, T = G::T, P = G::P;
  constexpr bool ROWS = KIND == kFwdBRows || KIND == kInvBRows;
  constexpr bool IN_TFAST = KIND == kFwdB || ROWS;
  constexpr bool OUT_TFAST = KIND == kInvB || ROWS;
  constexpr int TWIST = !kTwists ? 0 : KIND == kFwdA ? 1 : KIND == kInvA ? 2 : 0;
  using InT = typename std::conditional<KIND == kFwdA || KIND == kInvB || KIND == kInvBRows,
                                        i64, unsigned>::type;
  using OutT = typename std::conditional<KIND == kFwdB || KIND == kInvA || KIND == kFwdBRows,
                                         i64, unsigned>::type;
  // a t-fast side pairs its words only where they are u32
  constexpr bool IN_PAIRS = IN_TFAST && kPairs && sizeof(InT) == 4;
  constexpr bool OUT_PAIRS = OUT_TFAST && kPairs && sizeof(OutT) == 4;

  extern __shared__ unsigned smem[];
  unsigned* tile = smem;                // [lanes][COL]
  unsigned* rw = tile + p.lanes * G::COL;  // [R] stage-ordered roots
  unsigned* rwp = rw + R;               // [R] their Shoup companions
  unsigned* t1d = rwp + R;              // [R] psi1^+-t (twist only)
  unsigned* t1dp = t1d + R;
  unsigned* lo = t1dp + R;              // [R] psi^+-e, e < R
  unsigned* lop = lo + R;
  unsigned* him = lop + R;              // [2n/R] psi^+-(R e) 2^32 mod q

  const int tid = threadIdx.x;
  const int nthr = p.lanes << LOGT;
  const int row = blockIdx.y;
  const int chain = p.idx[row % p.L];
  const unsigned q = p.q[chain];
  const unsigned qinv = p.qinv_neg[chain];
  const i64 rowoff = (i64)row * p.blk;
  const int lane0 = blockIdx.x * p.lanes;
  const unsigned emask = 2u * p.n - 1u;
  int c_in, i_in, c_out, j_out;
  split<IN_TFAST, false, IN_PAIRS, LOGT>(tid, p.lanes, p.log_lanes, c_in, i_in);
  split<OUT_TFAST, true, OUT_PAIRS, LOGT>(tid, p.lanes, p.log_lanes, c_out, j_out);
  // the pairs' partner is lane ^ T/2 of the same warp; a block of fewer than
  // 32 threads (N = 2^6) is one partial warp
  const unsigned warp_mask = nthr >= 32 ? 0xffffffffu : (1u << nthr) - 1u;
  const bool high = (tid & ((1 << LOGT) - 1)) >= T / 2;

  // 1. register r <- input t = T brev_P(r) + brev_T(i): position i P + r of
  //    the bit-reversed order
  const InT* in = static_cast<const InT*>(p.in);
  const i64 lane_in = lane0 + c_in;
  const int ib = (int)(__brev((unsigned)i_in) >> (32 - LOGT));
  unsigned v[P];
  if constexpr (IN_PAIRS) {
    // words 2 T w + 2 s and + 1 of the row (s: index in the group), i.e.
    // t = (2 w + [s high]) T + 2 (s mod T/2) + {0, 1}; the low thread keeps
    // its even class and sends the odd word, the high thread the reverse
    const uint2* row2 = reinterpret_cast<const uint2*>(in + rowoff + lane_in * p.in_st);
    const int s = tid & (T - 1);
#pragma unroll
    for (int w = 0; w < P / 2; ++w) {
      const uint2 a = row2[w * T + s];
      const unsigned got = __shfl_xor_sync(warp_mask, high ? a.x : a.y, T / 2);
      v[brev(2 * w, LOGP)] = high ? got : a.x;
      v[brev(2 * w + 1, LOGP)] = high ? a.y : got;
    }
  } else {
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const i64 t = u * T + ib;
      v[brev(u, LOGP)] = (unsigned)in[rowoff + (IN_TFAST ? t + lane_in * p.in_st
                                                         : t * p.in_st + lane_in)];
    }
  }
  const i64 trow = (i64)chain * p.tstride;
  for (int e = tid; e < R; e += nthr) {
    rw[e] = p.roots[trow + e];
    rwp[e] = p.roots_shoup[trow + e];
    if (TWIST) {
      t1d[e] = p.t1d[trow + e];
      t1dp[e] = p.t1d_shoup[trow + e];
      lo[e] = p.lo[trow + e];
      lop[e] = p.lo_shoup[trow + e];
    }
  }
  if (TWIST)
    for (int e = tid; e < p.nhi; e += nthr) him[e] = p.hi_mont[(i64)chain * p.nhi + e];
  __syncthreads();

  // psi^+-e 2^32 mod q for e = lane (2 t + 1) mod 2N: the four-step twiddle
  // at (k1 = t, j2 = lane) in Montgomery form, canonical
  auto twiddle = [&](unsigned t, unsigned lane) -> unsigned {
    const unsigned e = (lane * (2u * t + 1u)) & emask;
    const unsigned k = e & (R - 1);
    return kModmul ? mul_mod_shoup32(him[e >> LOGR], lo[k], lop[k], q) : him[e >> LOGR] * lo[k];
  };

  // 2. twist on load: v < q, result in [0, 2q)
  if (TWIST) {
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int t = u * T + ib;
      unsigned& x = v[brev(u, LOGP)];
      if (TWIST == 1)
        x = kModmul ? mul_shoup_lazy(x, t1d[t], t1dp[t], q) : x * t1d[t];
      else
        x = kModmul ? mont_mul_lazy(x, twiddle(t, (unsigned)(lane_in + p.col0)), q, qinv)
                    : x * twiddle(t, (unsigned)(lane_in + p.col0));
    }
  }

  // 3. stages 0 .. LOGP-1 between this thread's registers
  if (kStages) {
#pragma unroll
    for (int s = 0; s < LOGP; ++s) {
#pragma unroll
      for (int r = 0; r < P; ++r) {
        if ((r >> s) & 1) continue;
        const int k = r & ((1 << s) - 1);
        if (k == 0)
          bfly1(v[r], v[r + (1 << s)], q);
        else
          bfly(v[r], v[r + (1 << s)], rw[(1 << s) + k], rwp[(1 << s) + k], q);
      }
    }
  }

  // 4. the exchange: position i P + r of column c to c COL + i ROW + r;
  //    thread (c_out, j_out) then holds positions i P + m, m = j_out + T g
#pragma unroll
  for (int r = 0; r < P; ++r) tile[c_in * G::COL + i_in * G::ROW + r] = v[r];
  __syncthreads();
#pragma unroll
  for (int g = 0; g < P / T; ++g) {
#pragma unroll
    for (int i = 0; i < T; ++i) v[g * T + i] = tile[c_out * G::COL + i * G::ROW + j_out + T * g];
  }

  // 5. stages LOGP .. LOGR-1: butterfly k = m + P (i mod 2^s) of stage LOGP + s
  if (kStages) {
#pragma unroll
    for (int g = 0; g < P / T; ++g) {
      const int m = j_out + T * g;
#pragma unroll
      for (int s = 0; s < LOGT; ++s) {
#pragma unroll
        for (int i = 0; i < T; ++i) {
          if ((i >> s) & 1) continue;
          const int e = (1 << (LOGP + s)) + m + P * (i & ((1 << s) - 1));
          bfly(v[g * T + i], v[g * T + i + (1 << s)], rw[e], rwp[e], q);
        }
      }
    }
  }

  // 6. twist on store, one canonical correction, output k = i P + m
  OutT* out = static_cast<OutT*>(p.out);
  const i64 lane_out = lane0 + c_out;
  auto finish = [&](unsigned x, int k) -> unsigned {
    if (TWIST == 1) {  // x < 4q, twiddle < q: x tw < q 2^32
      x = kModmul ? mont_mul_lazy(x, twiddle(k, (unsigned)(lane_out + p.col0)), q, qinv)
                  : x * twiddle(k, (unsigned)(lane_out + p.col0));
    } else if (TWIST == 2) {
      x = kModmul ? mul_shoup_lazy(x, t1d[k], t1dp[k], q) : x * t1d[k];
    } else {
      x = x >= 2 * q ? x - 2 * q : x;
    }
    return x >= q ? x - q : x;
  };
  if constexpr (OUT_PAIRS) {
    // output k = d T + j_out holds register (d mod (P / T)) T + d div (P / T);
    // thread s writes words 2 T w + 2 s and + 1, i.e. classes 2 (s mod T/2)
    // and + 1 at d = 2 w + [s high]: the low thread sends its d = 2 w + 1,
    // the high thread its d = 2 w
    constexpr int PT = P / T;
    uint2* row2 = reinterpret_cast<uint2*>(out + rowoff + lane_out * p.out_st);
    const int s = tid & (T - 1);
#pragma unroll
    for (int w = 0; w < P / 2; ++w) {
      const int d0 = 2 * w, d1 = 2 * w + 1;
      const unsigned even = finish(v[(d0 % PT) * T + d0 / PT], d0 * T + j_out);
      const unsigned odd = finish(v[(d1 % PT) * T + d1 / PT], d1 * T + j_out);
      const unsigned got = __shfl_xor_sync(warp_mask, high ? even : odd, T / 2);
      row2[w * T + s] = high ? make_uint2(got, odd) : make_uint2(even, got);
    }
  } else {
#pragma unroll
    for (int g = 0; g < P / T; ++g) {
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int k = i * P + j_out + T * g;
        out[rowoff + (OUT_TFAST ? k + lane_out * p.out_st : (i64)k * p.out_st + lane_out)] =
            (OutT)finish(v[g * T + i], k);
      }
    }
  }
}

int ilog2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

template <int LOGR, int KIND>
int launch_pass(const Pass& p, int lanes, int rows, cudaStream_t stream) {
  using G = Geometry<LOGR>;
  constexpr bool twist = KIND == kFwdA || KIND == kInvA;
  // a t-fast side spreads a block's lanes over groups of T threads; pass A's
  // lanes may be fewer than T (a narrow block of columns)
  constexpr bool tfast = KIND != kFwdA && KIND != kInvA;
  if ((tfast && p.lanes < G::T) || lanes % p.lanes) return (int)cudaErrorInvalidValue;
  const size_t words = (size_t)p.lanes * G::COL + 2 * G::R + (twist ? 4 * G::R + p.nhi : 0);
  const size_t smem = words * sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k1_pass<LOGR, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  k1_pass<LOGR, KIND><<<dim3(lanes / p.lanes, rows), p.lanes * G::T, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int KIND, int LOGR = kMinLogR>
int launch(int logR, const Pass& p, int lanes, int rows, cudaStream_t stream) {
  if (logR == LOGR) return launch_pass<LOGR, KIND>(p, lanes, rows, stream);
  if constexpr (LOGR < kMaxLogR) return launch<KIND, LOGR + 1>(logR, p, lanes, rows, stream);
  return (int)cudaErrorInvalidValue;  // no instantiation for this transform length
}

}  // namespace

extern "C" const char* ntt_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x, y: int64[rows, n] with rows = batch * L, canonical residues below primes
// q < 2^30; scratch: u32[rows, n]. idx: int32[L] rows of the full tables.
// The tables, u32, per direction (ops/context.py K1Tables, in this order):
// q and qinv_neg (-q^-1 mod 2^32) per chain row; roots, roots_shoup, t1d,
// t1d_shoup, lo and lo_shoup [chain, n1]; hi_mont [chain, 2 n2]. n1 and n2
// from 8 to 256.
extern "C" int ntt_fourstep(const i64* x, i64* y, unsigned* scratch, const int* idx, int L,
                            int rows, int n, int n1, int n2, int inverse, const unsigned* q,
                            const unsigned* qinv_neg, const unsigned* roots,
                            const unsigned* roots_shoup, const unsigned* t1d,
                            const unsigned* t1d_shoup, const unsigned* lo,
                            const unsigned* lo_shoup, const unsigned* hi_mont, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int log1 = ilog2(n1), log2 = ilog2(n2);
  if ((1 << log1) != n1 || (1 << log2) != n2 || n1 * n2 != n || L <= 0 || rows % L)
    return (int)cudaErrorInvalidValue;
  Pass base = {};
  base.idx = idx;
  base.L = L;
  base.n = n;
  base.blk = n;
  base.tstride = n1;
  base.nhi = 2 * n2;
  base.q = q;
  base.qinv_neg = qinv_neg;
  base.roots = roots;
  base.roots_shoup = roots_shoup;
  base.t1d = t1d;
  base.t1d_shoup = t1d_shoup;
  base.lo = lo;
  base.lo_shoup = lo_shoup;
  base.hi_mont = hi_mont;
  Pass a = base;  // pass A: n2 columns j2, transform over j1 (stride n2)
  a.lanes = n2 < kMaxLanes ? n2 : kMaxLanes;
  a.log_lanes = ilog2(a.lanes);
  a.in_st = a.out_st = n2;
  Pass b = base;  // pass B: n1 rows k1, transform over j2
  b.lanes = n1 < kMaxLanes ? n1 : kMaxLanes;
  b.log_lanes = ilog2(b.lanes);
  if (!inverse) {
    a.in = x;
    a.out = scratch;  // [k1, j2]
    int err = launch<kFwdA>(log1, a, n2, rows, s);
    if (err) return err;
    b.in = scratch;  // row k1, t = j2
    b.in_st = n2;
    b.out = y;       // X[k2 * n1 + k1]
    b.out_st = n1;
    return launch<kFwdB>(log2, b, n1, rows, s);
  }
  // inverse: X[k2 * n1 + k1] -> scratch [k1, j2], then the twiddle out on
  // load, the transform over k1 and psi1^-j1 / N on store
  b.in = x;
  b.in_st = n1;
  b.out = scratch;
  b.out_st = n2;
  int err = launch<kInvB>(log2, b, n1, rows, s);
  if (err) return err;
  a.in = scratch;
  a.out = y;
  return launch<kInvA>(log1, a, n2, rows, s);
}

#if NTT_ABLATE == 0
// One pass over one block of every row (the distributed four-step: see the
// head of this file). kind 0 forward A, 1 forward B, 2 inverse B, 3 inverse
// A. Passes A: x, y [rows][n1][width], columns col0 .. col0 + width - 1 of
// the [n1][n2] limb matrix; x int64 and y u32 forward, the reverse
// inverse. Passes B: x, y [rows][width][n2], a block of rows, row-major;
// forward u32 -> int64, inverse int64 -> u32. Tables as ntt_fourstep's.
extern "C" int ntt_pass(const void* x, void* y, const int* idx, int L, int rows, int n, int n1,
                        int n2, int kind, int width, int col0, const unsigned* q,
                        const unsigned* qinv_neg, const unsigned* roots,
                        const unsigned* roots_shoup, const unsigned* t1d,
                        const unsigned* t1d_shoup, const unsigned* lo, const unsigned* lo_shoup,
                        const unsigned* hi_mont, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int log1 = ilog2(n1), log2 = ilog2(n2), logw = ilog2(width);
  const bool pass_a = kind == 0 || kind == 3;
  const int span = pass_a ? n2 : n1;  // the axis the block cuts
  if ((1 << log1) != n1 || (1 << log2) != n2 || n1 * n2 != n || L <= 0 || rows % L ||
      kind < 0 || kind > 3 || (1 << logw) != width || width > span || col0 < 0 ||
      col0 % width || col0 + width > span || (!pass_a && col0))
    return (int)cudaErrorInvalidValue;
  Pass p = {};
  p.in = x;
  p.out = y;
  p.idx = idx;
  p.L = L;
  p.n = n;
  p.col0 = col0;
  p.tstride = n1;
  p.nhi = 2 * n2;
  p.q = q;
  p.qinv_neg = qinv_neg;
  p.roots = roots;
  p.roots_shoup = roots_shoup;
  p.t1d = t1d;
  p.t1d_shoup = t1d_shoup;
  p.lo = lo;
  p.lo_shoup = lo_shoup;
  p.hi_mont = hi_mont;
  p.lanes = width < kMaxLanes ? width : kMaxLanes;
  p.log_lanes = ilog2(p.lanes);
  if (pass_a) {  // lanes: the block's columns, transform over j1 (or k1)
    p.blk = n1 * width;
    p.in_st = p.out_st = width;
    return kind == 0 ? launch<kFwdA>(log1, p, width, rows, s)
                     : launch<kInvA>(log1, p, width, rows, s);
  }
  p.blk = width * n2;  // lanes: the block's rows, transform along each row
  p.in_st = p.out_st = n2;
  return kind == 1 ? launch<kFwdBRows>(log2, p, width, rows, s)
                   : launch<kInvBRows>(log2, p, width, rows, s);
}
#endif
