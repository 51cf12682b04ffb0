// Rescale and BGV ModSwitch: drop the last `words` limbs of RNS residues in
// one pass (wrapper: ops/rescale_cuda.py; plain versions: primitives/rns.py
// _rescale_plain and _modswitch_plain, one limb a call).
//
// Replaces no Pallas kernel: the reference (gpufhe_tpu/primitives/rns.py
// rescale, bgv_modswitch) leaves the rescale to XLA's fusion of its
// elementwise ops, and the port ran it as about 13 int64 PyTorch passes a
// dropped limb. For x: int64[B, K, n] canonical coefficient residues (batch
// and limb strides given, coefficient stride 1), out: int64[B, K - words, n],
// drop d = 0 .. words - 1 divides by q_l = q_{K-1-d} the value that the drops
// before it left:
//   CKKS: v_i <- (v_i - c(v_l)) * q_l^-1                       mod q_i
//   BGV:  u = v_l [-t^-1]_{q_l} mod q_l;  v_i <- (v_i + t c(u)) * q_l^-1  mod q_i
// with the centred lift c(r) = r - q_l for r > floor(q_l / 2), else r, the
// rule of the plain versions. Equal, limb for limb, to `words` calls of them.
//
// What bounds it on the H100: bytes. Each residue of the K input limbs is
// read once and each of the K - words outputs written once, 8 B each
// (int64), against one or two 32-bit Shoup products a word of output.
// Design: a thread owns one coefficient column of one batch row,
// neighbouring threads on neighbouring columns (coalesced 8-byte accesses;
// two columns a thread with 16-byte accesses measured slower on the H100,
// with half the threads in flight). It loads the dropped residues first,
// derives each drop's last value in registers, then walks the remaining
// limbs once, four limbs' loads unrolled ahead of their products. The lifted
// difference needs no reduction: with m_i the least multiple of q_i at or
// above 2^30 (> any residue of a prime below 2^30),
//   CKKS: a = v_i + m_i - v_l + [v_l lifts] (q_l mod q_i)      in (0, 2^32)
//   BGV:  a = v_i + [(u + m_i - [u lifts] (q_l mod q_i)) t]_{q_i}   below 2 q_i
// and one Shoup product by q_l^-1 (modarith.cuh mul_mod_shoup32, which takes
// any a below 2^32) leaves it canonical. The per-limb constants come from the
// host (primitives/rns.py make_ks_context, ops/rescale_cuda.py
// make_drop_table), one table a dropped limb.

#include "modarith.cuh"

namespace {

constexpr int kThreads = 256;
// a drop's table: kHeader words, then kRows rows of `rows` words (rows =
// the limbs left after the drop), u32 values
constexpr int kHeader = 4;  // q_l, [-t^-1]_{q_l}, its Shoup companion, unused
enum Row { kQ, kQlMod, kQlInv, kQlInvShoup, kM, kT, kTShoup, kRows };

struct Drop {
  const unsigned* tab;
  int rows;
};

// The drop's lifted value and whether it lifts, from the residue v_l of its
// last limb: v_l itself (CKKS) or u = v_l [-t^-1]_{q_l} mod q_l (BGV).
template <bool kBgv>
__device__ __forceinline__ void drop_value(const Drop& d, unsigned v_l, unsigned& c, bool& lifts) {
  const unsigned ql = __ldg(d.tab);
  c = kBgv ? mul_mod_shoup32(v_l, __ldg(d.tab + 1), __ldg(d.tab + 2), ql) : v_l;
  lifts = c > ql / 2;
}

// One drop applied to residue v of limb i (canonical in, canonical out).
template <bool kBgv>
__device__ __forceinline__ unsigned drop_limb(const Drop& d, int i, unsigned v, unsigned c,
                                              bool lifts) {
  const unsigned* r = d.tab + kHeader + i;
  const unsigned q = __ldg(r + kQ * d.rows);
  const unsigned m = __ldg(r + kM * d.rows);
  const unsigned qlmod = lifts ? __ldg(r + kQlMod * d.rows) : 0u;
  const unsigned a = kBgv ? v + mul_mod_shoup32(c + m - qlmod, __ldg(r + kT * d.rows),
                                                __ldg(r + kTShoup * d.rows), q)
                          : v + m - c + qlmod;
  return mul_mod_shoup32(a, __ldg(r + kQlInv * d.rows), __ldg(r + kQlInvShoup * d.rows), q);
}

template <int kWords, bool kBgv>
__global__ void __launch_bounds__(kThreads)
rescale_kernel(const i64* __restrict__ x, i64* __restrict__ out, int K, int n, i64 x_bstride,
               i64 x_kstride, const unsigned* __restrict__ tab0,
               const unsigned* __restrict__ tab1) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= n) return;
  const i64* xb = x + blockIdx.y * x_bstride + col;
  const int kout = K - kWords;
  i64* ob = out + (i64)blockIdx.y * kout * n + col;
  const Drop drops[2] = {{tab0, K - 1}, {tab1, K - 2}};

  // the dropped limbs, last first: limb K-1-d passes through drops 0 .. d-1
  // before it is drop d's last value
  unsigned c[kWords];
  bool lifts[kWords];
#pragma unroll
  for (int d = 0; d < kWords; ++d) {
    unsigned v = (unsigned)xb[(K - 1 - d) * x_kstride];
#pragma unroll
    for (int e = 0; e < d; ++e) v = drop_limb<kBgv>(drops[e], K - 1 - d, v, c[e], lifts[e]);
    drop_value<kBgv>(drops[d], v, c[d], lifts[d]);
  }

#pragma unroll 4
  for (int i = 0; i < kout; ++i) {
    unsigned v = (unsigned)xb[i * x_kstride];
#pragma unroll
    for (int d = 0; d < kWords; ++d) v = drop_limb<kBgv>(drops[d], i, v, c[d], lifts[d]);
    ob[(i64)i * n] = v;
  }
}

}  // namespace

extern "C" const char* rescale_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x: int64[B, >= K, n] with batch stride x_bstride and limb stride x_kstride
// (in elements), coefficient stride 1; out: int64[B, K - words, n]
// contiguous. tab0: the table of dropping limb K-1 from K limbs; tab1 (words
// = 2, else null): of dropping limb K-2 from K-1. bgv selects the
// t-corrected ModSwitch.
extern "C" int rescale_launch(const i64* x, i64* out, int B, int K, int n, long long x_bstride,
                              long long x_kstride, int words, int bgv, const unsigned* tab0,
                              const unsigned* tab1, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || words < 1 || words > 2 || K <= words ||
      (words == 2 && !tab1))
    return (int)cudaErrorInvalidValue;
  const auto kernel = words == 1 ? (bgv ? rescale_kernel<1, true> : rescale_kernel<1, false>)
                                 : (bgv ? rescale_kernel<2, true> : rescale_kernel<2, false>);
  const dim3 grid((n + kThreads - 1) / kThreads, B);
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, out, K, n, x_bstride, x_kstride, tab0,
                                                      tab1);
  return (int)cudaGetLastError();
}
