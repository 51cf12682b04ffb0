// RNS approximate base conversion: kernel K3 of the PyTorch/CUDA port
// (wrapper, tables and plain version: ops/convert_cuda.py).
//
// Replaces gpufhe_tpu/ops/convert_pallas.py digit_convert (kernel
// _convert_kernel, tables make_digit_convert). Same function:
//   v_i   = x_i * [Qhat_i^-1]_{q_i}  mod q_i            (i < S)
//   out_t = sum_i v_i * conv[t, i]    mod p_t, canonical (t < T)
// with conv a device table, so a caller can fold extra factors into it (the
// BGV t-corrected ModDown does). The result is the unique canonical residue,
// so it equals the reference's per-term-reduced Shoup formulation
// (gpufhe_tpu/primitives/rns.py _base_convert_shoup) bit for bit.
//
// What bounds it on the H100: bytes. Each source word is read once and each
// output word written once (8 N (S + T) bytes at int64), against S modular
// products and S T multiply-adds per coefficient, which at the card's
// integer rates take less time than the traffic. The design:
// - v_i is formed once per coefficient and source limb, in 32 bits: a Shoup
//   product (modarith.cuh mul_mod_shoup32) against qhinv_shoup[i] =
//   floor(qhinv_i 2^32 / q_i). A thread loads its coefficients' S source
//   words once (coalesced along c) and keeps v in registers: the kernel is
//   instantiated for S rounded up to 4, 8, ..., 32 (zero-padded limbs add
//   nothing). Above 32 source limbs the thread walks them in chunks of 32
//   and carries each destination's canonical partial sum through `out`.
// - Each destination is a sum of 32 x 32 -> 64-bit products (below 2^60
//   for primes below 2^30), 16 of them and one carried residue below 2^64,
//   reduced by one Barrett step (barrett_reduce, exact for any 64-bit
//   input) per 16 terms and once at the end: no modular product per term.
// - The conversion rows of the block's destinations are staged once in
//   shared memory, zero-padded to the chunk width, and read as 128-bit
//   broadcasts (every lane reads the same four words); the per-limb
//   constants are uniform loads.
// - Enough warps in flight: a block covers kThreads * cpt coefficients (a
//   thread owns cpt of them, kThreads apart, so loads and stores stay
//   coalesced) and one group of `tg` destinations; the grid is
//   (ceil(N / (kThreads cpt)), ceil(T / tg)). Each group forms v again (S
//   more Shoup products per coefficient) and reads the source again, mostly
//   from L2. The wrapper's defaults for tg and cpt come from a sweep on the
//   card (PERF.md), ModDown's from its own. Stores of out[t, c] are int64
//   and coalesced along c.
// - A batch of B inputs (grid z) shares the tables: the key switch's two
//   accumulators are one launch.
// The TPU kernel's int8 digit matmuls on the matrix unit have no
// counterpart: Hopper multiplies 32-bit words to 64 bits directly.
//
// ModDown (the kDown instances) is the same conversion, of the P rows of
// the key switch's coefficient-domain accumulators acc[b] into their Q
// rows, with an epilogue: for destination limb t
//   out[b, t, c] = (acc[b, t, c] - conv_t(c)) [P^-1]_{q_t} + add[b, t, c]  mod q_t
// (the addend only for b < b_add; t-folded tables give BGV's ModDown). The
// addend enters as the start of the first chunk's sum, add [-P]_{q_t} (one
// Shoup product): the sum then reduces to conv_t - add P, and one Shoup
// product by [P^-1]_{q_t} of acc - sum + q_t (below 2^31) leaves the result
// canonical, equal to ModDown and the addition done apart. A thread reads
// add[b, t, c] before it first writes out[b, t, c] and no other thread
// touches either, so out may be the addend's own buffer, chunked or not.
// The Q-row residue is loaded beside the addend, before the row's products,
// so that the two loads are in flight together.

#include "modarith.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnreduced = 16;  // products summed before a Barrett step
constexpr int kMaxGroups = 65535;  // grid y and z
constexpr int kDefaultSmem = 48 * 1024;  // static limit without an opt-in

// ModDown's epilogue operands (see the header)
struct Down {
  const i64* acc;  // the Q rows of batch 0; batch stride that of x
  const i64* add;  // [b_add, T, n], batch stride add_bstride; may be out
  long long add_bstride;
  int b_add;
  const unsigned* tab;  // [4][T]: [P^-1]_{q_t}, its Shoup companion, [-P]_{q_t}, its companion
};

// Source limbs i0 .. i0 + 4 S4 (a chunk) for cpt coefficients per thread,
// destinations t0 .. t0 + rows of this block, batch row blockIdx.z. conv_s
// holds the rows of conv for these destinations, `stride` words each (a
// multiple of 4 S4, zero past S).
template <int S4, int CPT, bool kDown>
__global__ void __launch_bounds__(kThreads)
base_convert_kernel(const i64* __restrict__ x, i64* out, int S, int T, int n, int tg,
                    int stride, long long x_bstride, long long out_bstride, Down down,
                    const unsigned* __restrict__ sq, const unsigned* __restrict__ qhinv,
                    const unsigned* __restrict__ qhinv_shoup,
                    const unsigned* __restrict__ conv, const unsigned* __restrict__ dq,
                    const u64* __restrict__ dmu) {
  constexpr int W = 4 * S4;
  extern __shared__ uint4 smem[];
  unsigned* conv_s = reinterpret_cast<unsigned*>(smem);
  const int b = blockIdx.z;
  x += b * x_bstride;
  out += b * out_bstride;
  const i64* acc_q = kDown ? down.acc + b * x_bstride : nullptr;
  const i64* add = kDown && b < down.b_add ? down.add + b * down.add_bstride : nullptr;
  const int t0 = blockIdx.y * tg;
  const int rows = min(tg, T - t0);
  for (int k = threadIdx.x; k < rows * stride; k += kThreads) {
    const int r = k / stride, i = k - r * stride;
    conv_s[k] = i < S ? conv[(i64)(t0 + r) * S + i] : 0u;
  }
  const int c0 = blockIdx.x * (kThreads * CPT) + threadIdx.x;
  for (int i0 = 0; i0 < S; i0 += W) {
    unsigned v[CPT][W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const bool live = i0 + i < S;
      const unsigned q = live ? sq[i0 + i] : 1u;
      const unsigned w = live ? qhinv[i0 + i] : 0u;
      const unsigned wp = live ? qhinv_shoup[i0 + i] : 0u;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = c0 + k * kThreads;
        v[k][i] = live && c < n ? mul_mod_shoup32((unsigned)x[(i64)(i0 + i) * n + c], w, wp, q)
                                : 0u;
      }
    }
    __syncthreads();  // conv_s staged (the first chunk) or read by every thread
    const bool last = i0 + W >= S;
    for (int r = 0; r < rows; ++r) {
      const int t = t0 + r;
      const u64 p = dq[t];
      const u64 mu = dmu[t];
      const uint4* row = reinterpret_cast<const uint4*>(conv_s + r * stride + i0);
      u64 acc[CPT];
      unsigned a[CPT];  // ModDown's Q-row residues, loaded beside the addend
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = c0 + k * kThreads;
        acc[k] = 0;
        a[k] = kDown && last && c < n ? (unsigned)__ldg(acc_q + (i64)t * n + c) : 0u;
        if (c < n && i0 > 0) {
          acc[k] = (u64)out[(i64)t * n + c];  // this thread's partial sum
        } else if (kDown && c < n && add) {  // the addend, as add [-P]_{q_t}
          acc[k] = mul_mod_shoup32((unsigned)add[(i64)t * n + c], __ldg(down.tab + 2 * T + t),
                                   __ldg(down.tab + 3 * T + t), (unsigned)p);
        }
      }
#pragma unroll
      for (int j = 0; j < S4; ++j) {
        const uint4 w = row[j];
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          acc[k] += (u64)v[k][4 * j] * w.x;
          acc[k] += (u64)v[k][4 * j + 1] * w.y;
          acc[k] += (u64)v[k][4 * j + 2] * w.z;
          acc[k] += (u64)v[k][4 * j + 3] * w.w;
          if ((4 * j + 4) % kUnreduced == 0 && 4 * j + 4 < W) acc[k] = barrett_reduce(acc[k], p, mu);
        }
      }
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = c0 + k * kThreads;
        if (c >= n) continue;
        u64 res = barrett_reduce(acc[k], p, mu);
        if (kDown && last) {  // (acc_q - sum) [P^-1]_{q_t}
          res = mul_mod_shoup32(a[k] + (unsigned)p - (unsigned)res, __ldg(down.tab + t),
                                __ldg(down.tab + T + t), (unsigned)p);
        }
        out[(i64)t * n + c] = (i64)res;
      }
    }
  }
}

template <int S4, int CPT, bool kDown>
cudaError_t launch(const i64* x, i64* out, int S, int T, int n, int tg, int stride, int B,
                   long long x_bstride, long long out_bstride, const Down& down,
                   const unsigned* sq, const unsigned* qhinv, const unsigned* qhinv_shoup,
                   const unsigned* conv, const unsigned* dq, const u64* dmu,
                   cudaStream_t stream) {
  const size_t smem = (size_t)tg * stride * sizeof(unsigned);
  const dim3 grid((n + kThreads * CPT - 1) / (kThreads * CPT), (T + tg - 1) / tg, B);
  base_convert_kernel<S4, CPT, kDown><<<grid, kThreads, smem, stream>>>(
      x, out, S, T, n, tg, stride, x_bstride, out_bstride, down, sq, qhinv, qhinv_shoup, conv,
      dq, dmu);
  return cudaGetLastError();
}

template <int CPT, bool kDown>
cudaError_t dispatch(int s4, const i64* x, i64* out, int S, int T, int n, int tg, int stride,
                     int B, long long x_bstride, long long out_bstride, const Down& down,
                     const unsigned* sq, const unsigned* qhinv, const unsigned* qhinv_shoup,
                     const unsigned* conv, const unsigned* dq, const u64* dmu,
                     cudaStream_t st) {
#define K3_CASE(K)                                                                           \
  case K:                                                                                    \
    return launch<K, CPT, kDown>(x, out, S, T, n, tg, stride, B, x_bstride, out_bstride, down, \
                                 sq, qhinv, qhinv_shoup, conv, dq, dmu, st);
  switch (s4) {
    K3_CASE(1) K3_CASE(2) K3_CASE(3) K3_CASE(4) K3_CASE(5) K3_CASE(6) K3_CASE(7) K3_CASE(8)
  }
#undef K3_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* convert_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x: int64[B, S, n] canonical mod the source primes sq, batch stride
// x_bstride; out: int64[B, T, n], batch stride out_bstride (strides in
// elements; limb stride n, coefficient stride 1). Tables (ops/convert_cuda.py
// K3Tables, u32 but dmu): sq, qhinv, qhinv_shoup [S]; conv [T, S] canonical
// mod dq; dq [T]; dmu [T] = floor(2^64 / p_t). Every prime below 2^30. tg:
// destinations per block (>= 1); cpt: coefficients per thread (1 or 2).
// ModDown when acc is given: acc, int64[B, T, n] with x's batch stride, the
// Q rows; add, int64[b_add, T, n] with batch stride add_bstride (b_add <= B;
// 0 and null for none; it may be out); down, u32 [4][T]: [P^-1]_{q_t}, its
// Shoup companion, [-P]_{q_t} and its companion (ops/convert_cuda.py
// make_mod_down_table).
extern "C" int base_convert(const i64* x, i64* out, int S, int T, int n, int tg, int cpt,
                            int B, long long x_bstride, long long out_bstride, const i64* acc,
                            const i64* add, int b_add, long long add_bstride,
                            const unsigned* down, const unsigned* sq, const unsigned* qhinv,
                            const unsigned* qhinv_shoup, const unsigned* conv,
                            const unsigned* dq, const u64* dmu, void* stream) {
  if (S < 1 || T < 1 || n < 1 || tg < 1 || (cpt != 1 && cpt != 2) || B < 1 ||
      B > kMaxGroups || b_add < 0 || b_add > B || (b_add > 0 && (!acc || !add)) ||
      (acc && !down))
    return (int)cudaErrorInvalidValue;
  const int s4 = S >= 32 ? 8 : (S + 3) / 4;  // chunk of 4 s4 source limbs in registers
  const int stride = 4 * s4 * ((S + 4 * s4 - 1) / (4 * s4));
  tg = min(tg, T);
  tg = min(tg, max(1, kDefaultSmem / (int)(stride * sizeof(unsigned))));
  if ((T + tg - 1) / tg > kMaxGroups || stride * (int)sizeof(unsigned) > kDefaultSmem)
    return (int)cudaErrorInvalidValue;
  const Down dn{acc, add, add_bstride, b_add, down};
  cudaStream_t st = (cudaStream_t)stream;
#define K3_DISPATCH(CPT, DOWN)                                                             \
  dispatch<CPT, DOWN>(s4, x, out, S, T, n, tg, stride, B, x_bstride, out_bstride, dn, sq, \
                      qhinv, qhinv_shoup, conv, dq, dmu, st)
  const cudaError_t err = acc ? (cpt == 1 ? K3_DISPATCH(1, true) : K3_DISPATCH(2, true))
                              : (cpt == 1 ? K3_DISPATCH(1, false) : K3_DISPATCH(2, false));
#undef K3_DISPATCH
  return (int)err;
}
