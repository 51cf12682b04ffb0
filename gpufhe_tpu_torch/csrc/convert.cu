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
//   card (PERF.md). Stores of out[t, c] are int64 and coalesced along c.
// The TPU kernel's int8 digit matmuls on the matrix unit have no
// counterpart: Hopper multiplies 32-bit words to 64 bits directly.

#include "modarith.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnreduced = 16;  // products summed before a Barrett step
constexpr int kMaxGroups = 65535;  // grid y
constexpr int kDefaultSmem = 48 * 1024;  // static limit without an opt-in

// Source limbs i0 .. i0 + 4 S4 (a chunk) for cpt coefficients per thread,
// destinations t0 .. t0 + rows of this block. conv_s holds the rows of
// conv for these destinations, `stride` words each (a multiple of 4 S4,
// zero past S).
template <int S4, int CPT>
__global__ void __launch_bounds__(kThreads)
base_convert_kernel(const i64* __restrict__ x, i64* __restrict__ out, int S, int T, int n,
                    int tg, int stride, const unsigned* __restrict__ sq,
                    const unsigned* __restrict__ qhinv,
                    const unsigned* __restrict__ qhinv_shoup,
                    const unsigned* __restrict__ conv, const unsigned* __restrict__ dq,
                    const u64* __restrict__ dmu) {
  constexpr int W = 4 * S4;
  extern __shared__ uint4 smem[];
  unsigned* conv_s = reinterpret_cast<unsigned*>(smem);
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
    for (int r = 0; r < rows; ++r) {
      const int t = t0 + r;
      const u64 p = dq[t];
      const u64 mu = dmu[t];
      const uint4* row = reinterpret_cast<const uint4*>(conv_s + r * stride + i0);
      u64 acc[CPT];
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = c0 + k * kThreads;
        acc[k] = i0 > 0 && c < n ? (u64)out[(i64)t * n + c] : 0;  // this thread's partial sum
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
        if (c < n) out[(i64)t * n + c] = (i64)barrett_reduce(acc[k], p, mu);
      }
    }
  }
}

template <int S4, int CPT>
cudaError_t launch(const i64* x, i64* out, int S, int T, int n, int tg, int stride,
                   const unsigned* sq, const unsigned* qhinv, const unsigned* qhinv_shoup,
                   const unsigned* conv, const unsigned* dq, const u64* dmu,
                   cudaStream_t stream) {
  const size_t smem = (size_t)tg * stride * sizeof(unsigned);
  const dim3 grid((n + kThreads * CPT - 1) / (kThreads * CPT), (T + tg - 1) / tg);
  base_convert_kernel<S4, CPT><<<grid, kThreads, smem, stream>>>(
      x, out, S, T, n, tg, stride, sq, qhinv, qhinv_shoup, conv, dq, dmu);
  return cudaGetLastError();
}

template <int CPT>
cudaError_t dispatch(int s4, const i64* x, i64* out, int S, int T, int n, int tg, int stride,
                     const unsigned* sq, const unsigned* qhinv, const unsigned* qhinv_shoup,
                     const unsigned* conv, const unsigned* dq, const u64* dmu,
                     cudaStream_t st) {
#define K3_CASE(K) \
  case K:          \
    return launch<K, CPT>(x, out, S, T, n, tg, stride, sq, qhinv, qhinv_shoup, conv, dq, dmu, st);
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

// x: int64[S, n] canonical mod the source primes sq; out: int64[T, n].
// Tables (ops/convert_cuda.py K3Tables, u32 but dmu): sq, qhinv, qhinv_shoup
// [S]; conv [T, S] canonical mod dq; dq [T]; dmu [T] = floor(2^64 / p_t).
// Every prime below 2^30. tg: destinations per block (>= 1); cpt:
// coefficients per thread (1 or 2).
extern "C" int base_convert(const i64* x, i64* out, int S, int T, int n, int tg, int cpt,
                            const unsigned* sq, const unsigned* qhinv,
                            const unsigned* qhinv_shoup, const unsigned* conv,
                            const unsigned* dq, const u64* dmu, void* stream) {
  if (S < 1 || T < 1 || n < 1 || tg < 1 || (cpt != 1 && cpt != 2))
    return (int)cudaErrorInvalidValue;
  const int s4 = S >= 32 ? 8 : (S + 3) / 4;  // chunk of 4 s4 source limbs in registers
  const int stride = 4 * s4 * ((S + 4 * s4 - 1) / (4 * s4));
  tg = min(tg, T);
  tg = min(tg, max(1, kDefaultSmem / (int)(stride * sizeof(unsigned))));
  if ((T + tg - 1) / tg > kMaxGroups || stride * (int)sizeof(unsigned) > kDefaultSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      cpt == 1 ? dispatch<1>(s4, x, out, S, T, n, tg, stride, sq, qhinv, qhinv_shoup, conv, dq,
                             dmu, st)
               : dispatch<2>(s4, x, out, S, T, n, tg, stride, sq, qhinv, qhinv_shoup, conv, dq,
                             dmu, st);
  return (int)err;
}
