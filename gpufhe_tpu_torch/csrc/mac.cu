// Key-switch digit multiply-accumulate: kernel K4 of the PyTorch/CUDA port
// (wrapper and plain version: ops/mac_cuda.py).
//
// Replaces scripts/dw_mac_probe.py pallas_mac (body _mac_kernel), the TPU
// kernel of the reference's key-switch inner product (gpufhe_tpu/primitives/
// keyswitch.py key_switch_core, gpufhe_tpu/ops/modops.py mont_mac): one
// launch gives both accumulators,
//   out_j[t, c] = sum_d x[d, t, c'] * y_j[d, rows[t], c] * 2^-32  mod q_t
// canonical in [0, q_t), for j = 0, 1, with q_t = q[chain[t]] and c' =
// perm[c] (c when no permutation is given). The key (y) keeps its stored
// layout: `rows` picks the rows of the active level, so no copy of the key
// is made when it is stored above that level; `perm` folds the Galois
// automorphism of a hoisted rotation into the load of x. With y1 null the
// launch forms out_0 alone (a plaintext product of one component).
//
// Design: one thread per (row t, coefficient c), looping over the D digits.
// Residues are below 2^30, so each product is exact as one 32 x 32 -> 64
// bit multiply (below 2^60), and up to 8 of them are summed unreduced (below
// 2^63). A Montgomery REDC of the raw sum would need it below q * 2^32, that
// is D * q < 2^32, which fails from D = 5 at 30-bit primes (dnum = 5 at
// config5_boot_dw, 6 at boot_dw_ci_enc). So the sum is reduced mod q by a
// 64-bit Barrett step (modarith.cuh barrett_reduce, exact for any 64-bit
// input), every 8 digits and once at the end, and one REDC of the canonical
// result applies the 2^-32. The TPU kernel's 16-bit product pieces have no
// counterpart: Hopper multiplies 32-bit words to 64 bits directly.
//
// What bounds it on the H100: bytes. Per output pair it reads D words of x
// and 2 D key words and writes 2 words, 8 N (3 D T + 2 T) bytes at int64,
// against 2 D multiply-adds and 2 reductions: far below the integer rate.
// Loads and stores coalesce along c; with a permutation the x loads gather
// within one row of x (N words, held in L2).

#include "modarith.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnreduced = 8;  // products summed before a Barrett step

__global__ void __launch_bounds__(kThreads)
mac_kernel(const i64* __restrict__ x, const i64* __restrict__ y0,
           const i64* __restrict__ y1, i64* __restrict__ out0, i64* __restrict__ out1,
           int D, int T, int n, i64 y_dstride, const int* __restrict__ rows,
           const int* __restrict__ chain, const int* __restrict__ perm,
           const i64* __restrict__ qs, const i64* __restrict__ mus,
           const i64* __restrict__ qinvs) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (c >= n) return;
  const int ch = chain[t];
  const u64 q = (u64)qs[ch];
  const u64 mu = (u64)mus[ch];
  const i64 x_dstride = (i64)T * n;
  const i64 xo = (i64)t * n + (perm ? perm[c] : c);
  const i64 yo = (i64)rows[t] * n + c;
  const bool two = y1 != nullptr;
  u64 a0 = 0, a1 = 0;
  for (int d = 0; d < D; ++d) {
    const u64 xv = (unsigned)x[d * x_dstride + xo];
    a0 += xv * (unsigned)y0[d * y_dstride + yo];
    if (two) a1 += xv * (unsigned)y1[d * y_dstride + yo];
    if (d % kUnreduced == kUnreduced - 1) {
      a0 = barrett_reduce(a0, q, mu);
      if (two) a1 = barrett_reduce(a1, q, mu);
    }
  }
  const unsigned qinv = (unsigned)qinvs[ch];
  const i64 o = (i64)t * n + c;
  out0[o] = (i64)redc(barrett_reduce(a0, q, mu), q, qinv);
  if (two) out1[o] = (i64)redc(barrett_reduce(a1, q, mu), q, qinv);
}

}  // namespace

extern "C" const char* mac_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x: int64[D, T, n]; y0, y1: int64[>= D, S, n] (the same layout; digit
// stride y_dstride = S n), y1 may be null; out0, out1: int64[T, n] (out1
// unused when y1 is null). rows, chain: int32[T],
// the row of y and the chain row of q/mu/qinv_neg for output row t; perm:
// int32[n] or null. Every x and y value is canonical mod its row's prime.
extern "C" int mac_launch(const i64* x, const i64* y0, const i64* y1, i64* out0, i64* out1,
                          int D, int T, int n, long long y_dstride, const int* rows,
                          const int* chain, const int* perm, const i64* q, const i64* mu,
                          const i64* qinv_neg, void* stream) {
  if (D < 1 || T < 1 || T > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((n + kThreads - 1) / kThreads, T);
  mac_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, y0, y1, out0, out1, D, T, n, y_dstride, rows, chain, perm, q, mu, qinv_neg);
  return (int)cudaGetLastError();
}
