// RNS approximate base conversion: kernel K3 of the PyTorch/CUDA port
// (wrapper and plain version: ops/convert_cuda.py).
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
// Design: one thread per (destination limb t, coefficient c), looping over
// the S source limbs; each term is reduced (a 30-bit by 30-bit product is
// below 2^60, and a sum of eight would overflow a signed 64-bit value). The
// TPU kernel's int8 digit matmuls on the matrix unit have no counterpart
// here: a 64-bit product plus a Barrett reduction is the natural unit.
//
// What bounds it on the H100: the data is read once from device memory
// (S x N) and written once (T x N); the other T-1 reads of each source
// coefficient hit L2 (a 15 x 2^16 int64 source is 7.9 MB, far below 50 MB).
// The per-coefficient work is 2*S*T modular products, which at S=15 puts
// the kernel closer to the integer-multiply limit than to the byte limit;
// computing v_i once per coefficient instead of once per (t, c) is the
// first step of later performance work.

#include <cuda_runtime.h>

typedef unsigned long long u64;
typedef long long i64;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ u64 mul_mod(u64 a, u64 b, u64 q, u64 mu) {
  u64 t = a * b;  // a, b < q < 2^30
  u64 r = t - __umul64hi(t, mu) * q;
  return r >= q ? r - q : r;
}

__global__ void __launch_bounds__(kThreads)
base_convert_kernel(const i64* __restrict__ x, i64* __restrict__ out, int S, int n,
                    const i64* __restrict__ sq, const i64* __restrict__ smu,
                    const i64* __restrict__ qhinv, const i64* __restrict__ conv,
                    const i64* __restrict__ dq, const i64* __restrict__ dmu) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (c >= n) return;
  const u64 qt = (u64)dq[t];
  const u64 mut = (u64)dmu[t];
  u64 acc = 0;
  for (int i = 0; i < S; ++i) {
    const u64 v = mul_mod((u64)x[(i64)i * n + c], (u64)qhinv[i], (u64)sq[i], (u64)smu[i]);
    acc += mul_mod(v, (u64)conv[(i64)t * S + i], qt, mut);
    acc = acc >= qt ? acc - qt : acc;
  }
  out[(i64)t * n + c] = (i64)acc;
}

}  // namespace

extern "C" const char* convert_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x: int64[S, n] canonical mod the source primes sq; out: int64[T, n].
// qhinv: [S]; conv: [T, S] canonical mod dq; smu, dmu: floor(2^64 / prime).
extern "C" int base_convert(const i64* x, i64* out, int S, int T, int n,
                            const i64* sq, const i64* smu, const i64* qhinv,
                            const i64* conv, const i64* dq, const i64* dmu,
                            void* stream) {
  if (S < 1 || T < 1 || T > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((n + kThreads - 1) / kThreads, T);
  base_convert_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, S, n, sq, smu, qhinv, conv, dq, dmu);
  return (int)cudaGetLastError();
}
