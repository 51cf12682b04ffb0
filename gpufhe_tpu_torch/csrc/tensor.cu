// The ciphertext tensor: (a0, a1) x (b0, b1) -> (d0, d1, d2) in one pass
// (wrapper and plain version: ops/tensor_cuda.py),
//   d0 = a0 b0,  d1 = a0 b1 + a1 b0,  d2 = a1 b1        mod q_row
// over int64[K, n] NTT-domain residues, written into one int64[3, K, n]
// stack whose first two rows are the iNTT's input and whose third the key
// switch's.
//
// Replaces no Pallas kernel: the reference (gpufhe_tpu/ciphertext/ct.py:112
// _tensor_core) leaves the tensor to XLA's fusion of its elementwise ops,
// and the port ran it as 12 int64 PyTorch launches (four products, four
// remainders, the add_mod's four) and a copy into the stack the iNTT reads.
// Row r's prime is q[chain[r]] of the caller's context (ops/context.py), as
// K1 and K4 read theirs, so one launch serves any chain: the Q limbs of all
// three schemes, BFV's auxiliary basis, a mesh shard's rows.
//
// What bounds it on the H100: bytes. Each coefficient-limb reads four
// residues and writes three, 56 B at the int64 interface (28 B at 4 B a
// residue), against four 32 x 32 -> 64-bit products and three reductions:
// far below the integer rate. Design: a thread owns two neighbouring
// coefficients of one row (blockIdx.y), so every load and store is one
// 16-byte access and a warp moves 512 contiguous bytes per operand. Residues
// are below 2^30, so a product is exact in 64 bits (below 2^60) and d1's two
// products sum below 2^61; each output takes one 64-bit Barrett reduction
// (modarith.cuh barrett_reduce with the context's mu = floor(2^64 / q),
// exact for any 64-bit input), so no 64-bit % or division is issued and
// every output is canonical.

#include "modarith.cuh"

namespace {

constexpr int kThreads = 256;

// two residues, each below 2^30: the low words of two int64 values
struct Pair {
  unsigned lo, hi;
};

__device__ __forceinline__ Pair load2(const i64* __restrict__ p) {
  const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(p));
  return {(unsigned)v.x, (unsigned)v.y};
}

// the exact 64-bit product of two 32-bit words (one widening multiply)
__device__ __forceinline__ u64 wide(unsigned a, unsigned b) { return (u64)a * b; }

__device__ __forceinline__ void store2(i64* __restrict__ p, u64 lo, u64 hi) {
  *reinterpret_cast<longlong2*>(p) = make_longlong2((i64)lo, (i64)hi);
}

__global__ void __launch_bounds__(kThreads)
tensor_kernel(const i64* __restrict__ a0, const i64* __restrict__ a1,
              const i64* __restrict__ b0, const i64* __restrict__ b1, i64 a0_stride,
              i64 a1_stride, i64 b0_stride, i64 b1_stride, i64* __restrict__ out, int K, int n,
              const int* __restrict__ chain, const i64* __restrict__ qs,
              const i64* __restrict__ mus) {
  const int col = 2 * (blockIdx.x * kThreads + threadIdx.x);
  if (col >= n) return;
  const int row = blockIdx.y;
  const int ch = __ldg(chain + row);
  const u64 q = (u64)__ldg(qs + ch);
  const u64 mu = (u64)__ldg(mus + ch);
  const Pair x0 = load2(a0 + row * a0_stride + col);
  const Pair x1 = load2(a1 + row * a1_stride + col);
  const Pair y0 = load2(b0 + row * b0_stride + col);
  const Pair y1 = load2(b1 + row * b1_stride + col);
  const i64 plane = (i64)K * n;
  i64* o = out + (i64)row * n + col;
  store2(o, barrett_reduce(wide(x0.lo, y0.lo), q, mu),
         barrett_reduce(wide(x0.hi, y0.hi), q, mu));
  store2(o + plane, barrett_reduce(wide(x0.lo, y1.lo) + wide(x1.lo, y0.lo), q, mu),
         barrett_reduce(wide(x0.hi, y1.hi) + wide(x1.hi, y0.hi), q, mu));
  store2(o + 2 * plane, barrett_reduce(wide(x1.lo, y1.lo), q, mu),
         barrett_reduce(wide(x1.hi, y1.hi), q, mu));
}

}  // namespace

extern "C" const char* tensor_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// a0, a1, b0, b1: int64[K, n] canonical residues, each with its own limb
// stride (in elements, even) and coefficient stride 1, 16-byte aligned;
// out: int64[3, K, n] contiguous. chain: int32[K], the row of q and mu
// (int64, floor(2^64 / q)) for limb r; every prime below 2^30. n even.
extern "C" int tensor_launch(const i64* a0, const i64* a1, const i64* b0, const i64* b1,
                             long long a0_stride, long long a1_stride, long long b0_stride,
                             long long b1_stride, i64* out, int K, int n, const int* chain,
                             const i64* q, const i64* mu, void* stream) {
  if (K < 1 || K > 65535 || n < 2 || n % 2) return (int)cudaErrorInvalidValue;
  const dim3 grid((n / 2 + kThreads - 1) / kThreads, K);
  tensor_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a0, a1, b0, b1, a0_stride, a1_stride, b0_stride, b1_stride, out, K, n, chain, q, mu);
  return (int)cudaGetLastError();
}
