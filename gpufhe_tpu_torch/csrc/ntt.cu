// Negacyclic NTT and inverse NTT of a batch of RNS limbs: kernel K1 of the
// PyTorch/CUDA port (wrapper and plain version: ops/ntt_cuda.py).
//
// Replaces gpufhe_tpu/ops/ntt_pallas.py fourstep_pallas_v3 (reached through
// gpufhe_tpu/ops/ntt.py _fourstep_v3), and computes the same function as that
// file's fourstep_pallas_v2 and fourstep_pallas. Same contract: int32 limb
// indices into FULL per-prime tables, so one build serves every limb
// selection; canonical output in natural order; the inverse has 1/N folded in.
//
// Design. A limb of N = 2^16 int64 residues is 512 KB, more than a block's
// shared memory, so the transform is the four-step split N = n1 * n2
// (256 x 256), in two passes over device memory:
//   pass A: for each column j2, an n1-point transform over j1 (stride n2),
//           with the psi1^j1 pre-twist and the four-step twiddle
//           psi^(j2 (2 k1 + 1)) folded in;
//   pass B: for each row k1, an n2-point transform over j2, written back in
//           the transposed (natural) order.
// The inverse runs the two passes the other way round with inverse roots.
// Each block holds TL lanes x R points in shared memory, loads them in
// bit-reversed order and runs log2(R) radix-2 Cooley-Tukey stages there.
// The twiddle is not a table of N entries: with e = j2 (2 k1 + 1) mod 2N it
// is psi^e = lo[e mod n1] * hi[e / n1], from two rows of n1 and 2 n2 powers
// per prime held in shared memory, so every table the kernel reads is
// O(n1 + n2) words per prime. The TPU kernel's int8 digit matmuls and
// Shoup recombines have no counterpart: Hopper multiplies 64-bit integers
// directly, and each modular product is one 64-bit product plus a Barrett
// reduction (mu = 2^64 / q).
//
// What bounds it on the H100: each pass reads and writes every limb once
// (16 bytes per residue), so the floor is device-memory bandwidth; the
// 64-bit multiplies (emulated by several 32-bit IMADs) are the next limit.
// The design keeps both passes at one read and one write of the data, with
// lanes laid along the contiguous axis so loads and stores coalesce. Not yet
// done (later performance work): 32-bit storage, Shoup or Montgomery 32-bit
// products, and fusing both passes for small N.

#include <cuda_runtime.h>

typedef unsigned long long u64;
typedef long long i64;

namespace {

constexpr int kThreads = 256;

struct Pass {
  const i64* in;
  i64* out;
  const int* idx;  // chain row of data row r is idx[r % L]
  int L;
  int n;            // limb length, the row stride of in/out
  int R, logR;      // transform length
  int TL, logTL;    // lanes per block
  i64 in_ts, in_ls, out_ts, out_ls;  // element (t, lane) strides
  const i64* q;
  const i64* mu;
  const i64* w;     // [chain, n/2] root powers; sub-transform root = w^(n/R)
  // twist 1 (forward pass A): t1d[t] on load, twiddle(t, lane) on store;
  // twist 2 (inverse pass A): twiddle(t, lane) on load, t1d[t] on store.
  int twist;
  const i64* t1d;   // [chain, R]
  const i64* tlo;   // [chain, R]      psi^+-e, e < R (R = n1 in pass A)
  const i64* thi;   // [chain, 2n/R]   psi^+-(R e)
};

__device__ __forceinline__ u64 mul_mod(u64 a, u64 b, u64 q, u64 mu) {
  // a, b < q < 2^30: t < 2^60; the Barrett quotient is short by at most one
  u64 t = a * b;
  u64 r = t - __umul64hi(t, mu) * q;
  return r >= q ? r - q : r;
}

__global__ void __launch_bounds__(kThreads) ntt_pass(const Pass p) {
  extern __shared__ u64 smem[];
  u64* data = smem;                  // [TL][R]
  u64* roots = data + p.TL * p.R;    // [R/2]
  u64* t1d = roots + p.R / 2;        // [R]       (twist only)
  u64* tlo = t1d + p.R;              // [R]
  u64* thi = tlo + p.R;              // [2n/R]
  const int row = blockIdx.y;
  const int chain = p.idx[row % p.L];
  const u64 q = (u64)p.q[chain];
  const u64 mu = (u64)p.mu[chain];
  const int lane0 = blockIdx.x * p.TL;
  const int half = p.R >> 1;
  const i64 rowoff = (i64)row * p.n;
  const int total = p.TL * p.R;
  const int nhi = 2 * p.n / p.R;
  const unsigned emask = 2u * p.n - 1u;

  const i64 wstride = (i64)(p.n / p.R);
  for (int e = threadIdx.x; e < half; e += blockDim.x)
    roots[e] = (u64)p.w[(i64)chain * (p.n >> 1) + e * wstride];
  if (p.twist) {
    for (int e = threadIdx.x; e < p.R; e += blockDim.x) {
      t1d[e] = (u64)p.t1d[(i64)chain * p.R + e];
      tlo[e] = (u64)p.tlo[(i64)chain * p.R + e];
    }
    for (int e = threadIdx.x; e < nhi; e += blockDim.x)
      thi[e] = (u64)p.thi[(i64)chain * nhi + e];
  }
  __syncthreads();

  // psi^(+-lane (2 t + 1)), the four-step twiddle at (k1 = t, j2 = lane)
  auto twiddle = [&](int t, int lane) -> u64 {
    const unsigned e = ((unsigned)lane * (2u * t + 1u)) & emask;
    return mul_mod(tlo[e & (p.R - 1)], thi[e >> p.logR], q, mu);
  };

  const bool lane_fast_in = (p.in_ls == 1);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    int t, lane;
    if (lane_fast_in) { lane = i & (p.TL - 1); t = i >> p.logTL; }
    else { t = i & (p.R - 1); lane = i >> p.logR; }
    const i64 gl = lane0 + lane;
    u64 v = (u64)p.in[rowoff + t * p.in_ts + gl * p.in_ls];
    if (p.twist == 1) v = mul_mod(v, t1d[t], q, mu);
    else if (p.twist == 2) v = mul_mod(v, twiddle(t, (int)gl), q, mu);
    const int rt = (int)(__brev((unsigned)t) >> (32 - p.logR));
    data[lane * p.R + rt] = v;
  }
  __syncthreads();

  // radix-2 DIT on bit-reversed input -> natural-order output
  for (int logm = 0; logm < p.logR; ++logm) {
    const int m = 1 << logm;
    const int rshift = p.logR - 1 - logm;  // root index step R / (2m)
    for (int b = threadIdx.x; b < p.TL * half; b += blockDim.x) {
      const int lane = b >> (p.logR - 1);
      const int j = b & (half - 1);
      const int k = j & (m - 1);
      const int i0 = lane * p.R + ((j >> logm) << (logm + 1)) + k;
      const int i1 = i0 + m;
      const u64 u = data[i0];
      const u64 v = mul_mod(data[i1], roots[k << rshift], q, mu);
      const u64 s = u + v;
      const u64 d = u + q - v;
      data[i0] = s >= q ? s - q : s;
      data[i1] = d >= q ? d - q : d;
    }
    __syncthreads();
  }

  const bool lane_fast_out = (p.out_ls == 1);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    int t, lane;
    if (lane_fast_out) { lane = i & (p.TL - 1); t = i >> p.logTL; }
    else { t = i & (p.R - 1); lane = i >> p.logR; }
    const i64 gl = lane0 + lane;
    u64 v = data[lane * p.R + t];
    if (p.twist == 1) v = mul_mod(v, twiddle(t, (int)gl), q, mu);
    else if (p.twist == 2) v = mul_mod(v, t1d[t], q, mu);
    p.out[rowoff + t * p.out_ts + gl * p.out_ls] = (i64)v;
  }
}

int ilog2(int v) {
  int r = 0;
  while ((1 << r) < v) ++r;
  return r;
}

int launch(Pass p, int lanes, int rows, cudaStream_t stream) {
  p.logR = ilog2(p.R);
  p.TL = lanes < 16 ? lanes : 16;
  p.logTL = ilog2(p.TL);
  if (p.R < 2 || (1 << p.logR) != p.R || (1 << p.logTL) != p.TL || lanes % p.TL)
    return (int)cudaErrorInvalidValue;
  const int tables = p.twist ? 2 * p.R + 2 * p.n / p.R : 0;
  const size_t smem = (size_t)(p.TL * p.R + p.R / 2 + tables) * sizeof(u64);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid(lanes / p.TL, rows);
  ntt_pass<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* ntt_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x, y, scratch: int64[rows, n] with rows = batch * L, canonical residues.
// idx: int32[L] rows of the full tables. Per direction (ops/context.py
// ntt_tables_np): w [chain, n/2], t1d [chain, n1], tlo [chain, n1] and
// thi [chain, 2 n2].
extern "C" int ntt_fourstep(const i64* x, i64* y, i64* scratch, const int* idx,
                            int L, int rows, int n, int n1, int n2, int inverse,
                            const i64* q, const i64* mu, const i64* w,
                            const i64* t1d, const i64* tlo, const i64* thi,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Pass base = {};
  base.idx = idx;
  base.L = L;
  base.n = n;
  base.q = q;
  base.mu = mu;
  base.w = w;
  Pass a = base;  // pass A: transform over j1 (t) for each column j2
  a.R = n1;
  a.in_ts = n2; a.in_ls = 1; a.out_ts = n2; a.out_ls = 1;
  a.twist = inverse ? 2 : 1;
  a.t1d = t1d; a.tlo = tlo; a.thi = thi;
  Pass b = base;  // pass B: transform over j2 for each row k1
  b.R = n2;
  if (!inverse) {
    a.in = x; a.out = scratch;
    int err = launch(a, n2, rows, s);
    if (err) return err;
    // row k1 of [n1, n2] -> X[k2 * n1 + k1]
    b.in = scratch; b.out = y;
    b.in_ts = 1; b.in_ls = n2; b.out_ts = n1; b.out_ls = 1;
    return launch(b, n1, rows, s);
  }
  // inverse: X[k2 * n1 + k1] -> [k1, j2], then twiddle out on load,
  // transform over k1, psi1^-j1 / N on store
  b.in = x; b.out = scratch;
  b.in_ts = n1; b.in_ls = 1; b.out_ts = 1; b.out_ls = n2;
  int err = launch(b, n1, rows, s);
  if (err) return err;
  a.in = scratch; a.out = y;
  return launch(a, n2, rows, s);
}
