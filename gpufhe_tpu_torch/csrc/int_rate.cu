// Integer throughput probe: the card-side counterpart of scripts/vpu_peak.py
// make_prog (host side: ops/probes.py int_rate). Not on any path of the port;
// it measures the rate that the operation side of every kernel's bound
// divides by.
//
// Method, as in the TPU probe: every thread advances kChains independent
// chains by `depth` serial steps of one mix, so the scheduler always has
// independent work to issue, and the grid fills every SM. The host side times
// a run at full depth and a floor run at a small depth and divides the
// steps between them by the time between them. Each thread writes the xor
// of its chains, so nothing is dead code. The mixes:
//   0 muladd  v = v * c0 + c1 in 32 bits: the 32-bit multiply-add rate;
//   1 modmul  v = mul_mod(v, w, q, mu), modarith.cuh's Barrett product of
//             two canonical 30-bit residues, the modular product of K1, K3
//             and K4's reductions, instruction for instruction;
//   2 shoup32 v = mul_mod_shoup32(v, w, wp, q), the same product in 32-bit
//             words against a precomputed w' (every product of K1 and K3
//             has a table constant for one operand): the card's rate for a
//             modular product of 30-bit residues, which the bounds use.
// Start values: chain k of thread i holds (i * kChains + k) mod q for
// modmul and shoup32, and (i * kChains + k) for muladd.

#include "modarith.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;

template <int MIX>
__global__ void __launch_bounds__(kThreads)
rate_kernel(u64* __restrict__ out, int depth, unsigned c0, unsigned c1, u64 w, u64 q, u64 mu,
            unsigned wp) {
  const u64 i = (u64)blockIdx.x * blockDim.x + threadIdx.x;
  u64 v[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    const u64 s = i * kChains + k;
    v[k] = MIX == 0 ? (u64)(unsigned)s : s % q;
  }
  for (int step = 0; step < depth; ++step) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      if (MIX == 0) v[k] = (unsigned)v[k] * c0 + c1;
      else if (MIX == 1) v[k] = mul_mod(v[k], w, q, mu);
      else v[k] = mul_mod_shoup32((unsigned)v[k], (unsigned)w, wp, (unsigned)q);
    }
  }
  u64 acc = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) acc ^= v[k];
  out[i] = acc;
}

}  // namespace

extern "C" const char* int_rate_strerror(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// out: uint64[blocks * 256]; mix 0 (muladd), 1 (modmul) or 2 (shoup32);
// mu = floor(2^64 / q), wp = floor(w 2^32 / q).
extern "C" int int_rate_launch(unsigned long long* out, int mix, int blocks, int depth,
                               unsigned c0, unsigned c1, u64 w, u64 q, u64 mu, unsigned wp,
                               void* stream) {
  if (blocks < 1 || depth < 0 || mix < 0 || mix > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mix == 0) rate_kernel<0><<<blocks, kThreads, 0, s>>>(out, depth, c0, c1, w, q, mu, wp);
  else if (mix == 1) rate_kernel<1><<<blocks, kThreads, 0, s>>>(out, depth, c0, c1, w, q, mu, wp);
  else rate_kernel<2><<<blocks, kThreads, 0, s>>>(out, depth, c0, c1, w, q, mu, wp);
  return (int)cudaGetLastError();
}
