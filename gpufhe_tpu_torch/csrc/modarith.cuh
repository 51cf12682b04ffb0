// Modular arithmetic shared by the port's kernels (ntt.cu, convert.cu,
// mac.cu, rescale.cu, tensor.cu) and by the integer-rate probe
// (int_rate.cu), so that the probe's "modmul" mix times the 64-bit Barrett
// product that convert.cu, mac.cu and tensor.cu run, and its "shoup32" mix the 32-bit Shoup product (mul_mod_shoup32) that
// ntt.cu's products are built from.
//
// Residues are canonical, below primes q < 2^30, stored as int64. mu is
// floor(2^64 / q), the Barrett constant (ops/context.py Context.mu). The
// lazy 32-bit products below leave their result in [0, 2q); 4q < 2^32 keeps
// every value of a lazy schedule in one 32-bit word.

#pragma once

#include <cuda_runtime.h>

typedef unsigned long long u64;
typedef long long i64;

// t mod q for any t < 2^64: the quotient estimate floor(t * mu / 2^64) is
// short of floor(t / q) by at most one, so one conditional subtract is enough.
__device__ __forceinline__ u64 barrett_reduce(u64 t, u64 q, u64 mu) {
  const u64 r = t - __umul64hi(t, mu) * q;
  return r >= q ? r - q : r;
}

// a * b mod q for canonical a, b < q < 2^30: the product is below 2^60.
__device__ __forceinline__ u64 mul_mod(u64 a, u64 b, u64 q, u64 mu) {
  return barrett_reduce(a * b, q, mu);
}

// a * 2^-32 mod q for a < q (Montgomery REDC with R = 2^32, qinv_neg =
// -q^-1 mod 2^32): a + m q is divisible by 2^32 and below 2^32 q + q, and
// the quotient equals q only for a = 0 (then m = 0), so it is canonical.
__device__ __forceinline__ u64 redc(u64 a, u64 q, unsigned qinv_neg) {
  const unsigned m = (unsigned)a * qinv_neg;
  return (a + (u64)m * q) >> 32;
}

// a * w mod q in 32-bit words (Shoup), for a < 2^32, w < q < 2^31 and wp =
// floor(w * 2^32 / q): the quotient estimate umulhi(a, wp) is short of
// floor(a w / q) by at most one, so a w - estimate * q, taken mod 2^32, is
// in [0, 2q) (mul_shoup_lazy), and one conditional subtract makes it
// canonical (mul_mod_shoup32). Three 32-bit multiplies against mul_mod's
// 64-bit product and 64 x 64 high half.
__device__ __forceinline__ unsigned mul_shoup_lazy(unsigned a, unsigned w, unsigned wp,
                                                   unsigned q) {
  return a * w - __umulhi(a, wp) * q;
}

__device__ __forceinline__ unsigned mul_mod_shoup32(unsigned a, unsigned w, unsigned wp,
                                                    unsigned q) {
  const unsigned r = mul_shoup_lazy(a, w, wp, q);
  return r >= q ? r - q : r;
}

// a * w * 2^-32 mod q up to one q, in [0, 2q), for a * w < q 2^32 (one
// 32 x 32 -> 64-bit product and a REDC with qinv_neg = -q^-1 mod 2^32):
// (a w + m q) / 2^32 < (q 2^32 + 2^32 q) / 2^32.
__device__ __forceinline__ unsigned mont_mul_lazy(unsigned a, unsigned w, unsigned q,
                                                  unsigned qinv_neg) {
  const u64 t = (u64)a * w;
  const unsigned m = (unsigned)t * qinv_neg;
  return (unsigned)((t + (u64)m * q) >> 32);
}
