// Modular arithmetic shared by the port's kernels (ntt.cu, convert.cu,
// mac.cu) and by the integer-rate probe (int_rate.cu), so that the probe's
// "modmul" mix times the very instruction sequence the kernels run, and its
// "shoup32" mix the cheapest product of two 30-bit residues that the card
// offers (mul_mod_shoup32, which no kernel uses yet).
//
// Residues are canonical, below primes q < 2^30, stored as int64. mu is
// floor(2^64 / q), the Barrett constant (ops/context.py Context.mu).

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
// below 2q and one conditional subtract makes it canonical. Three 32-bit
// multiplies against mul_mod's 64-bit product and 64 x 64 high half.
__device__ __forceinline__ unsigned mul_mod_shoup32(unsigned a, unsigned w, unsigned wp,
                                                    unsigned q) {
  const unsigned r = a * w - __umulhi(a, wp) * q;
  return r >= q ? r - q : r;
}
