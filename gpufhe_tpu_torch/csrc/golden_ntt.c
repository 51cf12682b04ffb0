/* Native golden-model NTT: exact negacyclic transforms for q < 2^62.
 *
 * The host side of the golden model (gpufhe_tpu_torch/golden/), its key
 * generation and its known-answer vectors run their transforms here, some
 * fifty times faster than the numpy formulation of golden/ntt.py. It runs on
 * the host and shares nothing with the CUDA kernels of this directory, so it
 * stays an independent oracle for them.
 *
 * The transform is exact integer arithmetic with one answer, so any correct
 * algorithm gives the same canonical outputs as golden/ntt.py:
 *     fwd:  X_k = sum_j x_j psi^j omega^(jk) mod q   (natural in/out)
 *     inv:  x_j = n^-1 psi^-j sum_k X_k omega^(-jk) mod q
 *
 * Build: cc -O2 -shared -fPIC -o libgolden_ntt.so golden_ntt.c
 * Loaded with ctypes by gpufhe_tpu_torch/golden/native.py, which keeps the
 * numpy path where no C compiler is found.
 */

#include <stdint.h>
#include <stdlib.h>

typedef unsigned __int128 u128;

static inline uint64_t mulmod(uint64_t a, uint64_t b, uint64_t q) {
    return (uint64_t)(((u128)a * b) % q);
}

static uint64_t powmod(uint64_t b, uint64_t e, uint64_t q) {
    uint64_t r = 1;
    b %= q;
    while (e) {
        if (e & 1) r = mulmod(r, b, q);
        b = mulmod(b, b, q);
        e >>= 1;
    }
    return r;
}

static void bit_reverse(uint64_t *x, int64_t n) {
    for (int64_t i = 1, j = 0; i < n; i++) {
        int64_t bit = n >> 1;
        for (; j & bit; bit >>= 1) j ^= bit;
        j ^= bit;
        if (i < j) {
            uint64_t t = x[i];
            x[i] = x[j];
            x[j] = t;
        }
    }
}

/* In-place cyclic NTT, natural order in and out: X_k = sum_j x_j w^(jk). */
static void cyclic_ntt(uint64_t *x, int64_t n, uint64_t q, uint64_t w) {
    bit_reverse(x, n);
    for (int64_t len = 2; len <= n; len <<= 1) {
        uint64_t wl = powmod(w, (uint64_t)(n / len), q);
        for (int64_t i = 0; i < n; i += len) {
            uint64_t tw = 1;
            for (int64_t j = 0; j < len / 2; j++) {
                uint64_t u = x[i + j];
                uint64_t v = mulmod(x[i + j + len / 2], tw, q);
                uint64_t s = u + v;
                if (s >= q) s -= q;
                x[i + j] = s;
                x[i + j + len / 2] = (u >= v) ? u - v : u + q - v;
                tw = mulmod(tw, wl, q);
            }
        }
    }
}

/* batch rows x[b][n]; psi = primitive 2n-th root; forward negacyclic */
void ntt_fwd_u64(uint64_t *x, int64_t batch, int64_t n, uint64_t q, uint64_t psi) {
    uint64_t omega = mulmod(psi, psi, q);
    uint64_t *pp = (uint64_t *)malloc((size_t)n * sizeof(uint64_t));
    pp[0] = 1;
    for (int64_t j = 1; j < n; j++) pp[j] = mulmod(pp[j - 1], psi, q);
    for (int64_t b = 0; b < batch; b++) {
        uint64_t *row = x + b * n;
        for (int64_t j = 0; j < n; j++) row[j] = mulmod(row[j] % q, pp[j], q);
        cyclic_ntt(row, n, q, omega);
    }
    free(pp);
}

void ntt_inv_u64(uint64_t *x, int64_t batch, int64_t n, uint64_t q, uint64_t psi) {
    uint64_t omega_inv = powmod(mulmod(psi, psi, q), q - 2, q);
    uint64_t psi_inv = powmod(psi, q - 2, q);
    uint64_t n_inv = powmod((uint64_t)n % q, q - 2, q);
    uint64_t *pp = (uint64_t *)malloc((size_t)n * sizeof(uint64_t));
    pp[0] = n_inv;
    for (int64_t j = 1; j < n; j++) pp[j] = mulmod(pp[j - 1], psi_inv, q);
    for (int64_t b = 0; b < batch; b++) {
        uint64_t *row = x + b * n;
        for (int64_t j = 0; j < n; j++) row[j] %= q;
        cyclic_ntt(row, n, q, omega_inv);
        for (int64_t j = 0; j < n; j++) row[j] = mulmod(row[j], pp[j], q);
    }
    free(pp);
}
