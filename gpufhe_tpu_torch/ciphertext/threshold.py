"""Threshold (multiparty) FHE: additive key shares, joint public key,
partial decryption with smudging noise.

N-of-N additive threshold on top of any of the three schemes: each party i
holds a ternary share s_i, the joint secret is s = sum_i s_i and is never
materialized. Keygen is the standard one-round protocol — a common uniform
`a` (from a public seed), each party publishes b_i = -a*s_i + e_i (e_i
scaled by t for BGV), and the joint public key is (sum_i b_i, a). Anything
encrypted under it supports the full LINEAR homomorphic surface plus
plaintext multiplies; ciphertext-ciphertext multiplies need an interactive
relinearization protocol and are out of scope here (the classic deployment
— secure aggregation of many parties' contributions — is linear).

Decryption is distributed: party i publishes p_i = c1 * s_i + e_smudge,i
(BGV smudges with t*e, CKKS/BFV with plain e), and any aggregator computes
m from c0 + sum_i p_i. No strict subset of parties learns the message:
until the last share arrives the sum is masked by the missing a*s_j term.
Smudging must be SIZED for statistical security (>= 2^lambda_stat * the
ciphertext noise bound — see partial_decrypt's security note); the model is
honest-but-curious, and partial decryption must only be offered for
honestly-derived ciphertexts.

A copy of gpufhe_tpu/ciphertext/threshold.py. The protocol is host code
(numpy, golden/ckks.py's limb helpers), with the caller's numpy Generators
drawn in the reference's order, so every share, key and partial equals the
reference's; keys come out as the port's KSKey and PublicKey (int64 tensors
on the host), ready for keys.upload_ks_key / upload_public_key. Ciphertexts
may be the port's (tensors on any device) or numpy limbs. The aggregator's
partial decryption also runs on the card (partial_decrypt_device), equal to
the host one limb for limb.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.golden.bfv import round_decode_coeff
from gpufhe_tpu_torch.keys.keys import _mont_np, default_context
from gpufhe_tpu_torch.ops.context import Context
from gpufhe_tpu_torch.ops.modops import add_mod, mont_mul
from gpufhe_tpu_torch.params.params import CKKSParams


def _tensor(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int64))


@dataclasses.dataclass
class PartyShare:
    """One party's secret share + its public keygen contribution."""

    s: np.ndarray  # signed ternary int64[N] (hold private)
    b: np.ndarray  # int64[L, N] NTT domain: -a*s + (t*)e  (publish)


def common_a(params: CKKSParams, seed: int) -> np.ndarray:
    """The CRS: uniform `a` over the q-chain from a public seed."""
    return gckks.sample_uniform(
        np.random.default_rng(seed), params.q_primes, params.n
    )


def party_keygen(
    params: CKKSParams, a: np.ndarray, rng: np.random.Generator
) -> PartyShare:
    primes = params.q_primes
    t = params.plain_modulus
    s = gckks.sample_ternary(rng, params.n)
    s_ntt = gckks.ntt_limbs(gckks.small_to_rns(s, primes), params, primes)
    e = gckks.sample_gauss(rng, params.n, params.sigma)
    if t:  # BGV noise convention: errors ride on t*e
        e = t * e
    e_ntt = gckks.ntt_limbs(gckks.small_to_rns(e, primes), params, primes)
    b = gckks.poly_add(
        gckks.poly_mul(
            gckks.poly_sub(np.zeros_like(a), a, primes), s_ntt, primes
        ),
        e_ntt, primes,
    )
    return PartyShare(s=s, b=b)


def aggregate_public_key(params: CKKSParams, a: np.ndarray, bs: list) -> gckks.PublicKey:
    """Joint pk = (sum_i b_i, a): valid under s = sum_i s_i."""
    primes = params.q_primes
    acc = bs[0]
    for b in bs[1:]:
        acc = gckks.poly_add(acc, b, primes)
    return gckks.PublicKey(b=_tensor(acc), a=_tensor(a))


# ---------------------------------------------------------------------------
# Interactive relinearization-key generation (two rounds)
#
# The Mouchet et al. multiparty-HE pattern: with common uniform gadget rows
# a_d (CRS) and joint secret s = sum s_i, the parties produce
# rlk = (b_d, h1_d) with  b_d + h1_d * s = s^2 g_d + noise  — a drop-in
# gckks.KSKey, so the ordinary single-chip relinearization then works on
# jointly-encrypted ciphertexts. Round 1 publishes
#   h0_i = -u_i a + s_i g + e0_i,   h1_i = s_i a + e1_i
# (u_i an ephemeral ternary secret); round 2, on the aggregated h0/h1,
#   h0'_i = s_i h0 + e2_i,          h1'_i = (u_i - s_i) h1 + e3_i
# and b = sum h0' + sum h1'. BGV scales every error by t.
# ---------------------------------------------------------------------------


def rkg_common_a(params: CKKSParams, seed: int) -> np.ndarray:
    """CRS gadget rows: uniform int64[dnum, L+alpha, N] over the QP chain."""
    qp = params.q_primes + params.p_primes
    rng = np.random.default_rng(seed)
    return np.stack(
        [gckks.sample_uniform(rng, qp, params.n) for _ in range(params.dnum)]
    )


def _t_gauss(params, rng):
    e = gckks.sample_gauss(rng, params.n, params.sigma)
    return params.plain_modulus * e if params.plain_modulus else e


def _small_ntt(x, params, qp):
    return gckks.ntt_limbs(gckks.small_to_rns(x, qp), params, qp)


def rkg_round1(
    params: CKKSParams, a_rows: np.ndarray, share: PartyShare,
    rng: np.random.Generator,
):
    """-> (u_i ephemeral secret [keep private], h0_i, h1_i [publish])."""
    qp = params.q_primes + params.p_primes
    u = gckks.sample_ternary(rng, params.n)
    u_ntt = _small_ntt(u, params, qp)
    s_ntt = _small_ntt(share.s, params, qp)
    factors = gckks.gadget_factors(params)
    h0, h1 = [], []
    for d, a in enumerate(a_rows):
        g_rns = np.array([factors[d] % q for q in qp], dtype=np.int64)[:, None]
        e0 = _small_ntt(_t_gauss(params, rng), params, qp)
        e1 = _small_ntt(_t_gauss(params, rng), params, qp)
        q_col = np.array(qp, dtype=object)[:, None]
        h0.append(np.asarray(
            (-(a.astype(object)) * u_ntt + g_rns * s_ntt + e0) % q_col
        ).astype(np.int64))
        h1.append(np.asarray(
            (a.astype(object) * s_ntt + e1) % q_col
        ).astype(np.int64))
    return u, np.stack(h0), np.stack(h1)


def rkg_round2(
    params: CKKSParams, share: PartyShare, u: np.ndarray,
    h0_agg: np.ndarray, h1_agg: np.ndarray, rng: np.random.Generator,
):
    """-> (h0'_i, h1'_i) on the round-1 aggregates (publish)."""
    qp = params.q_primes + params.p_primes
    s_ntt = _small_ntt(share.s, params, qp)
    us_ntt = _small_ntt(u - share.s, params, qp)
    q_col = np.array(qp, dtype=object)[:, None]
    h0p, h1p = [], []
    for d in range(h0_agg.shape[0]):
        e2 = _small_ntt(_t_gauss(params, rng), params, qp)
        e3 = _small_ntt(_t_gauss(params, rng), params, qp)
        h0p.append(np.asarray(
            (h0_agg[d].astype(object) * s_ntt + e2) % q_col
        ).astype(np.int64))
        h1p.append(np.asarray(
            (h1_agg[d].astype(object) * us_ntt + e3) % q_col
        ).astype(np.int64))
    return np.stack(h0p), np.stack(h1p)


def rkg_aggregate_round1(params, h0_list, h1_list):
    qp = np.array(params.q_primes + params.p_primes, dtype=np.int64)[None, :, None]
    h0 = np.sum(np.stack(h0_list, axis=0), axis=0) % qp
    h1 = np.sum(np.stack(h1_list, axis=0), axis=0) % qp
    return h0, h1


def rkg_finalize(params, h0p_list, h1p_list, h1_agg) -> gckks.KSKey:
    """rlk = (sum h0' + sum h1', h1): a drop-in gckks.KSKey."""
    qp = np.array(params.q_primes + params.p_primes, dtype=np.int64)[None, :, None]
    b = (
        np.sum(np.stack(h0p_list, axis=0), axis=0)
        + np.sum(np.stack(h1p_list, axis=0), axis=0)
    ) % qp
    return gckks.KSKey(b=_tensor(b), a=_tensor(h1_agg))


def collaborative_relin_key(
    params: CKKSParams, shares: list, seed: int = 0
) -> gckks.KSKey:
    """Run the whole two-round protocol in-process (testing / trusted
    orchestration; production would exchange the h* messages)."""
    a_rows = rkg_common_a(params, seed)
    r1 = [
        rkg_round1(params, a_rows, sh, np.random.default_rng(1000 + i))
        for i, sh in enumerate(shares)
    ]
    h0_agg, h1_agg = rkg_aggregate_round1(
        params, [x[1] for x in r1], [x[2] for x in r1]
    )
    r2 = [
        rkg_round2(params, sh, r1[i][0], h0_agg, h1_agg,
                   np.random.default_rng(2000 + i))
        for i, sh in enumerate(shares)
    ]
    return rkg_finalize(params, [x[0] for x in r2], [x[1] for x in r2], h1_agg)


# ---------------------------------------------------------------------------
# Collaborative Galois keys (ONE round): each party can evaluate the
# automorphism on its own share, so with common gadget rows a_d the shares
#   hg_i,d = -a_d s_i + sigma(s_i) g_d + e_i,d
# aggregate directly to a valid rotation key for the joint secret.
# ---------------------------------------------------------------------------


def gkg_share(
    params: CKKSParams, a_rows: np.ndarray, share: PartyShare, steps: int,
    rng: np.random.Generator,
) -> np.ndarray:
    qp = params.q_primes + params.p_primes
    g_exp = gckks.galois_exponent(steps, params.n)
    s_ntt = _small_ntt(share.s, params, qp)
    sg_ntt = _small_ntt(
        gckks.apply_automorphism_coeff(share.s, g_exp), params, qp
    )
    factors = gckks.gadget_factors(params)
    q_col = np.array(qp, dtype=object)[:, None]
    rows = []
    for d, a in enumerate(a_rows):
        g_rns = np.array([factors[d] % q for q in qp], dtype=np.int64)[:, None]
        e = _small_ntt(_t_gauss(params, rng), params, qp)
        rows.append(np.asarray(
            (-(a.astype(object)) * s_ntt + g_rns * sg_ntt + e) % q_col
        ).astype(np.int64))
    return np.stack(rows)


def gkg_finalize(params, a_rows: np.ndarray, hg_list: list) -> gckks.KSKey:
    qp = np.array(params.q_primes + params.p_primes, dtype=np.int64)[None, :, None]
    b = np.sum(np.stack(hg_list, axis=0), axis=0) % qp
    return gckks.KSKey(b=_tensor(b), a=_tensor(a_rows))


def collaborative_galois_key(
    params: CKKSParams, shares: list, steps: int, seed: int = 0
) -> gckks.KSKey:
    a_rows = rkg_common_a(params, seed)
    hg = [
        gkg_share(params, a_rows, sh, steps, np.random.default_rng(3000 + i))
        for i, sh in enumerate(shares)
    ]
    return gkg_finalize(params, a_rows, hg)


# ---------------------------------------------------------------------------
# Distributed decryption
# ---------------------------------------------------------------------------


def partial_decrypt(
    ct, params: CKKSParams, share: PartyShare, rng: np.random.Generator,
    smudge_sigma: float = 16.0,
) -> np.ndarray:
    """p_i = c1 * s_i + e_smudge (NTT domain, int64[K, N]). ct must be a
    2-component ciphertext (relinearized / linear pipeline).

    SECURITY (honest-but-curious model): the smudging noise must flood the
    share's contribution. The statistical-security requirement is
    smudge_sigma >= 2^lambda_stat * B_ct (B_ct the ciphertext noise bound),
    which trades precision (CKKS) / budget (BGV/BFV) for privacy — size it
    per deployment; the small default only exercises the protocol shape.
    Parties must also only respond for ciphertexts from the agreed pipeline:
    a malicious aggregator submitting a crafted c1 (e.g. a constant
    polynomial) turns a lightly-smudged partial into a linear read of s_i.
    Production deployments gate partial decryption on transcript validation
    or ZK proofs of ciphertext provenance; that machinery is out of scope
    here."""
    assert len(ct.c) == 2
    primes = params.q_primes[: ct.level]
    t = params.plain_modulus
    s_ntt = gckks.ntt_limbs(
        gckks.small_to_rns(share.s, primes), params, primes
    )
    e = gckks.sample_gauss(rng, params.n, smudge_sigma)
    if t:
        e = t * e
    e_ntt = gckks.ntt_limbs(gckks.small_to_rns(e, primes), params, primes)
    return gckks.poly_add(
        gckks.poly_mul(gckks.host_limbs(ct.c[1]), s_ntt, primes), e_ntt, primes
    )


def combine_partials(ct, params: CKKSParams, partials: list) -> np.ndarray:
    """c0 + sum_i p_i -> plaintext coefficients (coefficient domain int64).

    Interpret per scheme: CKKS -> golden decode(., ct.scale); BGV ->
    centered mod t (times pt_factor); BFV -> round(t x / Q) mod t."""
    primes = params.q_primes[: ct.level]
    acc = gckks.host_limbs(ct.c[0])
    for p in partials:
        acc = gckks.poly_add(acc, gckks.host_limbs(p), primes)
    return gckks.intt_limbs(acc, params, primes)


def decrypt_ckks(ct, params, partials) -> np.ndarray:
    coeff = combine_partials(ct, params, partials)
    return gckks.decode(coeff, ct.scale, params.q_primes[: ct.level], params.n)


def decrypt_bgv(ct, params, partials) -> np.ndarray:
    t = params.plain_modulus
    coeff = combine_partials(ct, params, partials)
    centered = gckks.crt_compose_centered(coeff, params.q_primes[: ct.level])
    return (centered % t * ct.pt_factor % t).astype(np.int64)


def decrypt_bfv(ct, params, partials) -> np.ndarray:
    primes = params.q_primes[: ct.level]
    coeff = combine_partials(ct, params, partials)
    centered = gckks.crt_compose_centered(coeff, primes)
    return round_decode_coeff(centered, params.plain_modulus, math.prod(primes))


# ---------------------------------------------------------------------------
# Device partials: the aggregator-side hot path
# ---------------------------------------------------------------------------


def _partial_core(c1, s_mont, e_ntt, ctx: Context, level: int) -> torch.Tensor:
    rows = range(level)
    q = ctx.col("q", rows)
    return add_mod(mont_mul(c1, s_mont[:level], q, ctx.col("qinv_neg", rows)), e_ntt, q)


def partial_decrypt_device(
    ct, params: CKKSParams, ctx, s_mont, share: PartyShare,
    rng: np.random.Generator, smudge_sigma: float = 16.0,
):
    """Device mirror of partial_decrypt (the same smudge draw, the same
    limbs): c1 * s_i + NTT(e) on ctx's device, the smudge's NTT there too."""
    primes = params.q_primes[: ct.level]
    t = params.plain_modulus
    e = gckks.sample_gauss(rng, params.n, smudge_sigma)
    if t:
        e = t * e
    e_ntt = gckks.ntt_small(e, primes, ctx)
    return _partial_core(ct.c[1], s_mont, e_ntt, ctx, ct.level)


def upload_share(share: PartyShare, params: CKKSParams, *, ctx: Context | None = None):
    """Montgomery NTT-domain device mirror of the share (q-chain only), on
    ctx's device (the parameters' context on the card by default)."""
    ctx = default_context(params, ctx)
    primes = params.q_primes
    s_ntt = gckks.ntt_limbs(gckks.small_to_rns(share.s, primes), params, primes)
    return _mont_np(s_ntt, primes).to(ctx.device)
