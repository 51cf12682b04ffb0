"""Card-side key generation and the seeded, lean key chest.

Counterpart of gpufhe_tpu/keys/device_keygen.py, draw for draw: the small
polynomials (the secrets and every error) come from the numpy Generator on
the host, in the reference's order; every uniform `a` row comes from the
threefry generator (keys/prng.py, bit-exact with jax.random), keyed by a
63-bit seed drawn from that Generator, and is computed on the card with the
products and NTTs (kernel K1). So a seed gives the reference's device keys
limb for limb. Relation per gadget row d (as the golden make_kskey):

    b_d = -(a_d * s) + e_d + g_d * s_target     (NTT domain, over Q*P)

These keys are valid CKKS keys but not the golden keygen's (keys/keys.py):
the two draw `a` from different generators. Every output is in Montgomery
form (keys/keys.py conventions).

The chest records each key's threefry key (`seeds`), from which its `a`
rows are drawn again on demand: drop_galois_a releases the Galois and
conjugation keys' `a` halves (half of the chest's rotation keys) and
regen_galois_a replays them bit for bit (ciphertext/bootstrap.py lean_keys).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpufhe_tpu_torch.golden import ckks as gckks
from gpufhe_tpu_torch.keys import prng
from gpufhe_tpu_torch.keys.keys import (DeviceKSKey, DevicePublicKey, DeviceSecretKey,
                                        default_context)
from gpufhe_tpu_torch.ops.context import Context
from gpufhe_tpu_torch.ops.modops import add_mod, mont_mul, sub_mod, to_mont
from gpufhe_tpu_torch.ops.ntt import ntt_fwd
from gpufhe_tpu_torch.params.params import CKKSParams


@dataclasses.dataclass
class DeviceKeyChest:
    """The device keys of a workload, duck-type compatible with keys.KeyChest
    where the ops read it (device_*, galois_key, conj_key, eph); there are no
    canonical halves: galois, conj and eph hold (None, DeviceKSKey)."""

    params: CKKSParams
    sk: gckks.SecretKey  # host only
    device_sk: DeviceSecretKey
    device_pk: DevicePublicKey
    device_rlk: DeviceKSKey
    galois: dict  # steps -> (None, DeviceKSKey)
    conj: tuple | None  # (None, DeviceKSKey)
    eph: dict | None = None  # {"s_eph": int64[N], "to_eph": (None, key), "from_eph": ...}
    # name -> the threefry key (int64[2], u32 words) its uniform `a` rows are
    # drawn from: "pk", "rlk", "gk<steps>", "conj", "to_eph", "from_eph"
    seeds: dict | None = None

    def galois_key(self, steps: int) -> DeviceKSKey:
        key = self.galois[steps][1]
        if key.a_mont is None:
            raise RuntimeError(f"Galois key {steps} has its `a` dropped (drop_galois_a); "
                               "call regen_galois_a(ctx) before use")
        return key

    def conj_key(self) -> DeviceKSKey:
        if self.conj is None:
            raise KeyError("no conjugation key was generated")
        key = self.conj[1]
        if key.a_mont is None:
            raise RuntimeError("the conjugation key has its `a` dropped (drop_galois_a); "
                               "call regen_galois_a(ctx) before use")
        return key

    def drop_galois_a(self) -> int:
        """Release every Galois (and the conjugation) key's a_mont; returns how
        many. A caller that still holds a key keeps its tensor alive."""
        n = 0
        for steps, (g, key) in list(self.galois.items()):
            if key.a_mont is not None:
                self.galois[steps] = (g, DeviceKSKey(key.b_mont, None))
                n += 1
        if self.conj is not None and self.conj[1].a_mont is not None:
            self.conj = (self.conj[0], DeviceKSKey(self.conj[1].b_mont, None))
            n += 1
        return n

    def regen_galois_a(self, ctx: Context) -> int:
        """Draw the dropped a_mont again from the recorded seeds, with the rows
        each key is stored with (keys.truncate_galois_device's selection);
        returns how many. Bit-identical to the keys as drawn."""
        alpha = len(self.params.p_primes)
        full = self.params.num_limbs

        def regen(key: DeviceKSKey, name: str) -> DeviceKSKey:
            a = regen_ks_a(self.params, ctx, self.seeds[name])
            stored = key.b_mont.shape[1] - alpha
            if stored < full:
                rows = list(range(stored)) + list(range(full, full + alpha))
                a = a.index_select(1, ctx.index(rows))
            return DeviceKSKey(key.b_mont, a)

        n = 0
        for steps, (g, key) in list(self.galois.items()):
            if key.a_mont is None:
                self.galois[steps] = (g, regen(key, f"gk{steps}"))
                n += 1
        if self.conj is not None and self.conj[1].a_mont is None:
            self.conj = (self.conj[0], regen(self.conj[1], "conj"))
            n += 1
        return n


def _consts(ctx: Context, idx):
    return ctx.col("q", idx), ctx.col("qinv_neg", idx), ctx.col("r2", idx)


def _uniform_mod_q(key, ctx: Context, idx, n: int) -> torch.Tensor:
    """Uniform residues int64[len(idx), N] on the context's device: 64 random
    bits reduced mod q per limb, (hi * 2^32 + lo) mod q with hi * 2^32 as
    mont_mul(hi, 2^64 mod q). hi and lo lie anywhere in [0, 2^32): mont_mul
    takes any first operand below 2^32, and lo is reduced by a remainder
    (the reference's barrett_reduce_u32)."""
    q, qinv, r2 = _consts(ctx, idx)
    k1, k2 = prng.split(key)
    shape = (len(idx), n)
    hi = prng.bits_u32(k1, shape, ctx.device)
    lo = prng.bits_u32(k2, shape, ctx.device)
    return add_mod(mont_mul(hi, r2, q, qinv), torch.remainder(lo, q), q)


def _lift_signed(small: np.ndarray, ctx: Context, idx) -> torch.Tensor:
    """Small signed int64[N] -> canonical residues int64[L, N] on the device."""
    v = torch.from_numpy(np.asarray(small, dtype=np.int64)).to(ctx.device)[None, :]
    q = ctx.col("q", idx)
    return torch.where(v < 0, q + v, v)


def _ntt_mont(small: np.ndarray, ctx: Context, idx) -> torch.Tensor:
    """Signed small poly -> NTT domain, Montgomery form, on the device."""
    q, qinv, r2 = _consts(ctx, idx)
    return to_mont(ntt_fwd(_lift_signed(small, ctx, idx), ctx, limbs=idx), q, qinv, r2)


def _a_rows(ctx: Context, idx, n: int, key, rows: int):
    """The uniform `a` polynomials a key draws from its threefry key, in draw
    order, one at a time (each row's temporaries freed before the next).

    This split sequence is the seeded-key contract: regen_ks_a replays it
    from the recorded key, so changing it invalidates every recorded seed
    (threefry is device-independent: the card and the CPU draw the same
    rows)."""
    for _ in range(rows):
        key, sub = prng.split(key)
        yield _uniform_mod_q(sub, ctx, idx, n)


def regen_ks_a(params: CKKSParams, ctx: Context, key_data) -> torch.Tensor:
    """Montgomery-form a_mont[dnum, K, N] of a key-switch key from its seed."""
    idx = range(len(params.q_primes + params.p_primes))
    q, qinv, r2 = _consts(ctx, idx)
    rows = len(gckks.gadget_factors(params))
    out = torch.empty((rows, len(idx), params.n), dtype=torch.int64, device=ctx.device)
    for d, a in enumerate(_a_rows(ctx, idx, params.n, prng.wrap_key_data(key_data), rows)):
        out[d] = to_mont(a, q, qinv, r2)
    return out


def regen_pk_a(params: CKKSParams, ctx: Context, key_data) -> torch.Tensor:
    """Montgomery-form a_mont[L, N] of the public key from its seed."""
    idx = range(params.num_limbs)
    q, qinv, r2 = _consts(ctx, idx)
    (a,) = _a_rows(ctx, idx, params.n, prng.wrap_key_data(key_data), 1)
    return to_mont(a, q, qinv, r2)


def _make_ks_key(params: CKKSParams, ctx: Context, s_mont: torch.Tensor,
                 target_mont: torch.Tensor, rng: np.random.Generator, key) -> DeviceKSKey:
    """Gadget rows over the full Q+P chain, one row at a time: its uniform
    `a` (threefry), its error (rng), b, and both in Montgomery form."""
    qp = params.q_primes + params.p_primes
    idx = range(len(qp))
    q, qinv, r2 = _consts(ctx, idx)
    factors = gckks.gadget_factors(params)
    g_rns = torch.tensor([[g % p for p in qp] for g in factors], dtype=torch.int64)
    g_rns = g_rns.to(ctx.device)[:, :, None]
    shape = (len(factors), len(qp), params.n)
    b_mont = torch.empty(shape, dtype=torch.int64, device=ctx.device)
    a_mont = torch.empty(shape, dtype=torch.int64, device=ctx.device)
    for d, a in enumerate(_a_rows(ctx, idx, params.n, key, len(factors))):
        e_small = gckks.sample_gauss(rng, params.n, params.sigma)
        e_ntt = ntt_fwd(_lift_signed(e_small, ctx, idx), ctx, limbs=idx)
        a_s = mont_mul(a, s_mont, q, qinv)  # a * s, canonical
        g_t = mont_mul(g_rns[d], target_mont, q, qinv)  # g * s_target, canonical
        b_mont[d] = to_mont(add_mod(sub_mod(g_t, a_s, q), e_ntt, q), q, qinv, r2)
        a_mont[d] = to_mont(a, q, qinv, r2)
    return DeviceKSKey(b_mont=b_mont, a_mont=a_mont)


def device_keygen(params: CKKSParams, rng: np.random.Generator, rotations: tuple[int, ...] = (),
                  conjugation: bool = False, *, ctx: Context | None = None) -> DeviceKeyChest:
    """The seeded key chest, computed on the context's device (by default the
    card): the secret, the public key, the relinearisation key, one Galois
    key per step in the given order, the conjugation key, then the ephemeral
    sparse secret and its two switching keys when params.eph_hamming_weight
    > 0 (the reference's draw order on rng and on the threefry keys)."""
    ctx = default_context(params, ctx)
    n = params.n
    qp_idx = range(len(params.q_primes + params.p_primes))
    q_idx = range(params.num_limbs)
    q_l, qinv_l, r2_l = _consts(ctx, q_idx)

    if params.hamming_weight:
        s = gckks.sample_sparse_ternary(rng, n, params.hamming_weight)
    else:
        s = gckks.sample_ternary(rng, n)
    s_mont = _ntt_mont(s, ctx, qp_idx)
    q_full, qinv_full, _ = _consts(ctx, qp_idx)
    s2_mont = mont_mul(s_mont, s_mont, q_full, qinv_full)

    seeds: dict = {}
    key = prng.key(int(rng.integers(0, 2**63)))
    key, sub = prng.split(key)
    seeds["pk"] = prng.key_data(sub)
    (a,) = _a_rows(ctx, q_idx, n, sub, 1)
    e_small = gckks.sample_gauss(rng, n, params.sigma)
    e_ntt = ntt_fwd(_lift_signed(e_small, ctx, q_idx), ctx, limbs=q_idx)
    b = sub_mod(e_ntt, mont_mul(a, s_mont[: params.num_limbs], q_l, qinv_l), q_l)
    pk = DevicePublicKey(b_mont=to_mont(b, q_l, qinv_l, r2_l), a_mont=to_mont(a, q_l, qinv_l, r2_l))
    del a, b, e_ntt

    key, sub = prng.split(key)
    seeds["rlk"] = prng.key_data(sub)
    rlk = _make_ks_key(params, ctx, s_mont, s2_mont, rng, sub)
    del s2_mont

    def automorphism_key(g: int, name: str) -> tuple:
        nonlocal key
        sg_mont = _ntt_mont(gckks.apply_automorphism_coeff(s, g), ctx, qp_idx)
        key, sub = prng.split(key)
        seeds[name] = prng.key_data(sub)
        return None, _make_ks_key(params, ctx, s_mont, sg_mont, rng, sub)

    galois = {steps: automorphism_key(gckks.galois_exponent(steps, n), f"gk{steps}")
              for steps in rotations}
    conj = automorphism_key(2 * n - 1, "conj") if conjugation else None

    eph = None
    if params.eph_hamming_weight:
        s_eph = gckks.sample_sparse_ternary(rng, n, params.eph_hamming_weight)
        eph_mont = _ntt_mont(s_eph, ctx, qp_idx)
        key, k1 = prng.split(key)
        key, k2 = prng.split(key)
        seeds["to_eph"], seeds["from_eph"] = prng.key_data(k1), prng.key_data(k2)
        eph = {
            "s_eph": s_eph,
            # decrypts under s_eph what decrypted under s, and back
            "to_eph": (None, _make_ks_key(params, ctx, eph_mont, s_mont, rng, k1)),
            "from_eph": (None, _make_ks_key(params, ctx, s_mont, eph_mont, rng, k2)),
        }

    return DeviceKeyChest(
        params=params,
        sk=gckks.SecretKey(s),
        device_sk=DeviceSecretKey(s_mont=s_mont),
        device_pk=pk,
        device_rlk=rlk,
        galois=galois,
        conj=conj,
        eph=eph,
        seeds=seeds,
    )
