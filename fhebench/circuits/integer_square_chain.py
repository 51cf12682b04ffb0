"""BGV or BFV squarings (the mix's `scheme`): each request squares a fresh
top-level ciphertext `depth` times with the scheme's ct_mul (BGV: tensor,
relinearisation, ModSwitch; BFV: the auxiliary-basis tensor and
relinearisation, level kept). Keys: the scheme's keygen (secret, public and
relinearisation keys). Judged: every plaintext coefficient of the checked
requests against m(X)^(2^depth) mod (X^N + 1, t), exactly, the output
level, and for BGV the message factor the ciphertext carries."""

from __future__ import annotations

import numpy as np

from fhebench import inputs, port
from fhebench.reference import integer as ref
from fhebench.reference import secret_key
from fhebench.work import behz_aux_limbs, bfv_square_chain, bgv_square_chain


def out_level(cfg: dict, mix: dict) -> int:
    top = len(cfg["q_primes"])
    return top - mix["depth"] if mix["scheme"] == "bgv" else top


class Circuit:
    def __init__(self, cfg: dict, cell: dict, mix: dict, seed: int, device: str):
        from gpufhe_tpu_torch.ciphertext import bfv, bgv
        from gpufhe_tpu_torch.ops.context import make_context

        self.mod = {"bgv": bgv, "bfv": bfv}[mix["scheme"]]
        self.params = params = port.params_of(cfg)
        self.ctx = ctx = make_context(params, device=device)
        chest = self.mod.keygen(params, inputs.stream(seed, "keys"), ctx=ctx)
        self.rlk = chest.device_rlk
        enc = inputs.stream(seed, "encrypt")
        self.pool = [self.mod.encrypt(m, params, chest.device_pk, ctx, enc)
                     for m in inputs.messages(mix, params.n, params.plain_modulus, seed)]
        self.depth = mix["depth"]

    def request(self, ct):
        for _ in range(self.depth):
            ct = self.mod.ct_mul(ct, ct, self.params, self.ctx, self.rlk)
        return ct

    @staticmethod
    def export(out) -> dict:
        return {"c0": out.c[0].cpu().numpy(), "c1": out.c[1].cpu().numpy(),
                "level": out.level, "components": len(out.c),
                "pt_factor": getattr(out, "pt_factor", None)}


def expected(cfg: dict, mix: dict, seed: int, idx: list, device) -> dict:
    """The plaintext each pool index should give, {index: int64[N]}."""
    msgs = inputs.messages(mix, cfg["n"], cfg["plain_modulus"], seed)
    return {i: ref.power_poly(msgs[i], cfg["plain_modulus"], mix["depth"], device=device)
            for i in set(idx)}


def judge(cfg: dict, cell: dict, mix: dict, seed: int, samples: list, device) -> list:
    """[(name, value, limit)] over the checked requests [(pool index, export)]."""
    n, t, top = cfg["n"], cfg["plain_modulus"], len(cfg["q_primes"])
    s = secret_key(inputs.stream(seed, "keys"), n)
    want = expected(cfg, mix, seed, [i for i, _ in samples], device)
    lvl = out_level(cfg, mix)
    factor = ref.bgv_factor(cfg["q_primes"], t, top, mix["depth"])
    wrong, bad_level, bad_factor = 0, 0, 0
    for idx, out in samples:
        if out["level"] != lvl or out["components"] != 2:
            bad_level += 1
            continue
        primes = cfg["q_primes"][:lvl]
        if mix["scheme"] == "bfv":
            got = ref.bfv_decrypt(out["c0"], out["c1"], s, primes, t, device)
        else:
            bad_factor += int(out["pt_factor"] != factor)
            got = ref.bgv_decrypt(out["c0"], out["c1"], s, primes, t, factor, device)
        wrong += int(np.count_nonzero(got != want[idx]))
    checked = [("wrong_coeffs", wrong, 0), ("bad_level", bad_level, 0)]
    if mix["scheme"] == "bgv":
        checked.append(("bad_factor", bad_factor, 0))
    return checked


def work(cfg: dict, cell: dict, mix: dict):
    n, top, alpha = cfg["n"], len(cfg["q_primes"]), len(cfg["p_primes"])
    if mix["scheme"] == "bgv":
        return bgv_square_chain(n, top, alpha, mix["depth"])
    q_bits = sum(np.log2(float(q)) for q in cfg["q_primes"])
    aux = behz_aux_limbs(cfg["plain_modulus"], n, top, q_bits)
    return bfv_square_chain(n, top, alpha, aux, mix["depth"])
