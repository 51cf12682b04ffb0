"""CKKS squarings: each request squares a fresh ciphertext `depth` times
with ct_mul_full (tensor, relinearisation, scale_words rescales). Keys: the
relinearisation key (and what device_keygen draws with it for the
configuration). Judged: every slot of the checked requests against
z^(2^depth) in float64, and the output level."""

from __future__ import annotations

from fhebench import inputs, port
from fhebench.reference import ckks as ref
from fhebench.reference import secret_key
from fhebench.work import ckks_square_chain


def in_level(cfg: dict, mix: dict) -> int:
    return len(cfg["q_primes"]) if mix["in_level"] == "top" else cfg["scale_words"]


def out_level(cfg: dict, mix: dict) -> int:
    return in_level(cfg, mix) - mix["depth"] * cfg["scale_words"]


class Circuit:
    def __init__(self, cfg: dict, cell: dict, mix: dict, seed: int, device: str):
        from gpufhe_tpu_torch.ciphertext import ct as dct
        from gpufhe_tpu_torch.encoding import encoder
        from gpufhe_tpu_torch.keys.device_keygen import device_keygen
        from gpufhe_tpu_torch.ops.context import make_context

        self.params = params = port.params_of(cfg)
        self.ctx = ctx = make_context(params, device=device)
        chest = device_keygen(params, inputs.stream(seed, "keys"), ctx=ctx)
        self.rlk = chest.device_rlk
        enc = inputs.stream(seed, "encrypt")
        self.pool = [dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx, enc,
                                 params.scale, level=in_level(cfg, mix))
                     for z in inputs.messages(mix, params.n, 0, seed)]
        self.depth = mix["depth"]
        self._mul = dct.ct_mul_full

    def request(self, ct):
        for _ in range(self.depth):
            ct = self._mul(ct, ct, self.params, self.ctx, self.rlk)
        return ct

    @staticmethod
    def export(out) -> dict:
        return {"c0": out.c[0].cpu().numpy(), "c1": out.c[1].cpu().numpy(),
                "level": out.level, "components": len(out.c)}


def judge(cfg: dict, cell: dict, mix: dict, seed: int, samples: list, device) -> list:
    """[(name, value, limit)] over the checked requests [(pool index, export)]."""
    n, w = cfg["n"], cfg["scale_words"]
    s = secret_key(inputs.stream(seed, "keys"), n)
    msgs = inputs.messages(mix, n, 0, seed)
    lvl = out_level(cfg, mix)
    scale = ref.squared_scale(2.0 ** cfg["scale_bits"], cfg["q_primes"], in_level(cfg, mix),
                              mix["depth"], w)
    err, bad = 0.0, 0
    for idx, out in samples:
        if out["level"] != lvl or out["components"] != 2:
            bad += 1
            continue
        got = ref.decrypt_decode(out["c0"], out["c1"], s, cfg["q_primes"][:lvl], scale, device)
        err = max(err, ref.max_gap(got, msgs[idx] ** (2 ** mix["depth"])))
    return [("max_err", err, cell["limits"]["max_err"]), ("bad_level", bad, 0)]


def work(cfg: dict, cell: dict, mix: dict):
    return ckks_square_chain(cfg["n"], in_level(cfg, mix), len(cfg["p_primes"]),
                             cfg["scale_words"], mix["depth"])
