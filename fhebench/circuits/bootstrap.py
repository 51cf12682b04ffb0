"""CKKS bootstrap: each request refreshes one exhausted ciphertext with the
library's Bootstrapper (encapsulation switch, ModRaise, CoeffToSlot,
EvalMod, SlotToCoeff, normalisation to Delta), as the cell file's
`bootstrap` parameters set it up. Keys: device_keygen of every rotation the
factored transforms use and the conjugation key (and the encapsulation
keys the configuration states), each Galois key truncated to the highest
level it is used at. Judged: every slot of the checked requests against
its message, and the output level the cell states."""

from __future__ import annotations

from fhebench import inputs, port
from fhebench.reference import ckks as ref
from fhebench.reference import secret_key
from fhebench.work.bootstrap import bootstrap as bootstrap_work


def in_level(cfg: dict, mix: dict) -> int:
    return len(cfg["q_primes"]) if mix["in_level"] == "top" else cfg["scale_words"]


class Circuit:
    def __init__(self, cfg: dict, cell: dict, mix: dict, seed: int, device: str):
        from gpufhe_tpu_torch.ciphertext import ct as dct
        from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
        from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
        from gpufhe_tpu_torch.encoding import encoder
        from gpufhe_tpu_torch.keys.device_keygen import device_keygen
        from gpufhe_tpu_torch.keys.keys import truncate_galois_device
        from gpufhe_tpu_torch.ops.context import make_context

        b = cell["bootstrap"]
        self.params = params = port.params_of(cfg)
        self.ctx = ctx = make_context(params, device=device)
        rots = bootstrap_rotations(params, transform=b["transform"], radix_log=b["radix_log"])
        chest = device_keygen(params, inputs.stream(seed, "keys"), rotations=tuple(rots),
                              conjugation=True, ctx=ctx)
        self.bs = Bootstrapper(DeviceBackend(params, ctx, chest), transform=b["transform"],
                               radix_log=b["radix_log"], evalmod=b["evalmod"],
                               k_bound=b["k_bound"], cheb_baby_log=b["cheb_baby_log"],
                               fuse_evalmod=True, lean_keys=b["lean_keys"])
        steps, conj_level = self.bs.galois_step_levels()
        truncate_galois_device(chest, steps, conj_level, params)
        enc = inputs.stream(seed, "encrypt")
        self.pool = [dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx, enc,
                                 params.scale, level=in_level(cfg, mix))
                     for z in inputs.messages(mix, params.n, 0, seed)]

    def request(self, ct):
        return self.bs(ct)

    def request_marked(self, ct, mark):
        """The request with mark(phase) called as each phase's outputs are
        produced: mod_raise, coeff_to_slot, evalmod, slot_to_coeff."""
        return self.bs(ct, _phase=lambda name, outs: mark(name))

    @staticmethod
    def export(out) -> dict:
        return {"c0": out.c[0].cpu().numpy(), "c1": out.c[1].cpu().numpy(),
                "level": out.level, "components": len(out.c)}


def judge(cfg: dict, cell: dict, mix: dict, seed: int, samples: list, device) -> list:
    """[(name, value, limit)] over the checked requests [(pool index, export)]."""
    n = cfg["n"]
    s = secret_key(inputs.stream(seed, "keys"), n)
    msgs = inputs.messages(mix, n, 0, seed)
    lvl, scale = cell["out_level"], 2.0 ** cfg["scale_bits"]
    err, bad = 0.0, 0
    for idx, out in samples:
        if out["level"] != lvl or out["components"] != 2:
            bad += 1
            continue
        got = ref.decrypt_decode(out["c0"], out["c1"], s, cfg["q_primes"][:lvl], scale, device)
        err = max(err, ref.max_gap(got, msgs[idx]))
    return [("max_err", err, cell["limits"]["max_err"]), ("bad_level", bad, 0)]


def work(cfg: dict, cell: dict, mix: dict):
    b = cell["bootstrap"]
    return bootstrap_work(cfg["n"], len(cfg["q_primes"]), len(cfg["p_primes"]),
                          cfg["scale_words"], in_level(cfg, mix), cell["out_level"],
                          b["radix_log"], b["cheb_degree"], b["cheb_baby_log"],
                          cfg["eph_hamming_weight"] > 0)
