"""One step of encrypted logistic-regression training (iDASH 2017 Track 3)
through the library's model, `EncryptedLogRegTrainer.step` on its
`DeviceBackend`: 2f + 2 multiplies and f SlotSums of log2(slots) hoisted
rotations, f the features.

Set-up: the data drawn from the seed's message stream in the traffic's
shape (reference/logreg.py); the feature columns and the labels encrypted
at the top level, one sample a slot; `prepare` once (each column times
the sample mask, one level); the keys: the relinearisation key and one Galois
key per power-of-two rotation. The pool holds the weight sets of one leg
of steps without a refresh: set k is the plain reference's weights after k
steps from 0, each weight broadcast to every slot and encrypted at the top
level less k steps' levels. A request is one step on the next set, inside
a span that names its entry's Galois work against the pool's
(`GALOIS_NORM`, read by metrics/galois.ms_per_req.py).

Judged: the step's update, each output weight less its entry weight, both
decoded at the deployment's scale Delta = 2^scale_bits (a request whose
weights the library leaves at another scale is refused while it runs),
against the update the plain reference makes in float64 from the values the
step's inputs hold: the entry weights, feature columns and labels as they
decrypt, slot by slot. So the inputs' fresh-encryption noise, which the step
passes on, is no part of the reading, and the step's own arithmetic is:
in every slot (`max_err`) and as the mean over a weight's slots
(`mean_err`, where the last rescale's rounding in each slot averages out);
and each output's level (the entry's less one step's) and size.
"""

from __future__ import annotations

import numpy as np

from fhebench import inputs, port
from fhebench.reference import ckks as ref_ckks
from fhebench.reference import logreg as ref
from fhebench.reference import secret_key
from fhebench.work import logreg as work_logreg

# the leading limbs of each output and entry the check keeps: a fixed size
# whatever the request's level, so that which requests the sample keeps
# moves no allocation; reference/logreg.py limbs_needed says how many it reads
KEEP_LIMBS = 3
LEVELS_PER_STEP = 5  # multiplicative depth of a step, in scale words
# the span around each request: "<GALOIS_NORM>=<the pool's mean Galois time
# over this entry's>", where a step's rotations at level l take time in
# proportion to l + GALOIS_LIMB_OFFSET: on an H100 the 270 `galois` spans of
# a step read 100.9, 85.0, 68.9, 51.6 and 37.5 ms at levels 26, 21, 16, 11
# and 6 (both operands' limbs and a share of the special primes' work)
GALOIS_NORM = "fhebench.galois_norm"
GALOIS_LIMB_OFFSET = 5.7


def step_levels(cfg: dict) -> int:
    return LEVELS_PER_STEP * cfg["scale_words"]


def entry_levels(cfg: dict, mix: dict) -> list[int]:
    top = len(cfg["q_primes"]) if mix["in_level"] == "top" else int(mix["in_level"])
    return [top - k * step_levels(cfg) for k in range(mix["pool"])]


def rotations(cfg: dict) -> int:
    return (cfg["n"] // 2).bit_length() - 1


def data(mix: dict, seed: int) -> tuple:
    return ref.dataset(inputs.stream(seed, "messages"), mix["samples"], mix["features"])


class Weights:
    """A step's output and its entry as one object: `c` lists the leading
    KEEP_LIMBS limbs of each output weight's components, weight by weight,
    then of each entry weight's two; `inputs` those of the feature columns
    and the labels."""

    def __init__(self, cts: list, entry: list, inputs: list):
        self.c = [comp[:KEEP_LIMBS] for ct in (*cts, *entry) for comp in ct.c]
        self.inputs = inputs  # the set-up's, which no request changes
        self.components = [len(ct.c) for ct in cts]
        self.levels = [ct.level for ct in cts]
        self.scales = [float(ct.scale) for ct in cts]


class Circuit:
    def __init__(self, cfg: dict, cell: dict, mix: dict, seed: int, device: str):
        from gpufhe_tpu_torch.ciphertext import ct as dct
        from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
        from gpufhe_tpu_torch.encoding import encoder
        from gpufhe_tpu_torch.keys.device_keygen import device_keygen
        from gpufhe_tpu_torch.models.logreg_train import (EncryptedLogRegTrainer,
                                                          train_rotations)
        from gpufhe_tpu_torch.ops.context import make_context
        from gpufhe_tpu_torch.utils.profiling import stage

        params = port.params_of(cfg)
        self.scale = params.scale
        ctx = make_context(params, device=device)
        chest = device_keygen(params, inputs.stream(seed, "keys"),
                              rotations=tuple(train_rotations(params.slots)), ctx=ctx)
        self.trainer = tr = EncryptedLogRegTrainer(DeviceBackend(params, ctx, chest),
                                                   mix["samples"], lr=mix["lr"])
        enc = inputs.stream(seed, "encrypt")

        def encrypt(z, level):
            return dct.encrypt(encoder.encode(np.asarray(z, np.complex128), params), params,
                               chest.device_pk, ctx, enc, params.scale, level=level)

        x, y = data(mix, seed)
        levels = entry_levels(cfg, mix)
        self.x = [encrypt(tr.slot_vec(x[:, j]), levels[0]) for j in range(x.shape[1])]
        self.y = encrypt(tr.slot_vec(y), levels[0])
        self.xm = tr.prepare(self.x)
        self.inputs = [comp[:KEEP_LIMBS] for ct in (*self.x, self.y) for comp in ct.c]
        ws = ref.leg(x, y, mix["lr"], mix["pool"] - 1)
        self.pool = [[encrypt(np.full(params.slots, wj), level) for wj in w]
                     for w, level in zip(ws, levels)]
        cost = [level - 4 * cfg["scale_words"] + GALOIS_LIMB_OFFSET for level in levels]
        self.stage = stage
        self.span = {id(entry): f"{GALOIS_NORM}={float(np.mean(cost) / c)!r}"
                     for entry, c in zip(self.pool, cost)}
        for entry in self.pool:  # each level's plaintext constants, encoded once
            self.request(entry)

    def request(self, ws):
        with self.stage(self.span[id(ws)]):
            out = Weights(self.trainer.step(ws, self.x, self.xm, self.y), ws, self.inputs)
        if any(abs(s / self.scale - 1.0) > 1e-9 for s in out.scales):
            raise ValueError(f"the training step left weights at scale {out.scales[0]!r}, not "
                             f"the deployment's {self.scale!r}, at which the check decodes")
        return out

    @staticmethod
    def export(out) -> dict:
        comps, k = [], 0
        for size in out.components:
            comps.append([t.cpu().numpy() for t in out.c[k:k + size]])
            k += size
        entry = [t.cpu().numpy() for t in out.c[k:]]
        inputs = [t.cpu().numpy() for t in out.inputs]
        return {"comps": comps, "levels": list(out.levels),
                "entry": list(zip(entry[0::2], entry[1::2])),
                "inputs": list(zip(inputs[0::2], inputs[1::2]))}


def judge(cfg: dict, cell: dict, mix: dict, seed: int, samples: list, device) -> list:
    """[(name, value, limit)] over the checked requests [(pool index, export)]."""
    n, primes, scale = cfg["n"], cfg["q_primes"], 2.0 ** cfg["scale_bits"]
    s = secret_key(inputs.stream(seed, "keys"), n)
    x, y = data(mix, seed)
    ws = ref.leg(x, y, mix["lr"], mix["pool"])  # set k's step gives ws[k + 1]
    levels = entry_levels(cfg, mix)
    held, err, mean_err, bad = None, 0.0, 0.0, 0
    for idx, out in samples:
        lvl = levels[idx] - step_levels(cfg)
        if (len(out["comps"]) != len(ws[idx]) or any(len(c) != 2 for c in out["comps"])
                or any(level != lvl for level in out["levels"])):
            bad += 1
            continue
        bound = max(1.0, float(np.abs(ws[idx]).max() + np.abs(ws[idx + 1]).max()))
        k = ref.limbs_needed(primes, scale, bound)
        if k > min(KEEP_LIMBS, lvl):
            raise ValueError(f"the check needs {k} limbs of each output, it keeps "
                             f"{min(KEEP_LIMBS, lvl)}")

        def limbs(pairs):
            return [(c0[:k], c1[:k]) for c0, c1 in pairs]

        if held is None:  # the feature columns and the labels, as they decrypt
            held = np.stack(ref.decrypt_weights(limbs(out["inputs"]), scale, s, primes[:k],
                                                device))
        entry = np.stack(ref.decrypt_weights(limbs(out["entry"]), scale, s, primes[:k], device))
        want = ref.slot_update(entry, held[:-1], held[-1], mix["samples"], mix["lr"])
        got = ref.decrypt_updates(limbs(out["comps"]), limbs(out["entry"]), scale, s,
                                  primes[:k], device)
        for slots, uj in zip(got, want):
            err = max(err, ref_ckks.max_gap(slots, uj))
            mean_err = max(mean_err, float(abs(complex(np.mean(slots)) - uj)))
    lim = cell["limits"]
    return [("max_err", err, lim["max_err"]), ("mean_err", mean_err, lim["mean_err"]),
            ("bad_level", bad, 0)]


def work(cfg: dict, cell: dict, mix: dict):
    return work_logreg.logreg_pool(cfg["n"], entry_levels(cfg, mix), len(cfg["p_primes"]),
                                   cfg["scale_words"], mix["features"], rotations(cfg))
