"""One encrypted MNIST inference (SecureML's network A, 784-128-128-10 with
the square after each hidden layer) through the library's model,
`EncryptedMLP` on its `DeviceBackend`: each layer one BSGS product
(ciphertext/linalg.py BsgsPlan: hoisted baby rotations, a plaintext product
and an add per nonzero diagonal, a giant rotation per group, one rescale),
each hidden layer's square one `ct_mul_full`.

Set-up: the weights, then the images, from the seed's message stream
(reference/mlp.py draw); the keys: the relinearisation key and the Galois
keys of exactly the steps the network's products use (`mlp_rotations_for`);
the pool: one image a ciphertext, its pixels in the first slots, encrypted
at the top level; each layer's plan built once by one warm-up forward
(every entry is at the top level). A request is one forward, `model(ct)`.

Judged: the output against the forward the plain reference makes in
float64 from the input as it decrypts, so the fresh encryption's noise is
no part of the reading and the forward's own arithmetic is. The output is
decoded at the scale it carries, as a client reads it from the ciphertext
(the model carries its activations above Delta: models/mlp.py _lift_of; a
scale that does not match the message shows as a wrong value), over all
slots (`max_err`: the logits in the first, zeros in every other, so any
garbage a wrong rotation leaves shows) and over the logits alone
(`mean_err`); and each output's level and size (`bad_level`).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from fhebench import inputs, port
from fhebench.reference import ckks as ref_ckks
from fhebench.reference import logreg as ref_limbs
from fhebench.reference import mlp as ref
from fhebench.reference import secret_key
from fhebench.work import mlp as work_mlp

# the leading limbs of each output and input the check keeps: a fixed size
# whatever the output's level, so that which requests the sample keeps moves
# no allocation; reference/logreg.py limbs_needed says how many it reads
KEEP_LIMBS = 3


def top_level(cfg: dict, mix: dict) -> int:
    return len(cfg["q_primes"]) if mix["in_level"] == "top" else int(mix["in_level"])


def out_level(cfg: dict, mix: dict) -> int:
    layers = len(mix["layers"]) - 1
    return ref.out_level(top_level(cfg, mix), layers - 1, layers, cfg["scale_words"])


def data(mix: dict, seed: int) -> tuple:
    """(layers [(W, b)], images [pool, pixels])."""
    return ref.draw(inputs.stream(seed, "messages"), mix["layers"], mix["pool"])


class Logits:
    """A forward's output and its input as one object: `c` lists the leading
    KEEP_LIMBS limbs of the output's components, then of the input's two."""

    def __init__(self, out, entry):
        self.c = [comp[:KEEP_LIMBS] for ct in (out, entry) for comp in ct.c]
        self.components = len(out.c)
        self.level = out.level
        self.scale = float(out.scale)


class Circuit:
    def __init__(self, cfg: dict, cell: dict, mix: dict, seed: int, device: str):
        import torch

        from gpufhe_tpu_torch.ciphertext import ct as dct
        from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
        from gpufhe_tpu_torch.encoding import encoder
        from gpufhe_tpu_torch.keys.device_keygen import device_keygen
        from gpufhe_tpu_torch.models.mlp import EncryptedMLP, mlp_rotations_for
        from gpufhe_tpu_torch.ops.context import make_context

        if mix["activation"] != "square":
            raise ValueError(f"the circuit runs the square activation, not {mix['activation']!r}")
        sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
        params = port.params_of(cfg)
        ctx = make_context(params, device=device)
        layers, images = data(mix, seed)
        t0 = time.perf_counter()
        chest = device_keygen(params, inputs.stream(seed, "keys"),
                              rotations=tuple(mlp_rotations_for(layers, params.slots)), ctx=ctx)
        sync()
        t1 = time.perf_counter()
        self.model = EncryptedMLP(DeviceBackend(params, ctx, chest), layers)
        enc = inputs.stream(seed, "encrypt")
        level = top_level(cfg, mix)
        self.pool = []
        for x in images:
            z = np.zeros(params.slots, dtype=np.complex128)
            z[: x.size] = x
            self.pool.append(dct.encrypt(encoder.encode(z, params), params, chest.device_pk,
                                         ctx, enc, params.scale, level=level))
        sync()
        t2 = time.perf_counter()
        self.request(self.pool[0])  # each layer's plan, built once
        sync()
        # the factor the forward carried its activations by (models/mlp.py
        # _lift_of); a library without it leaves each baby rotation's ModDown
        # bias in the logits, off by up to 4e-2 at N = 2^15
        lift = self.model.lift
        print(f"mlp_forward: keys {t1 - t0:.3f} s ({len(chest.galois)} Galois keys), lift "
              f"{lift}, pool {t2 - t1:.3f} s, plans and the first forward "
              f"{time.perf_counter() - t2:.3f} s", file=sys.stderr, flush=True)

    def request(self, ct):
        return Logits(self.model(ct), ct)

    @staticmethod
    def export(out) -> dict:
        comps = [t.cpu().numpy() for t in out.c]
        k = out.components
        return {"comps": comps[:k], "level": out.level, "scale": out.scale,
                "entry": (comps[k], comps[k + 1])}


def judge(cfg: dict, cell: dict, mix: dict, seed: int, samples: list, device) -> list:
    """[(name, value, limit)] over the checked requests [(pool index, export)]."""
    n, primes, scale = cfg["n"], cfg["q_primes"], 2.0 ** cfg["scale_bits"]
    s = secret_key(inputs.stream(seed, "keys"), n)
    layers, _ = data(mix, seed)
    lvl = out_level(cfg, mix)
    k_in, logits = ref_limbs.limbs_needed(primes, scale, 1.0), len(layers[-1][1])
    err, mean_err, bad = 0.0, 0.0, 0
    for _, out in samples:
        if out["level"] != lvl or len(out["comps"]) != 2:
            bad += 1
            continue
        x = ref.decrypt([c[:k_in] for c in out["entry"]], s, primes[:k_in], scale, device)
        want = ref.expected(layers, x, n // 2)
        s_out = out["scale"]
        k = ref_limbs.limbs_needed(primes, s_out, float(np.abs(want).max()))
        if max(k, k_in) > min(KEEP_LIMBS, lvl):
            raise ValueError(f"the check needs {max(k, k_in)} limbs of each ciphertext, it "
                             f"keeps {min(KEEP_LIMBS, lvl)}")
        got = ref.decrypt([c[:k] for c in out["comps"]], s, primes[:k], s_out, device)
        err = max(err, ref_ckks.max_gap(got, want))
        mean_err = max(mean_err, ref_ckks.max_gap(got[:logits], want[:logits]))
    lim = cell["limits"]
    return [("max_err", err, lim["max_err"]), ("mean_err", mean_err, lim["mean_err"]),
            ("bad_level", bad, 0)]


def work(cfg: dict, cell: dict, mix: dict):
    return work_mlp.mlp_forward(cfg["n"], mix["layers"], top_level(cfg, mix),
                                len(cfg["p_primes"]), cfg["scale_words"])
