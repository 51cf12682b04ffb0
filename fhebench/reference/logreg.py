"""The plain reference for one step of encrypted logistic-regression
training (iDASH 2017 Track 3: training on encrypted genomic records): the
data in the competition's shape, drawn from a stream of the seed, and the
gradient-descent update in float64.

The update is written from its equations (Kim, Song, Kim, Lee and Cheon,
BMC Medical Genomics 11 (Suppl 4):83, 2018, with the two departures the
traffic file lists: plain gradient descent in place of Nesterov's method,
and the degree-3 Taylor sigmoid in place of a least-squares fit). With the
samples X (m x f), the labels y and the weights w:

    z  = X w
    p  = 1/2 + z/4 - z^3/48
    w' = w - (lr / m) X^T (p - y)

Nothing here comes from the library under test. The decryption is
`reference/ckks.py`'s, on the first limbs of each output: a message whose
coefficients lie below half their product decrypts there exactly as over
the whole chain (`limbs_needed`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fhebench.reference import ckks, ring

C1, C3 = 0.25, -1.0 / 48.0  # the Taylor sigmoid's odd coefficients around 0


def dataset(rng: np.random.Generator, samples: int, features: int) -> tuple:
    """(X, y) as float64: each feature column uniform in [0, 1] (the
    competition's min-max normalised columns), and labels
    y = 1[(X - mean X) beta + N(0, 1) > 0] with beta ~ N(0, I)."""
    x = rng.uniform(0.0, 1.0, size=(samples, features))
    beta = rng.normal(size=features)
    noise = rng.normal(size=samples)
    y = ((x - x.mean(axis=0)) @ beta + noise > 0).astype(np.float64)
    return x, y


def sigmoid3(z: torch.Tensor) -> torch.Tensor:
    return 0.5 + C1 * z + C3 * z**3


def step(w, x, y, lr: float) -> np.ndarray:
    """One gradient-descent update of w, in float64."""
    xt, yt, wt = (torch.as_tensor(np.asarray(v), dtype=torch.float64) for v in (x, y, w))
    z = xt @ wt
    return (wt - lr / xt.shape[0] * (xt.T @ (sigmoid3(z) - yt))).numpy()


def update(w, x, y, lr: float) -> np.ndarray:
    """The step's change of w, -(lr/m) X^T (p - y), in float64."""
    return step(w, x, y, lr) - np.asarray(w, np.float64)


def leg(x, y, lr: float, iters: int) -> list[np.ndarray]:
    """The weights w_0 = 0, w_1, ..., w_iters of `iters` updates."""
    ws = [np.zeros(x.shape[1])]
    for _ in range(iters):
        ws.append(step(ws[-1], x, y, lr))
    return ws


def max_abs_z(ws: list, x) -> float:
    """The widest |X w| over the given weights: the sigmoid's argument,
    which the Taylor polynomial follows on |z| <~ 4."""
    return max(float(np.abs(np.asarray(x) @ w).max()) for w in ws)


def limbs_needed(primes, scale: float, bound: float) -> int:
    """The fewest leading limbs whose product Q' holds every coefficient of a
    message of slots at most `bound` at `scale`, with 2^16 to spare for the
    noise: |m_k| = |(2/N) Re sum_j z_j zeta_j^-k| Delta <= Delta max|z_j|,
    so Delta (bound + 1) 2^16 < Q'/2 makes the centred residues mod Q' the
    coefficients themselves."""
    need = math.log2(scale * (bound + 1.0)) + 17.0
    bits = 0.0
    for k, q in enumerate(primes, start=1):
        bits += math.log2(q)
        if bits > need:
            return k
    raise ValueError(f"the chain's {bits:.1f} bits cannot hold {need:.1f}")


def slot_update(w_slots, x_slots, y_slots, m: int, lr: float) -> np.ndarray:
    """The update the step should make from the values its ciphertexts
    hold, slot by slot as the step computes (complex, float64): w_slots
    [f, slots] the entry weights' slots, x_slots [f, slots] the feature
    columns', y_slots [slots] the labels'; z = sum_j w_j x_j and
    p = 1/2 + C1 z + C3 z^3 in each slot, then -(lr/m) sum over the first
    m slots of x_j (p - y): one value a weight."""
    z = (w_slots * x_slots).sum(0)
    p = 0.5 + C1 * z + C3 * z**3
    return -(lr / m) * (x_slots[:, :m] * (p - y_slots)[:m]).sum(1)


def _residues(pairs: list, s: np.ndarray, primes, device) -> np.ndarray:
    """c0 + c1 s of every (c0, c1) pair over `primes`, as canonical
    coefficient residues [pairs, K, N]: the limbs of all pairs in one
    transform (each row is its own prime's)."""
    c0 = np.concatenate([np.asarray(a, np.int64) for a, _ in pairs])
    c1 = np.concatenate([np.asarray(b, np.int64) for _, b in pairs])
    res = ring.decrypt_residues(c0, c1, s, list(primes) * len(pairs), device)
    return res.reshape(len(pairs), len(primes), -1)


def decrypt_weights(comps: list, scale: float, s: np.ndarray, primes, device="cpu") -> list:
    """The slots of each ciphertext at `scale`, decrypted over `primes`
    (leading limbs): comps holds (c0, c1) pairs."""
    return [ckks.decode(ring.crt_centered(r, primes), scale)
            for r in _residues(comps, s, primes, device)]


def decrypt_updates(outs: list, entries: list, scale: float, s: np.ndarray, primes,
                    device="cpu") -> list:
    """The slots of each output weight less its entry weight, both at
    `scale` and decrypted over `primes`: the messages' coefficients are
    subtracted as integers (mod Q', exact where limbs_needed holds both),
    then decoded once. outs, entries: (c0, c1) pairs, weight by weight."""
    q = np.asarray([int(p) for p in primes], np.int64)[:, None]
    diff = (_residues(outs, s, primes, device) - _residues(entries, s, primes, device)) % q
    return [ckks.decode(ring.crt_centered(d, primes), scale) for d in diff]
