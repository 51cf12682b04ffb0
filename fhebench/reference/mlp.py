"""The plain reference for one encrypted MNIST inference (SecureML's network
A, 784-128-128-10 with the square after each hidden layer): the seeded
weights and images, the forward in float64, the output's level, and the
decryption of a request's input and output.

The forward is written from the network's equations (Mohassel and Zhang,
IEEE S&P 2017; the square is CryptoNets' activation):

    h_0 = x,   h_i = W_i h_(i-1) + b_i,   h_i <- h_i^2 for every hidden layer

in complex128 (float64 pairs), so that the input's slots go in as they
decrypt, imaginary noise and all, and the square acts on them as the
ciphertext's product does.

Nothing here comes from the library under test. The decryption is
`reference/ckks.py`'s over the leading limbs of each ciphertext (a message
whose coefficients lie below half their product decrypts there exactly as
over the whole chain; `reference/logreg.py` limbs_needed).
"""

from __future__ import annotations

import numpy as np
import torch

from fhebench.reference import ckks

BIAS_STD = 0.1


def draw(rng: np.random.Generator, dims: list, count: int) -> tuple[list, np.ndarray]:
    """The network dims[0] -> dims[1] -> ..., then `count` images, from one
    stream: per layer W ~ N(0, 1/fan_in) of shape (out, in), then
    b ~ N(0, 0.1^2); then [count, dims[0]] pixel values uniform in [0, 1]."""
    layers = [(rng.normal(size=(d_out, d_in)) / np.sqrt(d_in), rng.normal(size=d_out) * BIAS_STD)
              for d_in, d_out in zip(dims, dims[1:])]
    return layers, rng.uniform(0.0, 1.0, size=(count, dims[0]))


def forward(layers: list, x, dtype=torch.complex128) -> np.ndarray:
    """The network's output on the input x (the first layer's fan-in values),
    every value held in dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h = torch.as_tensor(np.asarray(x)).to(dtype)
    for i, (w, b) in enumerate(layers):
        h = torch.as_tensor(np.asarray(w)).to(dtype) @ h + torch.as_tensor(
            np.asarray(b)).to(dtype)
        if i < len(layers) - 1:
            h = h * h
    return h.to(torch.complex128).numpy()


def out_level(top: int, hidden: int, layers: int, words: int) -> int:
    """The output's level: each product and each square rescales by words."""
    return top - words * (layers + hidden)


def decrypt(pair, s: np.ndarray, primes, scale: float, device="cpu") -> np.ndarray:
    """The slots of a (c0, c1) pair over `primes` (its leading limbs)."""
    c0, c1 = pair
    return ckks.decrypt_decode(np.asarray(c0, np.int64), np.asarray(c1, np.int64), s,
                               list(primes), scale, device)


def expected(layers: list, x_slots: np.ndarray, slots: int) -> np.ndarray:
    """The output the forward should give from the input's slots as they
    decrypt: the logits in the first slots, zeros in every other."""
    logits = forward(layers, x_slots[: layers[0][0].shape[1]])
    want = np.zeros(slots, dtype=np.complex128)
    want[: logits.size] = logits
    return want
