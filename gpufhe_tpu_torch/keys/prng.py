"""Threefry-2x32 random bits in PyTorch, bit-exact with jax.random.

The reference's card-side key generation (gpufhe_tpu/keys/device_keygen.py)
draws every uniform polynomial from jax.random's default generator, and a
seeded key chest records the generator keys its draws came from. Replaying
those draws is the seeded-key contract, so the port computes the same bits:

- A key is an int64 tensor [2] holding two u32 words (k0, k1).
- key(seed) keeps the low 32 bits of the seed: [0, seed mod 2^32], as
  jax.random.key does with 64-bit types off (the reference's setting).
- With jax's partitionable threefry (its default), element i of a draw is
  threefry2x32(k0, k1) of the counter (i >> 32, i mod 2^32), i the flat
  row-major index: bits_u32 gives b0 ^ b1 of that pair, and split gives the
  pair itself as the new key i.

u32 arithmetic runs in int64 with a mask after each add and each rotation
(PyTorch lacks uint32 + and >> on the CPU), on the device the draw is asked
for: the card on the key-generation path, the CPU in the tests. The key's two
words are read on the host, so a key lives on the CPU and its draws run
anywhere.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # the Threefish key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _words(key) -> tuple[int, int]:
    k0, k1 = (int(v) for v in torch.as_tensor(key).reshape(2).tolist())
    return k0 & M32, k1 & M32


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words x0, x1 (int64 tensors of
    u32 values, one shape) under key: the pair of output words."""
    k0, k1 = _words(key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0.add_(x1).bitwise_and_(M32)
            high = x1 << r
            x1.bitwise_right_shift_(32 - r).bitwise_or_(high).bitwise_and_(M32)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(block + 1) % 3]).bitwise_and_(M32)
        x1.add_(ks[(block + 2) % 3] + block + 1).bitwise_and_(M32)
    return x0, x1


def _counters(count: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    i = torch.arange(count, dtype=torch.int64, device=device)
    return i >> 32, i & M32


def key(seed: int, device="cpu") -> torch.Tensor:
    """jax.random.key(seed) without 64-bit types: [0, seed mod 2^32]."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def split(key_, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): int64[num, 2], row i the key of counter i."""
    device = torch.as_tensor(key_).device
    b0, b1 = threefry2x32(key_, *_counters(num, device))
    return torch.stack([b0, b1], dim=1)


def bits_u32(key_, shape, device=None) -> torch.Tensor:
    """jax.random.bits(key, shape, uint32) as int64 values in [0, 2^32), drawn
    on `device` (default: the key's)."""
    device = torch.as_tensor(key_).device if device is None else device
    shape = tuple(shape)
    count = int(np.prod(shape, dtype=np.int64))
    b0, b1 = threefry2x32(key_, *_counters(count, device))
    return b0.bitwise_xor_(b1).reshape(shape)


def key_data(key_) -> torch.Tensor:
    """jax.random.key_data: the key's two u32 words, int64[2]."""
    return torch.as_tensor(key_).reshape(2)


def wrap_key_data(data) -> torch.Tensor:
    """jax.random.wrap_key_data: a key from two u32 words (uint32 or int64,
    numpy or torch) on the CPU."""
    words = np.asarray(data.cpu() if isinstance(data, torch.Tensor) else data)
    return torch.from_numpy(words.astype(np.int64).reshape(2) & M32)
