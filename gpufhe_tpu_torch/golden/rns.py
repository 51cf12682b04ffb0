"""Host RNS helpers (counterpart of gpufhe_tpu/golden/rns.py:25-55).

conv_matrix and qhat_inv build the constant tables of the approximate base
conversion; base_convert is the host oracle of that conversion, reduced per
term exactly as the reference's golden model does.
"""

from __future__ import annotations

import math

import numpy as np


def conv_matrix(src: tuple[int, ...], dst: tuple[int, ...]) -> np.ndarray:
    """M[t, i] = [prod(src)/src_i mod dst_t]; int64[len(dst), len(src)]."""
    big = math.prod(src)
    return np.array([[(big // b) % t for b in src] for t in dst], dtype=np.int64)


def qhat_inv(src: tuple[int, ...]) -> np.ndarray:
    """[(prod(src)/src_i)^{-1} mod src_i]; int64[len(src)]."""
    big = math.prod(src)
    return np.array([pow(big // b, -1, b) for b in src], dtype=np.int64)


def base_convert(x: np.ndarray, src: tuple[int, ...], dst: tuple[int, ...]) -> np.ndarray:
    """Approximate fast base conversion int64[len(src), N] -> int64[len(dst), N].

    The result is congruent to x + u * prod(src) for a small |u| <= len(src)/2
    per coefficient (the classic approximation error).
    """
    src_arr = np.array(src, dtype=np.int64)[:, None]
    v = x * qhat_inv(src)[:, None] % src_arr
    m = conv_matrix(src, dst)
    out = np.empty((len(dst), x.shape[1]), dtype=np.int64)
    for t_idx, t in enumerate(dst):
        acc = np.zeros(x.shape[1], dtype=np.int64)
        for i in range(len(src)):
            acc = (acc + v[i] * m[t_idx, i]) % t  # per-term reduce: no overflow
        out[t_idx] = acc
    return out
