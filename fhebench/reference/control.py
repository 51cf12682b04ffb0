"""The controls: the reference put in the library's place and computed one
precision below what the configuration states, read by the same number the
check compares. A limit that lets its control through separates nothing.

- CKKS square chain: the configuration computes in float64 at Delta = 2^56,
  so the control squares the messages in complex64 (float32).
- CKKS bootstrap: the refresh holds about 17 bits of the message (below
  float32's 24), so the precision it states sits between float32 and
  float16; the control returns the messages rounded to float16.
- BGV and BFV: exact arithmetic mod t in 64-bit integers; the control takes
  the slotwise products in int32, which wraps.
"""

from __future__ import annotations

import numpy as np
import torch

from fhebench.reference import integer


def ckks_square_chain(msgs: list, depth: int) -> float:
    """max_err of z^(2^depth) computed in complex64."""
    err = 0.0
    for z in msgs:
        x = z.astype(np.complex64)
        for _ in range(depth):
            x = x * x
        err = max(err, float(np.abs(x.astype(np.complex128) - z ** (2**depth)).max()))
    return err


def bootstrap(msgs: list) -> float:
    """max_err of the messages returned in float16."""
    err = 0.0
    for z in msgs:
        x = z.real.astype(np.float16) + 1j * z.imag.astype(np.float16).astype(np.float64)
        err = max(err, float(np.abs(x - z).max()))
    return err


def integer_square_chain(msgs: list, t: int, depth: int, device="cpu") -> int:
    """wrong_coeffs of m^(2^depth) with the slotwise products in int32."""
    wrong = 0
    for m in msgs:
        want = integer.power_poly(m, t, depth, torch.int64, device)
        got = integer.power_poly(m, t, depth, torch.int32, device)
        wrong += int(np.count_nonzero(got != want))
    return wrong
