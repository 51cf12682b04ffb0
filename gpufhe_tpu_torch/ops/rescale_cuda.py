"""The rescale kernel (csrc/rescale.cu): the CKKS rescale and the BGV
ModSwitch of every dropped limb in one pass, its tables and its wrapper.

For x: int64[..., K', N] canonical coefficient residues, K' >= K, the kernel
reads limbs 0 .. K-1 and drops the last `words` of them (1 or 2), writing
int64[..., K - words, N]: drop d divides by q_{K-1-d} with the centred lift,
in the BGV mode with the t correction. Its plain versions are
primitives/rns.py _rescale_plain and _modswitch_plain (one limb a call);
rescale, rescale_words and bgv_modswitch dispatch here for a CUDA tensor,
and a CPU tensor never reaches the kernel.

A table (`make_drop_table`) holds what one dropped limb needs, u32 values in
an int32 tensor in the kernel's layout: a header of q_l, [-t^-1]_{q_l} and
its Shoup companion floor(w * 2^32 / q_l), then rows over the K-1 remaining
limbs: q_i, q_l mod q_i, [q_l^-1]_{q_i} and its Shoup companion, m_i (the
least multiple of q_i at or above 2^30), t mod q_i and its Shoup companion.
The plain versions read their constants from the same table (`table_rows`).
The kernel's 32-bit arithmetic takes primes below 2^30, as every chain of
params/params.py has them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gpufhe_tpu_torch.ops.cuda_build import CudaKernel

MAX_PRIME = 1 << 30
MAX_WORDS = 2
HEADER = 4  # q_l, [-t^-1]_{q_l}, its Shoup companion, unused
ROWS = ("q", "ql_mod", "ql_inv", "ql_inv_shoup", "m", "t", "t_shoup")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# x, out, B, K, n, batch stride, limb stride, words, bgv, tab0, tab1, stream
KERNEL = CudaKernel("rescale", "rescale_launch",
                    [_P, _P, _I, _I, _I, _L, _L, _I, _I, _P, _P, _P])


def make_drop_table(qs, t: int, device) -> torch.Tensor:
    """The kernel's table for dropping qs[-1] from the chain qs (t the
    plaintext modulus, 0 for CKKS)."""
    qs = [int(q) for q in qs]
    if max(qs) >= MAX_PRIME:
        raise ValueError("the rescale kernel's 32-bit arithmetic needs every prime below 2^30")
    ql, rest = qs[-1], qs[:-1]
    negtinv = -pow(t, -1, ql) % ql if t else 0
    qlinv = [pow(ql, -1, q) for q in rest]
    t_mod = [t % q for q in rest]

    def shoup(ws, qq):
        return [(w << 32) // q for w, q in zip(ws, qq)]

    table = [ql, negtinv, (negtinv << 32) // ql, 0,
             *rest, *(ql % q for q in rest), *qlinv, *shoup(qlinv, rest),
             *(-(-MAX_PRIME // q) * q for q in rest), *t_mod, *shoup(t_mod, rest)]
    return torch.from_numpy(np.asarray(table, dtype=np.uint32).view(np.int32)).to(device)


def table_rows(table: torch.Tensor) -> dict[str, torch.Tensor]:
    """A drop table as int64: each row of ROWS over the remaining limbs, and
    "negtinv", [-t^-1]_{q_l} (shape [1])."""
    words = table.to(torch.int64) & 0xFFFFFFFF
    return {"negtinv": words[1:2], **dict(zip(ROWS, words[HEADER:].view(len(ROWS), -1)))}


def drop_limbs(x: torch.Tensor, level: int, tables, bgv: bool) -> torch.Tensor:
    """int64[..., >= level, N] on the card -> int64[..., level - len(tables), N]:
    tables[d] is the table of dropping limb level-1-d (len 1 or 2)."""
    words = len(tables)
    if x.device.type != "cuda" or x.dtype != torch.int64 or x.dim() < 2 or x.stride(-1) != 1:
        raise ValueError("drop_limbs takes an int64 CUDA tensor [..., K, N] with coefficient "
                         "stride 1")
    if not 1 <= words <= MAX_WORDS or not words < level <= x.shape[-2]:
        raise ValueError(f"cannot drop {words} of {level} limbs from {tuple(x.shape)}")
    for d, tab in enumerate(tables):
        if tab.device != x.device or tab.numel() != HEADER + len(ROWS) * (level - 1 - d):
            raise ValueError(f"table {d} does not fit level {level} on {x.device}")
    lead, n = x.shape[:-2], x.shape[-1]
    xb = x.reshape(-1, *x.shape[-2:])  # a view where the leading axes allow it
    out = torch.empty((*lead, level - words, n), dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(xb.data_ptr(), out.data_ptr(), xb.shape[0], level, n, xb.stride(0),
                  xb.stride(1), words, int(bgv), tables[0].data_ptr(),
                  tables[1].data_ptr() if words == 2 else None, stream)
    return out
