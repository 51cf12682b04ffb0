"""The rescale kernel (csrc/rescale.cu): the CKKS rescale and the BGV
ModSwitch of every dropped limb in one pass, its tables, its wrapper and its
plain PyTorch version.

For x: int64[..., K', N] canonical coefficient residues, K' >= K,
`drop_limbs` reads limbs 0 .. K-1 and drops the last `words` of them (1 or
2), writing int64[..., K - words, N]: drop d divides by q_{K-1-d} with the
centred lift (u > q_l // 2 lifts to u - q_l),

    CKKS: (x - lift([x]_{q_l})) * [q_l^-1]_{q_i}                    mod q_i
    BGV:  (x + t lift([x (-t^-1)]_{q_l})) * [q_l^-1]_{q_i}          mod q_i

the second the reference's t-corrected ModSwitch (rns.py:328-351). A CPU
tensor runs `drop_limbs_plain`, one drop after another in int64; a CUDA
tensor launches the kernel once for all of them.

A table (`make_drop_table`) holds what one dropped limb needs, u32 values in
an int32 tensor in the kernel's layout: a header of q_l, [-t^-1]_{q_l} and
its Shoup companion floor(w * 2^32 / q_l), then rows over the K-1 remaining
limbs: q_i, q_l mod q_i, [q_l^-1]_{q_i} and its Shoup companion, m_i (the
least multiple of q_i at or above 2^30), t mod q_i and its Shoup companion.
The plain version reads its constants from the same table. `drop_tables`
caches the tables of a drop on (primes, words, t, device). The kernel's
32-bit arithmetic takes primes below 2^30, as every chain of
params/params.py has them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gpufhe_tpu_torch.ops.cuda_build import CudaKernel
from gpufhe_tpu_torch.ops.modops import add_mod, sub_mod

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


@functools.lru_cache(maxsize=None)
def drop_tables(qs: tuple, words: int, t: int, device) -> tuple[torch.Tensor, ...]:
    """The tables of dropping the last `words` primes of the active chain qs,
    the last first: what drop_limbs takes at level len(qs)."""
    return tuple(make_drop_table(qs[:len(qs) - d], t, device) for d in range(words))


def _table_rows(table: torch.Tensor) -> dict[str, torch.Tensor]:
    """A drop table as int64: "ql" and "negtinv" (shape [1]), and each row of
    ROWS over the remaining limbs as a column [K-1, 1]."""
    words = table.to(torch.int64) & 0xFFFFFFFF
    rows = words[HEADER:].view(len(ROWS), -1, 1)
    return {"ql": words[0:1], "negtinv": words[1:2], **dict(zip(ROWS, rows))}


def drop_limbs(x: torch.Tensor, level: int, tables, bgv: bool) -> torch.Tensor:
    """int64[..., >= level, N] -> int64[..., level - len(tables), N]:
    tables[d] is the table of dropping limb level-1-d (len 1 or 2), on x's
    device."""
    words = len(tables)
    if x.dim() < 2 or not 1 <= words <= MAX_WORDS or not words < level <= x.shape[-2]:
        raise ValueError(f"cannot drop {words} of {level} limbs from {tuple(x.shape)}")
    for d, tab in enumerate(tables):
        if tab.device != x.device or tab.numel() != HEADER + len(ROWS) * (level - 1 - d):
            raise ValueError(f"table {d} does not fit level {level} on {x.device}")
    if x.device.type == "cpu":
        return drop_limbs_plain(x, level, tables, bgv)
    return drop_limbs_cuda(x, level, tables, bgv)


def drop_limbs_cuda(x: torch.Tensor, level: int, tables, bgv: bool) -> torch.Tensor:
    """One launch for all the drops; x int64 on the card with coefficient
    stride 1."""
    words = len(tables)
    if x.device.type != "cuda" or x.dtype != torch.int64 or x.stride(-1) != 1:
        raise ValueError("drop_limbs_cuda takes an int64 CUDA tensor [..., K, N] with "
                         "coefficient stride 1")
    lead, n = x.shape[:-2], x.shape[-1]
    xb = x.reshape(-1, *x.shape[-2:])  # a view where the leading axes allow it
    out = torch.empty((*lead, level - words, n), dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(xb.data_ptr(), out.data_ptr(), xb.shape[0], level, n, xb.stride(0),
                  xb.stride(1), words, int(bgv), tables[0].data_ptr(),
                  tables[1].data_ptr() if words == 2 else None, stream)
    return out


def drop_limbs_plain(x: torch.Tensor, level: int, tables, bgv: bool) -> torch.Tensor:
    """The same drops in int64, one after another."""
    for d, tab in enumerate(tables):
        k = level - d
        c = _table_rows(tab)
        q, q_l = c["q"], c["ql"]
        last = x[..., k - 1 : k, :]
        if bgv:  # u = [x (-t^-1)]_{q_l}
            last = torch.remainder(last * c["negtinv"], q_l)
        r = torch.remainder(last, q)  # the value mod q_i
        lifted = torch.where(last > q_l // 2, sub_mod(r, c["ql_mod"], q), r)
        if bgv:
            x = add_mod(x[..., : k - 1, :], torch.remainder(lifted * c["t"], q), q)
        else:
            x = sub_mod(x[..., : k - 1, :], lifted, q)
        x = torch.remainder(x * c["ql_inv"], q)
    return x
