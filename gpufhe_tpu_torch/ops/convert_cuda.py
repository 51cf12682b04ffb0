"""Kernel K3: RNS approximate base conversion (csrc/convert.cu), its tables,
wrapper and plain PyTorch version.

Counterpart of gpufhe_tpu/ops/convert_pallas.py (digit_convert,
make_digit_convert). For x: int64[S, N] canonical mod the source primes,

    v_i   = x_i * [Qhat_i^-1]_{q_i}          mod q_i
    out_t = sum_i v_i * conv[t, i]            mod p_t   (canonical)

which is the unique canonical value of the per-term-reduced conversion of
gpufhe_tpu/primitives/rns.py _base_convert_shoup. `conv` and the Qhat
inverses are device tables, so a variant that folds extra factors into them
(the BGV t-corrected ModDown) needs only other ConvertTables.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from gpufhe_tpu_torch.golden import rns as grns
from gpufhe_tpu_torch.ops.cuda_build import CudaKernel
from gpufhe_tpu_torch.ops.modops import add_mod

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel(
    "convert", "base_convert",
    [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
)


@dataclasses.dataclass(frozen=True)
class ConvertTables:
    """Device tables of one (src, dst) basis pair, int64, canonical."""

    sq: torch.Tensor  # [S] source primes
    smu: torch.Tensor  # [S] floor(2^64 / q_i)
    qhinv: torch.Tensor  # [S] [Qhat_i^-1]_{q_i}
    conv: torch.Tensor  # [T, S] conv[t, i] mod p_t
    dq: torch.Tensor  # [T] destination primes
    dmu: torch.Tensor  # [T] floor(2^64 / p_t)


def make_convert_tables(src, dst, device) -> ConvertTables:
    """Tables of the approximate conversion from basis src to basis dst."""
    src = tuple(int(q) for q in src)
    dst = tuple(int(q) for q in dst)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)

    return ConvertTables(
        sq=dev(src),
        smu=dev([(1 << 64) // q for q in src]),
        qhinv=dev(grns.qhat_inv(src)),
        conv=dev(grns.conv_matrix(src, dst)),
        dq=dev(dst),
        dmu=dev([(1 << 64) // q for q in dst]),
    )


def base_convert(x: torch.Tensor, tabs: ConvertTables) -> torch.Tensor:
    """int64[S, N] canonical -> int64[T, N] canonical."""
    if x.device.type == "cpu":
        return base_convert_plain(x, tabs)
    return base_convert_cuda(x, tabs)


def base_convert_cuda(x: torch.Tensor, tabs: ConvertTables) -> torch.Tensor:
    s_dim, n = x.shape
    t_dim = tabs.dq.numel()
    if x.device.type != "cuda" or x.dtype != torch.int64 or not x.is_contiguous():
        raise ValueError("base_convert_cuda takes a contiguous int64 CUDA tensor")
    if s_dim != tabs.sq.numel() or tabs.sq.device != x.device:
        raise ValueError(f"{s_dim} source limbs for tables of {tabs.sq.numel()} on {tabs.sq.device}")
    out = torch.empty((t_dim, n), dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(
        x.data_ptr(), out.data_ptr(), s_dim, t_dim, n,
        tabs.sq.data_ptr(), tabs.smu.data_ptr(), tabs.qhinv.data_ptr(),
        tabs.conv.data_ptr(), tabs.dq.data_ptr(), tabs.dmu.data_ptr(), stream,
    )
    return out


def base_convert_plain(x: torch.Tensor, tabs: ConvertTables) -> torch.Tensor:
    v = torch.remainder(x * tabs.qhinv[:, None], tabs.sq[:, None])
    dq = tabs.dq[:, None]
    acc = None
    for i in range(x.shape[0]):  # per-term reduced: products < 2^60
        term = torch.remainder(v[i][None, :] * tabs.conv[:, i : i + 1], dq)
        acc = term if acc is None else add_mod(acc, term, dq)
    return acc
