"""Kernel K3: RNS approximate base conversion (csrc/convert.cu), its tables,
wrapper and plain PyTorch version.

Counterpart of gpufhe_tpu/ops/convert_pallas.py (digit_convert,
make_digit_convert). For x: int64[S, N] canonical mod the source primes,

    v_i   = x_i * [Qhat_i^-1]_{q_i}          mod q_i
    out_t = sum_i v_i * conv[t, i]            mod p_t   (canonical)

which is the unique canonical value of the per-term-reduced conversion of
gpufhe_tpu/primitives/rns.py _base_convert_shoup. `conv` and the Qhat
inverses are device tables, so a variant that folds extra factors into them
(the BGV t-corrected ModDown, primitives/rns.py make_ks_context) needs only
other ConvertTables, built by make_convert_tables from the folded values.

The kernel computes in 32-bit words and reads only its own tables
(`K3Tables`, u32 values held in int32 tensors but for dmu, in the order of
its entry point): the source primes, qhinv and its Shoup companion
floor(qhinv * 2^32 / q), conv, the destination primes, and the Barrett
constants floor(2^64 / p) of the destinations. It takes primes below 2^30
(products of two residues below 2^60, sixteen of them and a residue below
2^64); tables outside its limits carry the reason in `k3_refusal`, set once
where they are built. The plain version reads only the int64 tables.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from gpufhe_tpu_torch.golden import rns as grns
from gpufhe_tpu_torch.ops.cuda_build import CudaKernel
from gpufhe_tpu_torch.ops.modops import add_mod

# what the kernel takes (csrc/convert.cu): 32-bit residues of 30-bit primes,
# a grid row per destination group, and one chunk of conversion rows in its
# 48 KB of shared memory
K3_MAX_PRIME = 1 << 30
K3_MAX_T = 65535
K3_MAX_S = 12288
# destinations per block and coefficients per thread (a sweep on the card,
# PERF.md section 6)
GROUP = 16
CPT = 2


@dataclasses.dataclass(frozen=True)
class K3Tables:
    """The base conversion kernel's tables: u32 values in int32 tensors (dmu
    u64 in int64), in the order of csrc/convert.cu base_convert's parameters."""

    sq: torch.Tensor  # [S] source primes
    qhinv: torch.Tensor  # [S] [Qhat_i^-1]_{q_i}
    qhinv_shoup: torch.Tensor  # [S] floor(qhinv_i * 2^32 / q_i)
    conv: torch.Tensor  # [T, S] conv[t, i] mod p_t
    dq: torch.Tensor  # [T] destination primes
    dmu: torch.Tensor  # [T] floor(2^64 / p_t)

    def pointers(self) -> list[int]:
        return [getattr(self, f.name).data_ptr() for f in dataclasses.fields(self)]


_P, _I = ctypes.c_void_p, ctypes.c_int
# x, out, S, T, n, tg, cpt, the K3Tables pointers, stream
KERNEL = CudaKernel(
    "convert", "base_convert",
    [_P, _P] + [_I] * 5 + [_P] * len(dataclasses.fields(K3Tables)) + [_P],
)


def k3_refusal(src, dst) -> str | None:
    """Why the base conversion kernel cannot take this pair of bases, or None."""
    if not 1 <= len(src) <= K3_MAX_S or not 1 <= len(dst) <= K3_MAX_T:
        return (f"K3 takes 1 to {K3_MAX_S} source and 1 to {K3_MAX_T} destination limbs, "
                f"not {len(src)} and {len(dst)}")
    if max(src + dst) >= K3_MAX_PRIME:
        return "the K3 kernel's 32-bit arithmetic needs every prime below 2^30"
    return None


@dataclasses.dataclass(frozen=True)
class ConvertTables:
    """Device tables of one (src, dst) basis pair: int64, canonical, for the
    plain version; `k3` for the kernel."""

    sq: torch.Tensor  # [S] source primes
    qhinv: torch.Tensor  # [S] [Qhat_i^-1]_{q_i}
    conv: torch.Tensor  # [T, S] conv[t, i] mod p_t
    dq: torch.Tensor  # [T] destination primes
    k3: K3Tables
    k3_refusal: str | None


def make_convert_tables(src, dst, device, qhinv=None, conv=None) -> ConvertTables:
    """Tables of the approximate conversion from basis src to basis dst.

    `qhinv` (int64[S], canonical mod the source primes) and `conv`
    (int64[T, S], canonical mod the destination primes) default to
    [Qhat_i^-1]_{q_i} and [Qhat_i]_{p_t}; a caller that folds factors into
    them (the BGV ModDown: t^-1 into qhinv, t into conv) passes its own, and
    the kernel's tables, qhinv_shoup included, are derived from those."""
    src = tuple(int(q) for q in src)
    dst = tuple(int(q) for q in dst)
    sq = np.asarray(src, dtype=np.int64)
    qhinv = grns.qhat_inv(src) if qhinv is None else np.asarray(qhinv, dtype=np.int64)
    conv = grns.conv_matrix(src, dst) if conv is None else np.asarray(conv, dtype=np.int64)
    if qhinv.shape != (len(src),) or conv.shape != (len(dst), len(src)):
        raise ValueError(f"qhinv {qhinv.shape} and conv {conv.shape} do not fit {len(src)} "
                         f"source and {len(dst)} destination primes")
    dq = np.asarray(dst, dtype=np.int64)[:, None]
    if ((qhinv < 0) | (qhinv >= sq)).any() or ((conv < 0) | (conv >= dq)).any():
        raise ValueError("qhinv and conv must be canonical residues")

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)

    def dev32(a):  # u32 values, stored bit for bit in int32
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64).astype(np.uint32)
                                .view(np.int32)).to(device)

    return ConvertTables(
        sq=dev(sq),
        qhinv=dev(qhinv),
        conv=dev(conv),
        dq=dev(dst),
        k3=K3Tables(
            sq=dev32(sq),
            qhinv=dev32(qhinv),
            qhinv_shoup=dev32((qhinv << 32) // sq),  # read only for primes below 2^30
            conv=dev32(conv),
            dq=dev32(dst),
            dmu=dev([(1 << 64) // p for p in dst]),
        ),
        k3_refusal=k3_refusal(src, dst),
    )


def base_convert(x: torch.Tensor, tabs: ConvertTables) -> torch.Tensor:
    """int64[S, N] canonical -> int64[T, N] canonical."""
    if x.device.type == "cpu":
        return base_convert_plain(x, tabs)
    return base_convert_cuda(x, tabs)


def base_convert_cuda(x: torch.Tensor, tabs: ConvertTables, group: int = GROUP,
                      cpt: int = CPT) -> torch.Tensor:
    """`group` (destinations per block) and `cpt` (coefficients per thread, 1
    or 2) choose the launch; the defaults are the card's best (PERF.md)."""
    if tabs.k3_refusal:  # the primes and limb counts, checked once per table set
        raise ValueError(tabs.k3_refusal)
    if x.device.type != "cuda" or x.dtype != torch.int64 or not x.is_contiguous():
        raise ValueError("base_convert_cuda takes a contiguous int64 CUDA tensor")
    s_dim, n = x.shape
    if s_dim != tabs.sq.numel() or tabs.sq.device != x.device:
        raise ValueError(f"{s_dim} source limbs for tables of {tabs.sq.numel()} on {tabs.sq.device}")
    t_dim = tabs.dq.numel()
    out = torch.empty((t_dim, n), dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(x.data_ptr(), out.data_ptr(), s_dim, t_dim, n, group, cpt,
                  *tabs.k3.pointers(), stream)
    return out


def base_convert_plain(x: torch.Tensor, tabs: ConvertTables) -> torch.Tensor:
    v = torch.remainder(x * tabs.qhinv[:, None], tabs.sq[:, None])
    dq = tabs.dq[:, None]
    acc = None
    for i in range(x.shape[0]):  # per-term reduced: products < 2^60
        term = torch.remainder(v[i][None, :] * tabs.conv[:, i : i + 1], dq)
        acc = term if acc is None else add_mod(acc, term, dq)
    return acc
