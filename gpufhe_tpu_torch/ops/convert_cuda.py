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

`mod_down_cuda` is the key switch's ModDown in one launch of the same
kernel (its kDown instances): for the coefficient-domain accumulators
acc int64[B, K + alpha, N], with the P -> Q tables and the epilogue's table
(`make_mod_down_table`),

    out[b] = (acc[b, :K] - conv(acc[b, K:])) * [P^-1]_q + addend[b]  mod q

canonical, the addend for its B' <= B leading rows only. `mod_down` runs
`mod_down_plain` on a CPU tensor (base_convert_plain, then sub_mod, the P^-1
product and add_mod) and launches `mod_down_cuda` on a CUDA tensor.
`MOD_DOWN` counts those launches and the components they cover;
`KERNEL.launches` counts them with every other launch of the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from gpufhe_tpu_torch.golden import rns as grns
from gpufhe_tpu_torch.ops.cuda_build import CudaKernel
from gpufhe_tpu_torch.ops.modops import add_mod, sub_mod

# what the kernel takes (csrc/convert.cu): 32-bit residues of 30-bit primes,
# a grid row per destination group, and one chunk of conversion rows in its
# 48 KB of shared memory
K3_MAX_PRIME = 1 << 30
K3_MAX_T = 65535
K3_MAX_S = 12288
# destinations per block and coefficients per thread (a sweep on the card,
# PERF.md section 6); ModDown's epilogue runs best with every destination in
# one group at one coefficient a thread (its own sweep, PERF.md section 6)
GROUP = 16
CPT = 2
MOD_DOWN_GROUP = K3_MAX_T
MOD_DOWN_CPT = 1


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


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# x, out, S, T, n, tg, cpt, B, x and out batch strides, ModDown's acc, add,
# b_add, add's batch stride and table, the K3Tables pointers, stream
KERNEL = CudaKernel(
    "convert", "base_convert",
    [_P, _P] + [_I] * 6 + [_L] * 2 + [_P, _P, _I, _L, _P]
    + [_P] * len(dataclasses.fields(K3Tables)) + [_P],
)


@dataclasses.dataclass
class LaunchCount:
    """Launches of the fused ModDown and the components (batch rows) they
    covered: `mod_down_cuda` adds to both after each launch that returned
    success, and nothing else touches them but `reset`."""

    launches: int = 0
    components: int = 0

    def reset(self) -> None:
        self.launches = self.components = 0


MOD_DOWN = LaunchCount()


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


def make_mod_down_table(p_primes, q_primes, device) -> torch.Tensor:
    """ModDown's epilogue table, u32 in int32[4, K] (K = len(q_primes)):
    [P^-1]_{q_t}, its Shoup companion floor(w * 2^32 / q_t), [-P]_{q_t} and
    its companion."""
    big_p = math.prod(int(p) for p in p_primes)
    qs = [int(q) for q in q_primes]
    pinv = [pow(big_p, -1, q) for q in qs]
    negp = [-big_p % q for q in qs]
    rows = [pinv, [(w << 32) // q for w, q in zip(pinv, qs)],
            negp, [(w << 32) // q for w, q in zip(negp, qs)]]
    return torch.from_numpy(np.asarray(rows, dtype=np.uint32).view(np.int32)).to(device)


def base_convert(x: torch.Tensor, tabs: ConvertTables,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """int64[S, N] canonical -> int64[T, N] canonical, written into `out`
    (int64[T, N], contiguous) when given."""
    if x.device.type == "cpu":
        got = base_convert_plain(x, tabs)
        return got if out is None else out.copy_(got)
    return base_convert_cuda(x, tabs, out=out)


def _check_rows(t: torch.Tensor, shape: tuple, like: torch.Tensor, what: str) -> None:
    """t is int64 `shape` on like's device with limb stride N and coefficient
    stride 1 (any batch stride)."""
    if (tuple(t.shape) != shape or t.dtype != torch.int64 or t.device != like.device
            or t.stride(-1) != 1 or (shape[-2] > 1 and t.stride(-2) != shape[-1])):
        raise ValueError(f"{what} must be int64{list(shape)} on {like.device} with rows of "
                         f"contiguous coefficients, not {t.dtype}{list(t.shape)}")


def base_convert_cuda(x: torch.Tensor, tabs: ConvertTables, group: int = GROUP,
                      cpt: int = CPT, out: torch.Tensor | None = None) -> torch.Tensor:
    """`group` (destinations per block) and `cpt` (coefficients per thread, 1
    or 2) choose the launch; the defaults are the card's best (PERF.md).
    `out`: where to write, int64[T, N] contiguous (a slice of a stack)."""
    if tabs.k3_refusal:  # the primes and limb counts, checked once per table set
        raise ValueError(tabs.k3_refusal)
    if x.device.type != "cuda" or x.dtype != torch.int64 or not x.is_contiguous():
        raise ValueError("base_convert_cuda takes a contiguous int64 CUDA tensor")
    s_dim, n = x.shape
    if s_dim != tabs.sq.numel() or tabs.sq.device != x.device:
        raise ValueError(f"{s_dim} source limbs for tables of {tabs.sq.numel()} on {tabs.sq.device}")
    t_dim = tabs.dq.numel()
    if out is None:
        out = torch.empty((t_dim, n), dtype=torch.int64, device=x.device)
    _check_rows(out, (t_dim, n), x, "out")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(x.data_ptr(), out.data_ptr(), s_dim, t_dim, n, group, cpt, 1, 0, 0,
                  None, None, 0, 0, None, *tabs.k3.pointers(), stream)
    return out


def mod_down(acc: torch.Tensor, tabs: ConvertTables, table: torch.Tensor,
             addend: torch.Tensor | None = None) -> torch.Tensor:
    """ModDown by P: acc int64[B, K + alpha, N] -> int64[B, K, N] canonical,
    plus addend int64[B', K, N] (B' <= B) on its leading rows."""
    if acc.device.type == "cpu":
        return mod_down_plain(acc, tabs, table, addend)
    return mod_down_cuda(acc, tabs, table, addend)


def mod_down_cuda(acc: torch.Tensor, tabs: ConvertTables, table: torch.Tensor,
                  addend: torch.Tensor | None = None, out: torch.Tensor | None = None,
                  group: int = MOD_DOWN_GROUP, cpt: int = MOD_DOWN_CPT) -> torch.Tensor:
    """ModDown by P in one launch: acc int64[B, K + alpha, N] (rows K.. in
    the basis `tabs` converts from, rows ..K in the one it converts to),
    table make_mod_down_table's, addend int64[B', K, N] with B' <= B or
    None -> int64[B, K, N], written into `out` when given (which may be the
    addend itself). Every tensor has rows of contiguous coefficients."""
    if tabs.k3_refusal:
        raise ValueError(tabs.k3_refusal)
    alpha, k = tabs.sq.numel(), tabs.dq.numel()
    if acc.device.type != "cuda" or acc.dim() != 3:
        raise ValueError("mod_down_cuda takes int64[B, K + alpha, N] on a CUDA device")
    b_dim, _, n = acc.shape
    _check_rows(acc, (b_dim, k + alpha, n), acc, "acc")
    if tabs.sq.device != acc.device or table.device != acc.device or table.numel() != 4 * k:
        raise ValueError(f"tables of {alpha} -> {k} limbs on {acc.device} needed")
    if out is None:
        out = torch.empty((b_dim, k, n), dtype=torch.int64, device=acc.device)
    _check_rows(out, (b_dim, k, n), acc, "out")
    b_add = 0 if addend is None else addend.shape[0]
    if addend is not None:
        if not 1 <= b_add <= b_dim:
            raise ValueError(f"an addend of {b_add} rows for {b_dim} components")
        _check_rows(addend, (b_add, k, n), acc, "addend")
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    KERNEL.launch(acc[:, k:].data_ptr(), out.data_ptr(), alpha, k, n, group, cpt, b_dim,
                  acc.stride(0), out.stride(0), acc.data_ptr(),
                  None if addend is None else addend.data_ptr(), b_add,
                  0 if addend is None else addend.stride(0), table.data_ptr(),
                  *tabs.k3.pointers(), stream)
    MOD_DOWN.launches += 1
    MOD_DOWN.components += b_dim
    return out


def base_convert_plain(x: torch.Tensor, tabs: ConvertTables) -> torch.Tensor:
    """int64[..., S, N] canonical -> int64[..., T, N] canonical."""
    v = torch.remainder(x * tabs.qhinv[:, None], tabs.sq[:, None])
    dq = tabs.dq[:, None]
    acc = None
    for i in range(x.shape[-2]):  # per-term reduced: products < 2^60
        term = torch.remainder(v[..., i : i + 1, :] * tabs.conv[:, i : i + 1], dq)
        acc = term if acc is None else add_mod(acc, term, dq)
    return acc


def mod_down_plain(acc: torch.Tensor, tabs: ConvertTables, table: torch.Tensor,
                   addend: torch.Tensor | None = None) -> torch.Tensor:
    """The same ModDown in int64: the conversion, sub_mod, the P^-1 product
    (the table's first row) and add_mod of the addend."""
    k = tabs.dq.numel()
    q = tabs.dq[:, None]
    diff = sub_mod(acc[:, :k], base_convert_plain(acc[:, k:], tabs), q)
    pinv = table[0].to(torch.int64) & 0xFFFFFFFF  # u32 held in int32
    down = torch.remainder(diff * pinv[:, None], q)
    if addend is not None:
        down[: addend.shape[0]] = add_mod(down[: addend.shape[0]], addend, q)
    return down
