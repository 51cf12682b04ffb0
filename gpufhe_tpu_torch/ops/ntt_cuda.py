"""Kernel K1: the negacyclic four-step NTT (csrc/ntt.cu), its wrapper and its
plain PyTorch version.

Counterpart of gpufhe_tpu/ops/ntt_pallas.py fourstep_pallas_v3. `fourstep`
takes int64[rows, N] canonical residues, rows = batch * L, and an int32
index vector of the L chain rows into the context's full tables. A tensor on
the CPU runs `fourstep_plain`; a CUDA tensor launches the kernel (one call of
the C entry point = one transform of every row, as two kernel passes). The
kernel computes in 32-bit words, so it takes primes below 2^30 and
transform lengths n1, n2 from 8 to 256 (N from 2^6 to 2^16); its scratch
between the passes is u32 (an int32 tensor).

`fourstep_pass` runs ONE pass over a block of every row (the entry point
ntt_pass), the stage of the distributed four-step on a mesh
(parallel/sharded.py): pass A over a block of columns [rows, n1, width]
from global column col0, pass B over a block of rows [rows, width, n2]
left row-major (the forward writes [k1, k2], the inverse reads it). The
data between the passes is u32 held in int32, as the kernel's scratch is;
`fourstep_pass_plain` is the same pass cut from `fourstep_plain`, and
`PASS_KERNEL` counts its own launches.

`fourstep_plain` computes the same function with the same algorithm
(ops/context.py docstring: pass A over columns with the psi twists folded in,
pass B over rows, radix-2 stages on bit-reversed input), written with
elementwise int64 ops so that it also runs on the card for the comparison.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from gpufhe_tpu_torch.ops.context import Context, K1Tables
from gpufhe_tpu_torch.ops.cuda_build import CudaKernel
from gpufhe_tpu_torch.ops.modops import add_mod, sub_mod

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, y, scratch, idx, L, rows, n, n1, n2, inverse, the K1Tables pointers, stream
KERNEL = CudaKernel(
    "ntt", "ntt_fourstep",
    [_P] * 4 + [_I] * 6 + [_P] * len(dataclasses.fields(K1Tables)) + [_P],
)

# x, y, idx, L, rows, n, n1, n2, kind, width, col0, the K1Tables pointers, stream
PASS_KERNEL = CudaKernel(
    "ntt", "ntt_pass",
    [_P] * 3 + [_I] * 8 + [_P] * len(dataclasses.fields(K1Tables)) + [_P],
)
# the passes of ntt_pass, in its numbering: forward A and B, inverse B and A
FWD_A, FWD_B, INV_B, INV_A = range(4)


def fourstep(x: torch.Tensor, idx: torch.Tensor, ctx: Context, inverse: bool) -> torch.Tensor:
    """Forward (or inverse, 1/N folded in) NTT of each row of int64[rows, N].

    Row r uses chain row idx[r % len(idx)]. Output canonical, natural order.
    """
    if x.device.type == "cpu":
        return fourstep_plain(x, idx, ctx, inverse)
    return fourstep_cuda(x, idx, ctx, inverse)


def fourstep_cuda(x: torch.Tensor, idx: torch.Tensor, ctx: Context, inverse: bool,
                  kernel: CudaKernel = KERNEL) -> torch.Tensor:
    """`kernel` is K1 or one of its ablation builds (ops/probes.py)."""
    rows, n = x.shape
    L = idx.numel()
    if ctx.k1_refusal:  # the split and every prime of the chain, checked once per context
        raise ValueError(ctx.k1_refusal)
    if x.device.type != "cuda" or x.dtype != torch.int64 or not x.is_contiguous():
        raise ValueError("fourstep_cuda takes a contiguous int64 CUDA tensor")
    if idx.dtype != torch.int32 or idx.device != x.device or ctx.device != x.device:
        raise ValueError("limb index must be int32 on the data's device, like the tables")
    if n != ctx.n or L == 0 or rows % L:
        raise ValueError(f"shape {tuple(x.shape)} does not fit N={ctx.n}, L={L}")
    t = ctx.ntt_inv if inverse else ctx.ntt_fwd
    y = torch.empty_like(x)
    scratch = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    kernel.launch(
        x.data_ptr(), y.data_ptr(), scratch.data_ptr(), idx.data_ptr(),
        L, rows, n, ctx.n1, ctx.n2, int(inverse), *t.k1.pointers(), stream,
    )
    return y


def fourstep_pass(x: torch.Tensor, idx: torch.Tensor, ctx: Context, kind: int,
                  col0: int = 0) -> torch.Tensor:
    """One pass of the four-step over a block of each of x's rows: x
    [rows, n1, width] for pass A (FWD_A int64 -> int32, INV_A int32 ->
    int64; columns col0 .. col0 + width - 1), [rows, width, n2] for pass B
    (FWD_B int32 -> int64, INV_B int64 -> int32). Row r uses chain row
    idx[r % len(idx)]."""
    if x.device.type == "cpu":
        return fourstep_pass_plain(x, idx, ctx, kind, col0)
    return fourstep_pass_cuda(x, idx, ctx, kind, col0)


def _pass_shape(x: torch.Tensor, ctx: Context, kind: int, col0: int) -> tuple[int, torch.dtype]:
    """(block width, output dtype) of a pass, or ValueError."""
    if kind not in (FWD_A, FWD_B, INV_B, INV_A):
        raise ValueError(f"pass kind {kind} is none of FWD_A, FWD_B, INV_B, INV_A")
    in_dtype = torch.int64 if kind in (FWD_A, INV_B) else torch.int32
    if x.dim() != 3 or x.dtype != in_dtype:
        raise ValueError(f"pass {kind} takes {in_dtype}[rows, a, b], not {x.dtype}"
                         f"{list(x.shape)}")
    pass_a = kind in (FWD_A, INV_A)
    width = x.shape[2] if pass_a else x.shape[1]
    full = ctx.n2 if pass_a else ctx.n1
    other = (x.shape[1], ctx.n1) if pass_a else (x.shape[2], ctx.n2)
    if (other[0] != other[1] or width < 1 or full % width or col0 % width
            or not 0 <= col0 <= full - width or (col0 and not pass_a)):
        raise ValueError(f"block {list(x.shape)} at column {col0} does not fit {ctx.n1} x "
                         f"{ctx.n2}")
    return width, torch.int32 if kind in (FWD_A, INV_B) else torch.int64


def fourstep_pass_cuda(x: torch.Tensor, idx: torch.Tensor, ctx: Context, kind: int,
                       col0: int = 0) -> torch.Tensor:
    if ctx.k1_refusal:
        raise ValueError(ctx.k1_refusal)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("fourstep_pass_cuda takes a contiguous CUDA tensor")
    if idx.dtype != torch.int32 or idx.device != x.device or ctx.device != x.device:
        raise ValueError("limb index must be int32 on the data's device, like the tables")
    width, out_dtype = _pass_shape(x, ctx, kind, col0)
    rows, L = x.shape[0], idx.numel()
    if L == 0 or rows % L:
        raise ValueError(f"{rows} rows do not fit {L} limbs")
    t = ctx.ntt_inv if kind in (INV_B, INV_A) else ctx.ntt_fwd
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    PASS_KERNEL.launch(
        x.data_ptr(), y.data_ptr(), idx.data_ptr(), L, rows, ctx.n, ctx.n1, ctx.n2, kind,
        width, col0, *t.k1.pointers(), stream,
    )
    return y


@functools.lru_cache(maxsize=16)
def bitrev(r: int, device: torch.device) -> torch.Tensor:
    bits = r.bit_length() - 1
    return torch.tensor(
        [int(f"{i:0{bits}b}"[::-1], 2) for i in range(r)], dtype=torch.int64, device=device
    )


def _pass(y, q, w, n, pre=None, post=None):
    """Cyclic transform along the last axis of y[rows, lanes, R].

    w: [rows, n/2] root powers (the R-point root is w^(n/R)); pre/post are
    multiplied in before and after, broadcast against y.
    """
    rows, lanes, r = y.shape
    if pre is not None:
        y = torch.remainder(y * pre, q)
    y = y[..., bitrev(r, y.device)]
    m = 1
    while m < r:
        cols = torch.arange(m, device=y.device) * (n // (2 * m))  # w_R^(k R/2m)
        wm = w[:, cols].view(rows, 1, 1, m)
        y = y.reshape(rows, lanes, r // (2 * m), 2, m)
        u = y[..., 0, :]
        v = torch.remainder(y[..., 1, :] * wm, q[..., None])
        y = torch.stack((add_mod(u, v, q[..., None]), sub_mod(u, v, q[..., None])), dim=-2)
        y = y.reshape(rows, lanes, r)
        m *= 2
    if post is not None:
        y = torch.remainder(y * post, q)
    return y


def _twiddle_exponents(ctx: Context) -> torch.Tensor:
    """[n2, n1] exponents e = j2 (2 k1 + 1) mod 2N of the four-step twiddle."""
    key = ("twiddle_exponents",)
    if key not in ctx.cache:
        j2 = torch.arange(ctx.n2, device=ctx.device)[:, None]
        k1 = torch.arange(ctx.n1, device=ctx.device)[None, :]
        ctx.cache[key] = (j2 * (2 * k1 + 1)) % (2 * ctx.n)
    return ctx.cache[key]


def _plain_tables(rows: int, idx: torch.Tensor, ctx: Context, inverse: bool):
    """(q, w, tab1d, tw) of the plain passes for `rows` data rows: tw is the
    four-step twiddle [rows, lane j2, t k1]."""
    n1 = ctx.n1
    chain = idx.to(torch.int64).repeat(rows // idx.numel())
    t = ctx.ntt_inv if inverse else ctx.ntt_fwd
    q = ctx.q[chain].view(rows, 1, 1)
    e = _twiddle_exponents(ctx)  # psi^(+-e) = lo[e mod n1] * hi[e div n1]
    lo = t.lo[chain][:, torch.remainder(e, n1)]
    hi = t.hi[chain][:, torch.div(e, n1, rounding_mode="floor")]
    return q, t.w[chain], t.tab1d[chain].view(rows, 1, n1), torch.remainder(lo * hi, q)


def fourstep_pass_plain(x: torch.Tensor, idx: torch.Tensor, ctx: Context, kind: int,
                        col0: int = 0) -> torch.Tensor:
    """fourstep_plain's pass `kind` on a block (fourstep_pass)."""
    width, out_dtype = _pass_shape(x, ctx, kind, col0)
    rows, n = x.shape[0], ctx.n
    q, w, tab1d, tw = _plain_tables(rows, idx, ctx, kind in (INV_B, INV_A))
    x = x.to(torch.int64)
    if kind == FWD_A:  # [j1, j2 block] -> [k1, j2 block]
        y = _pass(x.transpose(1, 2), q, w, n, pre=tab1d,
                  post=tw[:, col0:col0 + width]).transpose(1, 2)
    elif kind == INV_A:  # [k1, j2 block] -> [j1, j2 block]
        y = _pass(x.transpose(1, 2), q, w, n, pre=tw[:, col0:col0 + width],
                  post=tab1d).transpose(1, 2)
    else:  # a block of rows: [k1, j2] <-> [k1, k2] along each row
        y = _pass(x, q, w, n)
    return y.to(out_dtype).contiguous()


def fourstep_plain(x: torch.Tensor, idx: torch.Tensor, ctx: Context, inverse: bool) -> torch.Tensor:
    rows, n = x.shape
    n1, n2 = ctx.n1, ctx.n2
    q, w, tab1d, tw = _plain_tables(rows, idx, ctx, inverse)
    if not inverse:
        a = x.view(rows, n1, n2).transpose(1, 2)  # [j2, j1]
        b = _pass(a, q, w, n, pre=tab1d, post=tw)  # [j2, k1]
        c = _pass(b.transpose(1, 2), q, w, n)  # [k1, k2]
        return c.transpose(1, 2).reshape(rows, n)  # X[k2 * n1 + k1]
    b = _pass(x.view(rows, n2, n1).transpose(1, 2), q, w, n)  # [k1, j2]
    a = _pass(b.transpose(1, 2), q, w, n, pre=tw, post=tab1d)  # [j2, j1]
    return a.transpose(1, 2).reshape(rows, n)  # x[j1 * n2 + j2]
