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


def fourstep_plain(x: torch.Tensor, idx: torch.Tensor, ctx: Context, inverse: bool) -> torch.Tensor:
    rows, n = x.shape
    n1, n2 = ctx.n1, ctx.n2
    chain = idx.to(torch.int64).repeat(rows // idx.numel())
    t = ctx.ntt_inv if inverse else ctx.ntt_fwd
    q = ctx.q[chain].view(rows, 1, 1)
    w = t.w[chain]
    tab1d = t.tab1d[chain].view(rows, 1, n1)
    e = _twiddle_exponents(ctx)  # psi^(+-e) = lo[e mod n1] * hi[e div n1]
    lo = t.lo[chain][:, torch.remainder(e, n1)]
    hi = t.hi[chain][:, torch.div(e, n1, rounding_mode="floor")]
    tw = torch.remainder(lo * hi, q)  # [lane j2, t k1]
    if not inverse:
        a = x.view(rows, n1, n2).transpose(1, 2)  # [j2, j1]
        b = _pass(a, q, w, n, pre=tab1d, post=tw)  # [j2, k1]
        c = _pass(b.transpose(1, 2), q, w, n)  # [k1, k2]
        return c.transpose(1, 2).reshape(rows, n)  # X[k2 * n1 + k1]
    b = _pass(x.view(rows, n2, n1).transpose(1, 2), q, w, n)  # [k1, j2]
    a = _pass(b.transpose(1, 2), q, w, n, pre=tw, post=tab1d)  # [j2, j1]
    return a.transpose(1, 2).reshape(rows, n)  # x[j1 * n2 + j2]
