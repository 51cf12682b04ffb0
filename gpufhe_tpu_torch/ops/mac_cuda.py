"""Kernel K4: the key-switch digit multiply-accumulate (csrc/mac.cu), its
wrapper and its plain PyTorch version.

Counterpart of scripts/dw_mac_probe.py pallas_mac, the TPU kernel of the
reference's key-switch inner product (gpufhe_tpu/ops/modops.py mont_mac).
For x int64[D, T, N] and two stacks y0, y1 int64[>= D, S, N],

    out_j[t, c] = sum_d x[d, t, perm[c]] * y_j[d, rows[t], c] * 2^-32  mod q_t

canonical, for j = 0, 1 (perm is the identity when not given; with y1 None,
for j = 0 alone). `rows` picks
row t's row of y (a gadget key stored above the level in use keeps its
layout), `chain` names row t's prime in the context's full chain. With y in
Montgomery form this is sum_d x_d * y_d mod q, the inner product of every
key switch (x = the raised digits, y = the key), of a hoisted rotation (x
gathered by the automorphism through perm) and of a plaintext MAC (x = the
plaintexts, y = the ciphertext components).

A CPU tensor runs `mac_plain` (ops/modops.py mont_mac); a CUDA tensor
launches the kernel, one launch for both outputs. `out`, when given, is
where the outputs go: int64[outputs, T, N] whose every out[j] is contiguous
(a view such as acc[:, j] of a stack the caller sums over next). `mac_each`
applies one x to many key stacks (a batch of hoisted rotations' steps):
one launch each, made back to back once the arguments are checked.
"""

from __future__ import annotations

import ctypes

import torch

from gpufhe_tpu_torch.ops.context import Context
from gpufhe_tpu_torch.ops.cuda_build import CudaKernel
from gpufhe_tpu_torch.ops.modops import mont_mac

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel(
    "mac", "mac_launch",
    [_P, _P, _P, _P, _P, _I, _I, _I, _L, _P, _P, _P, _P, _P, _P, _P],
)


def mac(x: torch.Tensor, y0: torch.Tensor, y1: torch.Tensor | None, rows: torch.Tensor,
        chain: torch.Tensor, ctx: Context, perm: torch.Tensor | None = None,
        out: torch.Tensor | None = None):
    """int64[2, T, N] holding (out0, out1), canonical (int64[1, T, N] when y1
    is None); rows, chain int32[T], perm int32[N]."""
    if x.device.type == "cpu":
        return mac_plain(x, y0, y1, rows, chain, ctx, perm, out)
    return mac_cuda(x, y0, y1, rows, chain, ctx, perm, out)


def _check_out(out, n_out: int, t_dim: int, n: int, like: torch.Tensor) -> None:
    if (out.shape != (n_out, t_dim, n) or out.dtype != torch.int64 or out.device != like.device
            or not all(o.is_contiguous() for o in out)):
        raise ValueError(f"out must be int64[{n_out}, {t_dim}, {n}] on the data's device, "
                         "each output contiguous")


def _check(x, y0, y1, rows, chain, ctx: Context, perm) -> None:
    d_dim, t_dim, n = x.shape
    ys = (y0,) if y1 is None else (y0, y1)
    for name, v in (("x", x), *zip(("y0", "y1"), ys)):
        if v.device.type != "cuda" or v.dtype != torch.int64 or not v.is_contiguous():
            raise ValueError(f"mac_cuda takes contiguous int64 CUDA tensors ({name})")
    if any(y.shape != y0.shape for y in ys) or y0.dim() != 3 or y0.shape[0] < d_dim \
            or y0.shape[2] != n:
        raise ValueError(f"key stacks {[tuple(y.shape) for y in ys]} do not fit "
                         f"x {tuple(x.shape)}")
    idx = [("rows", rows, t_dim), ("chain", chain, t_dim)]
    if perm is not None:
        idx.append(("perm", perm, n))
    for name, v, size in idx:
        if v.dtype != torch.int32 or v.device != x.device or v.numel() != size:
            raise ValueError(f"{name} must be int32[{size}] on the data's device")
    if ctx.device != x.device:
        raise ValueError("the context's tables lie on another device")


def mac_cuda(x, y0, y1, rows, chain, ctx: Context, perm=None, out=None):
    _check(x, y0, y1, rows, chain, ctx, perm)
    d_dim, t_dim, n = x.shape
    ys = (y0,) if y1 is None else (y0, y1)
    if out is None:
        out = torch.empty((len(ys), t_dim, n), dtype=torch.int64, device=x.device)
    else:
        _check_out(out, len(ys), t_dim, n, x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    KERNEL.launch(
        x.data_ptr(), y0.data_ptr(), None if y1 is None else y1.data_ptr(),
        out[0].data_ptr(), out[-1].data_ptr(),
        d_dim, t_dim, n, y0.shape[1] * n, rows.data_ptr(), chain.data_ptr(),
        None if perm is None else perm.data_ptr(),
        ctx.q.data_ptr(), ctx.mu.data_ptr(), ctx.qinv_neg.data_ptr(), stream,
    )
    return out


def mac_each(x: torch.Tensor, pairs, rows, chain: torch.Tensor, ctx: Context, perms,
             out: torch.Tensor) -> torch.Tensor:
    """out[:, i] = mac(x, *pairs[i], rows[i], chain, ctx, perms[i]) for every
    i: one x against many key stacks, as a hoisted rotation's steps read the
    raised digits through their automorphisms and keys. out is int64[2,
    len(pairs), T, N], contiguous. On the card one K4 launch a pair, made
    back to back once every argument is checked."""
    if x.device.type == "cpu":
        for i, ((y0, y1), r, p) in enumerate(zip(pairs, rows, perms, strict=True)):
            mac_plain(x, y0, y1, r, chain, ctx, p, out[:, i])
        return out
    d_dim, t_dim, n = x.shape
    if out.shape != (2, len(pairs), t_dim, n) or out.dtype != torch.int64 \
            or not out.is_contiguous() or out.device != x.device:
        raise ValueError(f"out must be contiguous int64[2, {len(pairs)}, {t_dim}, {n}] on the "
                         "data's device")
    for (y0, y1), r, p in zip(pairs, rows, perms, strict=True):
        _check(x, y0, y1, r, chain, ctx, p)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    base, step, half = out.data_ptr(), out.stride(1) * 8, out.stride(0) * 8
    x_ptr, chain_ptr = x.data_ptr(), chain.data_ptr()
    tabs = (ctx.q.data_ptr(), ctx.mu.data_ptr(), ctx.qinv_neg.data_ptr(), stream)
    for i, ((y0, y1), r, p) in enumerate(zip(pairs, rows, perms)):
        o = base + i * step
        KERNEL.launch(x_ptr, y0.data_ptr(), y1.data_ptr(), o, o + half, d_dim, t_dim, n,
                      y0.shape[1] * n, r.data_ptr(), chain_ptr, p.data_ptr(), *tabs)
    return out


def mac_plain(x, y0, y1, rows, chain, ctx: Context, perm=None, out=None):
    """The same function as today's int64 composition (ops/modops.py mont_mac)."""
    d_dim, t_dim, n = x.shape
    ys = (y0,) if y1 is None else (y0, y1)
    if perm is not None:
        x = x[:, :, perm.long()]
    rows, chain = rows.long(), chain.long()
    q, qinv = ctx.q[chain][:, None], ctx.qinv_neg[chain][:, None]
    res = torch.stack([mont_mac([(x[d], y[d][rows]) for d in range(d_dim)], q, qinv)
                       for y in ys])
    if out is None:
        return res
    _check_out(out, len(ys), t_dim, n, x)
    return out.copy_(res)
