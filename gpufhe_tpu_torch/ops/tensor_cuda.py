"""The tensor kernel (csrc/tensor.cu): the ciphertext tensor of two
2-component ciphertexts in one pass, its wrapper and its plain PyTorch
version.

For NTT-domain canonical residues a0, a1, b0, b1: int64[K, N], `tensor`
returns one int64[3, K, N] stack

    d0 = a0 b0,   d1 = a0 b1 + a1 b0,   d2 = a1 b1          mod q_r

where q_r is the context's chain row r < K (the reference's
_tensor_core, gpufhe_tpu/ciphertext/ct.py:112). Its first two rows are a
contiguous [2, K, N] view, what the relinearisation's iNTT reads, and its
third the key switch's input, so no caller stacks them again. A CPU tensor
runs `tensor_plain`, the add_mod / mul_mod formula; a CUDA tensor launches
the kernel once (no fallback). The kernel computes in 32-bit words, so it
takes primes below 2^30, as every chain of params/params.py has them.
"""

from __future__ import annotations

import ctypes

import torch

from gpufhe_tpu_torch.ops.context import Context
from gpufhe_tpu_torch.ops.cuda_build import CudaKernel
from gpufhe_tpu_torch.ops.modops import add_mod, mul_mod

MAX_PRIME = 1 << 30

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# a0, a1, b0, b1, their limb strides, out, K, n, chain, q, mu, stream
KERNEL = CudaKernel("tensor", "tensor_launch", [_P] * 4 + [_L] * 4 + [_P, _I, _I, _P, _P, _P, _P])


def tensor(ca, cb, ctx: Context, level: int) -> torch.Tensor:
    """(a0, a1) x (b0, b1) -> int64[3, level, N] holding (d0, d1, d2), limb
    r mod the chain's prime r."""
    (a0, a1), (b0, b1) = ca, cb
    rows = range(level)
    if a0.device.type == "cpu":
        return tensor_plain(a0, a1, b0, b1, ctx.col("q", rows))
    return tensor_cuda(a0, a1, b0, b1, ctx.index(rows, torch.int32), ctx)


def tensor_cuda(a0, a1, b0, b1, chain: torch.Tensor, ctx: Context) -> torch.Tensor:
    """One launch; every operand int64[K, N] on the card with coefficient
    stride 1, an even limb stride and a 16-byte aligned start (the kernel's
    16-byte accesses), chain int32[K] on the same device."""
    xs = (a0, a1, b0, b1)
    k_dim, n = a0.shape if a0.dim() == 2 else (0, 0)
    for name, x in zip(("a0", "a1", "b0", "b1"), xs):
        if x.dtype != torch.int64 or x.shape != (k_dim, n) or k_dim < 1 or n % 2:
            raise ValueError(f"tensor_cuda takes four int64[K, N] operands of one shape, N "
                             f"even ({name}: {x.dtype}{list(x.shape)})")
        if x.stride(1) != 1 or x.stride(0) % 2 or x.data_ptr() % 16:
            raise ValueError(f"tensor_cuda needs coefficient stride 1, an even limb stride "
                             f"and a 16-byte aligned start ({name})")
        if x.device != a0.device:
            raise ValueError(f"tensor_cuda takes its operands on one device ({name})")
    if chain.dtype != torch.int32 or chain.device != a0.device or chain.numel() != k_dim:
        raise ValueError(f"chain must be int32[{k_dim}] on the data's device")
    if ctx.device != a0.device:
        raise ValueError("the context's tables lie on another device")
    if max(ctx.primes) >= MAX_PRIME:
        raise ValueError("the tensor kernel's 32-bit arithmetic needs every prime below 2^30")
    if a0.device.type != "cuda":
        raise ValueError("tensor_cuda takes CUDA tensors: the kernel has no CPU mode")
    out = torch.empty((3, k_dim, n), dtype=torch.int64, device=a0.device)
    stream = torch.cuda.current_stream(a0.device).cuda_stream
    KERNEL.launch(*(x.data_ptr() for x in xs), *(x.stride(0) for x in xs), out.data_ptr(),
                  k_dim, n, chain.data_ptr(), ctx.q.data_ptr(), ctx.mu.data_ptr(), stream)
    return out


def tensor_plain(a0, a1, b0, b1, q: torch.Tensor) -> torch.Tensor:
    """The same stack in int64 ops (q: the [K, 1] primes)."""
    d1 = add_mod(mul_mod(a0, b1, q), mul_mod(a1, b0, q), q)
    return torch.stack([mul_mod(a0, b0, q), d1, mul_mod(a1, b1, q)])
