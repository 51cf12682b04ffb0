"""Card-side counterparts of the TPU probes: the integer rate (P2,
scripts/vpu_peak.py make_prog) and the NTT ablation (P1, scripts/ntt_ablate.py
make_fn). Neither lies on a path of the package; chip_smoke.py runs both.

int_rate (csrc/int_rate.cu) times `depth` serial steps of one mix on 8
independent chains per thread over a grid that fills every SM, subtracts a
floor run at a small depth, and returns steps per second: `muladd` (v = v *
c0 + c1 in 32 bits), `modmul` (csrc/modarith.cuh mul_mod, the 64-bit
Barrett product that K3 and K4 run) and `shoup32` (mul_mod_shoup32, the
same product in 32-bit words against a precomputed constant, the product
K1 is built from: the card's rate for a modular product of 30-bit
residues). `int_rate_plain` computes the same chains with int64 PyTorch
ops, for the check.

The K1 ablation times timing-only builds of csrc/ntt.cu (ops/cuda_build.py
LIBS, -DNTT_ABLATE=k): no_modmul, no_twiddle, copy_only, natural_store and
narrow_tfast, beside K1 itself (`full`). natural_store is K1 with the
exchange tile unpadded (its bank conflicts) and narrow_tfast K1 with pass
B's t-fast side one u32 word per thread (64-byte row segments, not 128), so
both still compute the NTT; copy_only
computes two bit-reversed transposes (`copy_only_plain`); no_modmul and
no_twiddle are wrong by design, as the TPU probe's are.
"""

from __future__ import annotations

import ctypes

import torch

from gpufhe_tpu_torch.ops import ntt_cuda
from gpufhe_tpu_torch.ops.cuda_build import CudaKernel

_P, _I, _U, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_ulonglong
INT_RATE = CudaKernel("int_rate", "int_rate_launch",
                      [_P, _I, _I, _I, _U, _U, _U64, _U64, _U64, _U, _P])
THREADS, CHAINS = 256, 8  # csrc/int_rate.cu kThreads, kChains
MIXES = ("muladd", "modmul", "shoup32")
# the TPU probe's constants: an odd 32-bit multiplier, and q just below 2^30
C0, C1 = 2654435761, 40503
Q = (1 << 30) - 35
W = 998244353 % Q
MU = (1 << 64) // Q
WP = (W << 32) // Q  # Shoup's w' for shoup32

ABLATIONS = ("no_modmul", "no_twiddle", "copy_only", "natural_store", "narrow_tfast")
ABLATION_KERNELS = {v: CudaKernel(f"ntt_{v}", "ntt_fourstep", ntt_cuda.KERNEL.argtypes)
                    for v in ABLATIONS}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def int_rate_cuda(mix: str, blocks: int, depth: int, device) -> torch.Tensor:
    """The xor of each thread's chains after `depth` steps: int64[blocks * 256]."""
    out = torch.empty(blocks * THREADS, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    INT_RATE.launch(out.data_ptr(), MIXES.index(mix), blocks, depth, C0, C1, W, Q, MU, WP,
                    stream)
    return out


def int_rate_plain(mix: str, blocks: int, depth: int, device) -> torch.Tensor:
    threads = blocks * THREADS
    s = torch.arange(threads * CHAINS, dtype=torch.int64, device=device).view(threads, CHAINS)
    v = s & 0xFFFFFFFF if mix == "muladd" else torch.remainder(s, Q)
    for _ in range(depth):
        # int64 products wrap modulo 2^64, so the low 32 bits are exact
        v = (v * C0 + C1) & 0xFFFFFFFF if mix == "muladd" else torch.remainder(v * W, Q)
    acc = v[:, 0]
    for k in range(1, CHAINS):
        acc = acc ^ v[:, k]
    return acc


def int_rate(mix: str, device, depth: int = 4096, floor_depth: int = 512,
             blocks_per_sm: int = 8) -> dict:
    """Steps per second of one mix on the card (floor-subtracted)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = sms * blocks_per_sm
    full = cuda_ms(lambda: int_rate_cuda(mix, blocks, depth, device), iters=10)
    floor = cuda_ms(lambda: int_rate_cuda(mix, blocks, floor_depth, device), iters=10)
    steps = blocks * THREADS * CHAINS * (depth - floor_depth)
    return {"mix": mix, "blocks": blocks, "depth": depth, "floor_depth": floor_depth,
            "ms": full, "floor_ms": floor, "steps": steps,
            "rate": steps / ((full - floor) * 1e-3)}


def ntt_ablation(x: torch.Tensor, idx: torch.Tensor, ctx, iters: int = 20) -> dict:
    """Forward-transform ms per call of K1 (`full`) and each ablation build."""
    times = {"full": cuda_ms(lambda: ntt_cuda.fourstep_cuda(x, idx, ctx, False), iters)}
    for name, kernel in ABLATION_KERNELS.items():
        times[name] = cuda_ms(lambda: ntt_cuda.fourstep_cuda(x, idx, ctx, False, kernel), iters)
    return times


def copy_only_plain(x: torch.Tensor, ctx) -> torch.Tensor:
    """What the copy_only build computes for a forward call of int64[rows, N]
    of residues below 2^32 (the u32 scratch): pass A's bit-reversed order
    over j1 (register and exchange positions), then pass B's over j2 with
    the transposed store, y[k2 * n1 + k1] = x[bitrev(k1) * n2 + bitrev(k2)]."""
    rows, n1, n2 = x.shape[0], ctx.n1, ctx.n2
    b1, b2 = ntt_cuda.bitrev(n1, x.device), ntt_cuda.bitrev(n2, x.device)
    return x.view(rows, n1, n2)[:, b1][:, :, b2].transpose(1, 2).reshape(rows, n1 * n2)
