"""Per-kernel benchmark and bounds on the card.

Counterpart of gpufhe_tpu/utils/benchkit.py. `time_it` times one function:
with CUDA events when its tensors lie on the card, with a synchronised host
clock on the CPU. `bench_all` times the reference's rows (add_mod, mont_mul,
mul_mod, ntt_fwd, ntt_inv, mod_up, mod_down, ks_mac, key_switch) under the
reference's names, each beside its bound on the card.

The bounds are the card's, never a TPU's: `Bounds` gives the least time the
card could take for each kernel launch's work at the run's shapes, from the
card's memory rate (HBM_BYTES_PER_S) and the integer rates that the P2 probe
(ops/probes.py, csrc/int_rate.cu) measures in the same process
(`measured_bounds`). chip_smoke.py and `bench_all` use this one copy.
"""

from __future__ import annotations

import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)


class Bounds:
    """The least time the card could take for each kernel launch's work, at
    this run's shapes and rates: the larger of the bytes (each input read
    once, each output written once) at HBM_BYTES_PER_S and the operations
    the function needs: modular products of 30-bit residues (and reductions
    of a 64-bit sum) at the best modular rate measured by P2 (shoup32), and
    32 x 32 -> 64-bit multiply-adds at the muladd rate. Modular additions
    are not counted. Sums of products below 2^60 stay unreduced for up to
    16 terms (below 2^64), so a sum of m terms needs ceil(m / 16)
    reductions.
    K1 needs its data and, per selected prime, q, mu, the n1/2 + n2/2 roots
    of its two passes, the n1 psi1 twists and the n1 + 2 n2 twiddle
    factors; a negacyclic NTT of N points needs N/2 log N products (the
    twist merged into the butterflies' roots, no four-step twiddle).
    K3 needs its data and tables; per coefficient, v_i = x_i Qhat_i^-1 once
    per source limb (S N products), then per destination S multiply-adds
    and ceil(S / 16) reductions. Its fused ModDown of B components is B such
    conversions that also read the Q rows and the addend's rows, with one
    product per output residue (P^-1) and one per addend residue.
    K4 needs x, its key stacks, its outputs and per row q, mu, qinv_neg and
    two indices (a permutation: N more words); per output, D multiply-adds,
    ceil(D / 16) reductions and one REDC.
    A work is (bytes, modular products, multiply-adds)."""

    def __init__(self, n: int, n1: int, n2: int, mod_rate: float, muladd_rate: float):
        self.n, self.n1, self.n2 = n, n1, n2
        self.mod_rate, self.muladd_rate = mod_rate, muladd_rate

    @staticmethod
    def _reductions(terms):
        return -(-terms // 16)

    def ntt(self, rows, limbs):
        n, n1, n2 = self.n, self.n1, self.n2
        per_prime = 2 + n1 // 2 + n2 // 2 + n1 + n1 + 2 * n2
        nbytes = 8 * (2 * rows * n + limbs * per_prime) + 4 * limbs
        return nbytes, rows * (n // 2) * (n.bit_length() - 1), 0

    def conv(self, s_dim, t_dim):
        n = self.n
        nbytes = 8 * (s_dim * n + t_dim * n + 3 * s_dim + 2 * t_dim + s_dim * t_dim)
        return nbytes, s_dim * n + t_dim * n * self._reductions(s_dim), s_dim * t_dim * n

    def mod_down(self, b_dim, s_dim, t_dim, add_rows):
        conv = self.conv(s_dim, t_dim)
        residues = t_dim * self.n * (b_dim + add_rows)
        return (b_dim * conv[0] + 8 * residues + 16 * t_dim, b_dim * conv[1] + residues,
                b_dim * conv[2])

    def mac(self, d_dim, t_dim, permuted=False, outs=2):
        n = self.n
        nbytes = (8 * n * ((1 + outs) * d_dim * t_dim + outs * t_dim) + 32 * t_dim
                  + 4 * n * permuted)
        return (nbytes, outs * t_dim * n * (self._reductions(d_dim) + 1),
                outs * d_dim * t_dim * n)

    def ms(self, nbytes, nmod, nmuladd) -> tuple[float, str]:
        b = nbytes / HBM_BYTES_PER_S * 1e3
        o = (nmod / self.mod_rate + nmuladd / self.muladd_rate) * 1e3
        return (b, "bytes") if b >= o else (o, "operations")

    def record(self, fn) -> dict:
        """Call fn once with the three kernels' wrappers recording the work of
        each launch: {"ntt": [work, ...], "convert": [...], "mac": [...]}. On
        the CPU each call of a kernel's plain version counts as its launch,
        a conversion of int64[B, S, N] as B of them."""
        from gpufhe_tpu_torch.ops import convert_cuda, mac_cuda, ntt_cuda

        seen = {"ntt": [], "convert": [], "mac": []}
        names = ((ntt_cuda, "fourstep_cuda"), (ntt_cuda, "fourstep_plain"),
                 (convert_cuda, "base_convert_cuda"), (convert_cuda, "base_convert_plain"),
                 (convert_cuda, "mod_down_cuda"), (mac_cuda, "mac_cuda"), (mac_cuda, "mac_plain"))
        real = [getattr(mod, name) for mod, name in names]

        def ntt_rec(real_fn):
            def rec(x, idx_, ctx_, inverse, *kernel):
                seen["ntt"].append(self.ntt(x.shape[0], idx_.numel()))
                return real_fn(x, idx_, ctx_, inverse, *kernel)
            return rec

        def conv_rec(real_fn):
            def rec(x, tabs, *args, **kwargs):
                rows = x.numel() // (x.shape[-2] * x.shape[-1])
                seen["convert"].extend([self.conv(x.shape[-2], tabs.dq.numel())] * rows)
                return real_fn(x, tabs, *args, **kwargs)
            return rec

        def down_rec(real_fn):
            def rec(acc, tabs, table, addend=None, *args, **kwargs):
                seen["convert"].append(self.mod_down(acc.shape[0], tabs.sq.numel(),
                                                     tabs.dq.numel(),
                                                     0 if addend is None else addend.shape[0]))
                return real_fn(acc, tabs, table, addend, *args, **kwargs)
            return rec

        def mac_rec(real_fn):
            def rec(x, y0, y1, rows, chain, ctx_, perm=None, out=None):
                seen["mac"].append(self.mac(x.shape[0], x.shape[1], perm is not None,
                                            1 if y1 is None else 2))
                return real_fn(x, y0, y1, rows, chain, ctx_, perm, out)
            return rec

        wraps = (ntt_rec, ntt_rec, conv_rec, conv_rec, down_rec, mac_rec, mac_rec)
        for (mod, name), wrap, fn_ in zip(names, wraps, real):
            setattr(mod, name, wrap(fn_))
        try:
            fn()
        finally:
            for (mod, name), fn_ in zip(names, real):
                setattr(mod, name, fn_)
        return seen

    def report(self, what: str, fn) -> dict:
        """Print each kernel's summed bound over one call of fn; returns
        {kernel: (bound ms, launches)}."""
        out = {}
        for key, work in self.record(fn).items():
            ms = sum(self.ms(*w)[0] for w in work)
            out[key] = (ms, len(work))
            print(f"bound per {what} {key}: {ms:.4f} ms over {len(work)} launches, "
                  f"{sum(w[0] for w in work) / 1e6:.2f} MB, "
                  f"{sum(w[1] for w in work) / 1e6:.1f} M modular products, "
                  f"{sum(w[2] for w in work) / 1e6:.1f} M multiply-adds", flush=True)
        return out


def measured_bounds(ctx) -> Bounds:
    """Bounds at ctx's ring, with the integer rates that P2 measures now on
    ctx's card: a modular product at the better of the modmul and shoup32
    rates, a multiply-add at the muladd rate."""
    from gpufhe_tpu_torch.ops import probes

    rates = {mix: probes.int_rate(mix, ctx.device)["rate"] for mix in probes.MIXES}
    return Bounds(ctx.n, ctx.n1, ctx.n2, max(rates["modmul"], rates["shoup32"]),
                  rates["muladd"])


def time_it(fn, *args, iters: int = 20, warmup: int = 2) -> float:
    """Seconds per call of fn(*args): by CUDA events when a tensor argument
    lies on the card, else by the host clock (the card synchronised first
    when one is present)."""
    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    for _ in range(warmup):
        fn(*args)
    if on_card:
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 1e3 / iters
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def bench_all(preset_name: str = "config5_boot", iters: int = 20, *,
              device: str = "cuda") -> list[dict]:
    """One row per reference kernel name at the preset's top level, on
    `device`: {"kernel", "ms", "GB/s"}, and on the card also "bound_ms",
    "bound_by", "x_bound" (ms over bound) and "launches" (K1, K3 and K4 per
    call). A row's bytes and bound are its kernel launches' (Bounds: each
    input read once, each output written once), or for the three elementwise
    rows the int64 operands read and the result written; the elementwise
    work between a composite row's launches is not counted, so its bound is
    a floor. Residues are int64, 8 bytes each."""
    from gpufhe_tpu_torch.keys.keys import keygen
    from gpufhe_tpu_torch.ops import modops
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
    from gpufhe_tpu_torch.params.params import preset
    from gpufhe_tpu_torch.primitives import keyswitch as ksw
    from gpufhe_tpu_torch.primitives import rns

    params = preset(preset_name)
    ctx = make_context(params, device=device)
    L, n = params.num_limbs, params.n
    level = L
    bounds = measured_bounds(ctx) if ctx.device.type == "cuda" else None
    rng = np.random.default_rng(0)

    def limbs(rows) -> torch.Tensor:
        q = np.asarray([ctx.primes[r] for r in rows], dtype=np.int64)[:, None]
        return torch.from_numpy(rng.integers(0, q, size=(len(rows), n))).to(ctx.device)

    x, y = limbs(range(L)), limbs(range(L))
    rows_l = range(L)
    qb, qinvb, r2b = ctx.col("q", rows_l), ctx.col("qinv_neg", rows_l), ctx.col("r2", rows_l)
    qp_idx = ksw.qp_indices(params, level)
    xp = limbs(qp_idx)
    ksc = rns.make_ks_context(params, level, device=ctx.device)
    chest = keygen(params, np.random.default_rng(1), ctx=ctx)
    raised = torch.stack([xp] * params.dnum)
    elementwise = 3 * 8 * L * n  # two int64 operands read, one written

    cases = [
        ("add_mod", lambda a, b: modops.add_mod(a, b, qb), (x, y), (elementwise, 0, 0)),
        ("mont_mul", lambda a, b: modops.mont_mul(a, b, qb, qinvb), (x, y),
         (elementwise, L * n, 0)),
        ("mul_mod", lambda a, b: modops.mul_mod(a, b, qb, qinvb, r2b), (x, y),
         (elementwise, 2 * L * n, 0)),
        ("ntt_fwd", lambda a: ntt_fwd(a, ctx, limbs=range(L)), (x,), None),
        ("ntt_inv", lambda a: ntt_inv(a, ctx, limbs=range(L)), (x,), None),
        ("mod_up", lambda a: rns.mod_up(a, params, level, ctx, ksc), (x,), None),
        ("mod_down", lambda a: rns.mod_down(a, params, level, ctx, ksc), (xp,), None),
        ("ks_mac", lambda r: ksw.gadget_mac(r, params, level, ctx, chest.device_rlk),
         (raised,), None),
        ("key_switch", lambda a: ksw.key_switch_core(a, params, level, ctx, ksc,
                                                     chest.device_rlk), (x,), None),
    ]
    out = []
    for name, fn, args, work in cases:
        dt = time_it(fn, *args, iters=iters)
        r = {"kernel": name, "ms": round(dt * 1e3, 4)}
        if bounds is None:
            if work is not None:
                r["GB/s"] = round(work[0] / dt / 1e9, 3)
            out.append(r)
            continue
        works = [work] if work is not None else [
            w for ws in bounds.record(lambda: fn(*args)).values() for w in ws]
        nbytes = sum(w[0] for w in works)
        sides = [bounds.ms(*w) for w in works]
        bound = sum(ms for ms, _ in sides)
        r["GB/s"] = round(nbytes / dt / 1e9, 3)
        r["bound_ms"] = round(bound, 5)
        r["bound_by"] = "bytes" if all(by == "bytes" for _, by in sides) else "operations"
        r["x_bound"] = round(dt * 1e3 / bound, 2)
        r["launches"] = 0 if work is not None else len(works)
        out.append(r)
    return out


if __name__ == "__main__":
    import json
    import os

    for row in bench_all(os.environ.get("BENCH_PRESET", "config5_boot")):
        print(json.dumps(row))
