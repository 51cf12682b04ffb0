"""Benchmark: the port's headline operations on one card, one JSON line each.

Counterpart of the reference's root bench.py, with its output lines and
their keys, each measured here on the card (none is read from a file):

    python -m gpufhe_tpu_torch.cli bench [--preset config5_boot]
    python -m gpufhe_tpu_torch.cli --cpu bench --preset ci_small

The lines, in the reference's order: the N=2^16 double-word bootstrap
(steady seconds), the deep MLP through mid-inference bootstraps (s per
forward), the MNIST-shaped MLP at N=2^15 (ms per forward), the NTT over the
full q-chain (polys/s) and its config5_boot_s29 twin, the s29 multiply, the
mesh's numeric parity, the BFV and BGV multiplies at bfv_n16, the
double-word multiply, and LAST the --preset multiply (the primary line).

The multiply lines time a chain of genuinely data-dependent ct_mul_full
calls (bench.py's method): step i+1 multiplies step i's output, padded
back to the level with the old operand's top scale_words rows, by the old
operand. An empty chain with the same carry (the floor) is subtracted, and
the carry's concatenation alone (the rebuild) is timed apart. Each pass is
timed with CUDA events around the whole chain after a warm-up pass, the best
of `iters` passes kept (the reference's choice); every pass and the median
are printed on a `#` line. On the CPU (only when asked for) a synchronised
host clock stands in. Eager PyTorch runs the chain on one stream, so the
floor is nearly empty; neither subtraction may go below zero.

Keys left out of the reference's multiply line: mxu_floor_ms and
traffic_xla_mb (a TPU's MXU and XLA's cost analysis), carry_layout (a jit
carry's view) and profiler_composite_ms (a TPU stage-profile file). sol_kind
is always "physics" and sol_ms the HBM floor of `_traffic_estimate`, the
card's bytes: K1, K3 and K4 launches counted as utils/benchkit.py Bounds
counts them, the elementwise passes by the reference's pass counts at 8
bytes per residue. Every line adds "device": nvidia-smi's name and power
limit, or "cpu". Dropped elsewhere: the NTT line's siblings, vpu_model and
recon_ms; the BFV and BGV lines' vs_baseline (a TPU stage sum); BFV's
vs_ckks_mult is the ratio to the --preset multiply of the same run.

Each line's set-up is the reference script's it replaces:
scripts/bootstrap_n16_dw.py, deep_mlp_n16.py, mlp_n15.py, ntt_bench.py,
exec_n16_mesh.py, bgv_n16_mult.py and bfv_n16_mult.py. Between lines every
key and plan is freed; each line's seconds and peak device memory go on a
`#` line. Environment: BENCH_PRESET (default config5_boot), BENCH_CHAIN
(128), BENCH_ITERS (3), BENCH_DW=0 to skip the double-word line,
PEAK_HBM_GBPS (bytes/s, default the card's 3.35e12). Without a card, and
without --cpu, it stops with an error: it never falls back to the CPU.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import time

import numpy as np
import torch

from gpufhe_tpu_torch.utils import benchkit

PEAK_HBM_GBPS = benchkit.HBM_BYTES_PER_S  # bytes/s, the name the reference gives it
# the profiler's names of the three kernels (K1's two passes share its name)
KERNEL_NAMES = {"K1": "k1_pass", "K3": "base_convert_kernel", "K4": "mac_kernel"}


def _card(device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if torch.device(device).type == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _on_card(device):
        torch.cuda.synchronize(device)


def _random_key(params, rng: np.random.Generator, device):
    """Uniform random key-shaped material (timing paths only): the numpy
    draws of the reference's __graft_entry__._random_key, in its order."""
    from gpufhe_tpu_torch.interop import ks_key_from_numpy

    qp = np.asarray(params.q_primes + params.p_primes, dtype=np.uint32)
    shape = (params.dnum, len(qp), params.n)
    b = rng.integers(0, qp[None, :, None], size=shape, dtype=np.uint32)
    a = rng.integers(0, qp[None, :, None], size=shape, dtype=np.uint32)
    return ks_key_from_numpy(b, a, device)


def _random_ct(params, level: int, rng: np.random.Generator, device):
    """Two uniform [level, N] components (the reference's _random_ct)."""
    from gpufhe_tpu_torch.interop import ciphertext_from_numpy

    q = np.asarray(params.q_primes[:level], dtype=np.uint32)
    comps = [rng.integers(0, q[:, None], size=(level, params.n), dtype=np.uint32)
             for _ in range(2)]
    return ciphertext_from_numpy(comps, level, params.scale, device)


def _chain(step, chain: int):
    def run(carry):
        for _ in range(chain):
            carry = step(carry)
        return carry

    return run


def _timed(fn, device) -> tuple[float, object]:
    """Seconds of one call of fn (CUDA events on the card, a synchronised
    host clock on the CPU) and its output."""
    if not _on_card(device):
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / 1e3, out


def _call_times(fn, calls: int, device) -> tuple[list[float], object]:
    """Seconds of each of `calls` calls of fn, each timed alone, and the last
    output."""
    out, secs = None, []
    for _ in range(calls):
        sec, out = _timed(fn, device)
        secs.append(sec)
    return secs, out


def _passes(run, carry, iters: int, device) -> tuple[list[float], object]:
    """One warm-up pass, then `iters` timed passes, each from the last one's
    output: (seconds per pass, the last carry)."""
    carry = run(carry)
    _sync(device)
    secs = []
    for _ in range(iters):
        sec, carry = _timed(lambda c=carry: run(c), device)
        secs.append(sec)
    return secs, carry


def _best(tag: str, what: str, secs: list[float]) -> float:
    print(f"# [{tag}] {what} passes {[round(s * 1e3, 4) for s in secs]} ms, median "
          f"{float(np.median(secs)) * 1e3:.4f}, best {min(secs) * 1e3:.4f}", flush=True)
    return min(secs)


def _traffic_estimate(params, level: int, hbm_bw: float, one_mult):
    """Bytes one ct_mul_full at `level` moves, and their time at hbm_bw: each
    K1, K3 and K4 launch of one call of one_mult (found by running it)
    counted by Bounds (each input read once, each output written once), plus
    the elementwise passes by the reference's counts (bench.py:87-95) at 8
    bytes per residue: the tensor reads 4 limb planes and writes 3; ModDown
    and the chained rescales make about 8 read-write passes over k limbs.
    The reference's key-MAC term is K4's launch here, counted by Bounds.
    Returns (bytes, seconds, {kernel: launches})."""
    from gpufhe_tpu_torch.ops.context import fourstep_split

    n1, n2 = fourstep_split(params.n)
    work = benchkit.Bounds(params.n, n1, n2, 1.0, 1.0).record(one_mult)  # bytes only
    kernel_bytes = sum(w[0] for ws in work.values() for w in ws)
    limb_bytes = params.n * 8
    ew_bytes = 7 * level * limb_bytes + 8 * level * limb_bytes
    total = kernel_bytes + ew_bytes
    return total, total / hbm_bw, {k: len(ws) for k, ws in work.items()}


def bench_mult(preset_name: str, chain: int, iters: int, hbm_bw: float, *,
               device: str = "cuda", out: dict | None = None) -> dict:
    """Chained-latency benchmark of ct_mul_full at a preset's top level (the
    module docstring). `out`, when given, receives the inputs ("rlk", "a",
    "b"), the chain's final carry ("carry": the pair after every step of the
    warm-up and timed passes) and the steps taken ("steps")."""
    from gpufhe_tpu_torch.ciphertext.ct import Ciphertext, ct_mul_full
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    t0 = time.perf_counter()
    params = preset(preset_name)
    ctx = make_context(params, device=device)
    level, w = params.num_limbs, params.scale_words
    rng = np.random.default_rng(0)
    rlk = _random_key(params, rng, ctx.device)
    a = _random_ct(params, level, rng, ctx.device)
    b = _random_ct(params, level, rng, ctx.device)
    _sync(device)
    print(f"# [{preset_name}] setup {time.perf_counter() - t0:.1f}s  N={params.n} L={level} "
          f"alpha={params.alpha} dnum={params.dnum} scale_words={w}", flush=True)

    def padded(r, a):
        # r at level - w, padded with a's top w rows (stale, valid residues):
        # shape-stable, and the scale kept (the chain is a timing harness)
        return Ciphertext([torch.cat([r.c[i], a.c[i][level - w:]]) for i in range(2)], level,
                          a.scale)

    def step(carry):
        a, b = carry
        return padded(ct_mul_full(a, b, params, ctx, rlk), a), a

    def rebuild(carry):
        # the carry's concatenation alone: b's rows in a's pad, so it is no copy
        # of a
        a, b = carry
        return Ciphertext([torch.cat([b.c[i][: level - w], a.c[i][level - w:]])
                           for i in range(2)], level, a.scale), a

    floor_s = _best(preset_name, "floor", _passes(_chain(lambda c: c, chain), (a, b), iters,
                                                  device)[0])
    rebuild_s = _best(preset_name, "rebuild", _passes(_chain(rebuild, chain), (a, b), iters,
                                                      device)[0])
    rebuild_ms = max(rebuild_s - floor_s, 0.0) / chain * 1e3
    print(f"# [{preset_name}] rebuild-only chain: {rebuild_ms:.4f} ms/iter of harness concat "
          "cost", flush=True)
    secs, carry = _passes(_chain(step, chain), (a, b), iters, device)
    pass_s = _best(preset_name, "chain", secs)
    if pass_s <= floor_s:
        raise RuntimeError(f"[{preset_name}] the chain ({pass_s} s) did not outlast its empty "
                           f"floor ({floor_s} s)")
    dt = (pass_s - floor_s) / chain
    print(f"# [{preset_name}] pass {pass_s * 1e3:.3f} ms - floor {floor_s * 1e3:.3f} ms over "
          f"chain={chain}", flush=True)
    if out is not None:
        out.update(rlk=rlk, a=a, b=b, carry=carry, steps=chain * (1 + iters))

    est_bytes, hbm_s, launches = _traffic_estimate(
        params, level, hbm_bw, lambda: ct_mul_full(a, b, params, ctx, rlk))
    implied_bw = est_bytes / dt
    print(f"# [{preset_name}] traffic model {est_bytes / 1e6:.1f} MB per mult (launches "
          f"{launches}); model-implied bandwidth {implied_bw / 1e9:.0f} GB/s vs peak "
          f"{hbm_bw / 1e9:.0f} GB/s ({implied_bw / hbm_bw:.1%}); {dt * 1e3:.4f} ms/mult -> HBM "
          f"floor {hbm_s * 1e3:.4f} ms", flush=True)
    ops_per_s = 1.0 / dt
    return {
        "metric": f"ckks_mult_relin_rescale_N{params.n}_L{level}" + ("_dw" if w == 2 else ""),
        "value": round(ops_per_s, 3),
        "unit": "ops/s/chip",
        "ms_per_mult": round(dt * 1e3, 4),
        "vs_baseline": round(min(ops_per_s * hbm_s, 1.0), 4),
        "sol_kind": "physics",
        "sol_ms": round(hbm_s * 1e3, 4),
        "rebuild_overhead_ms": round(rebuild_ms, 4),
        "traffic_model_mb": round(est_bytes / 1e6),
        "implied_bw_frac_of_peak": round(implied_bw / hbm_bw, 4),
        "hbm_floor_ms": round(hbm_s * 1e3, 4),
        "device": _card(device),
    }


def _device_ms_by_kernel(fn, iters: int = 5) -> tuple[dict, dict]:
    """Device ms per call of fn by kernel (K1, K3, K4, the rest: the
    elementwise ops), from torch.profiler's kernel times of `iters` calls,
    and the launches each call makes. The profiler has been seen to drop
    launches from a trace, so a kernel's time per call is its mean per
    launch traced times the launches a call makes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gpufhe_tpu_torch.ops import convert_cuda, mac_cuda, ntt_cuda

    kernels = {"K1": ntt_cuda.KERNEL, "K3": convert_cuda.KERNEL, "K4": mac_cuda.KERNEL}
    before = {k: v.launches for k, v in kernels.items()}
    fn()
    torch.cuda.synchronize()
    made = {k: v.launches - before[k] for k, v in kernels.items()}
    made["K1"] *= 2  # K1 launches its two passes
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    traced_ms = dict.fromkeys(KERNEL_NAMES, 0.0)
    traced_n = dict.fromkeys(KERNEL_NAMES, 0)
    rest = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        ms = (ev.self_cuda_time_total if us is None else us) / 1e3
        group = next((g for g, name in KERNEL_NAMES.items() if name in ev.key), None)
        if group is None:
            rest += ms / iters
        else:
            traced_ms[group] += ms
            traced_n[group] += ev.count
    per_call = {g: traced_ms[g] / traced_n[g] * made[g] if traced_n[g] else math.nan
                for g in KERNEL_NAMES}
    per_call["rest"] = rest
    return per_call, made


def bench_int_mult(scheme: str, preset_name: str = "bfv_n16", chain: int = 64, iters: int = 3,
                   *, device: str = "cuda") -> dict:
    """ms per BGV ct_mul (tensor, relinearise, ModSwitch) or BFV ct_mul
    (tensor over the auxiliary basis, relinearise) at a preset's top level,
    chained as scripts/bgv_n16_mult.py and bfv_n16_mult.py chain them: step
    i+1 multiplies step i's output (BGV's padded back to the level with the
    old operand's last row) by the old operand, minus the empty chain. Keys
    from keygen(default_rng(0)), the message from default_rng(1), encrypted
    from default_rng(2); three squarings decrypt exactly first. On the card
    a `#` line gives the device time per ct_mul by kernel."""
    from gpufhe_tpu_torch.ciphertext import bfv, bgv
    from gpufhe_tpu_torch.golden import bfv as gbfv
    from gpufhe_tpu_torch.golden import bgv as gbgv
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    mod, gold = {"bgv": (bgv, gbgv), "bfv": (bfv, gbfv)}[scheme]
    t0 = time.perf_counter()
    params = preset(preset_name)
    ctx = make_context(params, device=device)
    t, level = params.plain_modulus, params.num_limbs
    chest = mod.keygen(params, np.random.default_rng(0), ctx=ctx)
    rlk = chest.device_rlk
    m = np.random.default_rng(1).integers(0, t, size=params.n, dtype=np.int64)
    ct = mod.encrypt(gold.encode(m, params), params, chest.device_pk, ctx, np.random.default_rng(2))
    _sync(device)
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    sq, want = ct, m.copy()
    for _ in range(3):
        sq = mod.ct_mul(sq, sq, params, ctx, rlk)
        want = want * want % t
    if not (mod.decrypt_decode(sq, params, chest.device_sk, ctx) == want).all():
        raise AssertionError(f"{scheme} at {preset_name}: three squarings do not decrypt to m^8")
    print(f"# [{scheme} {preset_name}] N={params.n} L={level} t={t}: setup {setup_s:.1f}s; "
          f"three squarings decrypt exactly ({time.perf_counter() - t0:.1f}s)", flush=True)

    def step(carry):
        c, d = carry
        r = mod.ct_mul(c, d, params, ctx, rlk)
        if scheme == "bgv":  # level - 1: padded with c's last row
            r = bgv.BGVCiphertext([torch.cat([r.c[i], c.c[i][level - 1:]]) for i in range(2)],
                                  level, c.pt_factor)
        return r, c

    floor_s = _best(scheme, "floor", _passes(_chain(lambda c: c, chain), (ct, ct), iters,
                                             device)[0])
    pass_s = _best(scheme, "chain", _passes(_chain(step, chain), (ct, ct), iters, device)[0])
    if pass_s <= floor_s:
        raise RuntimeError(f"[{scheme}] the chain did not outlast its empty floor")
    dt = (pass_s - floor_s) / chain
    if _on_card(device):
        per_call, made = _device_ms_by_kernel(lambda: mod.ct_mul(ct, ct, params, ctx, rlk))
        print(f"# [{scheme} {preset_name}] device ms per ct_mul by kernel (torch.profiler): "
              + ", ".join(f"{k} {v:.4f}" for k, v in per_call.items())
              + f"; busy {sum(per_call.values()):.4f} of {dt * 1e3:.4f}; launches per call "
              f"{made}", flush=True)
    metric = {"bgv": "bgv_mult_relin_modswitch", "bfv": "bfv_mult_relin"}[scheme]
    line = {"metric": f"{metric}_N{params.n}_L{level}", "value": round(1.0 / dt, 3),
            "unit": "ops/s/chip", "ms_per_mult": round(dt * 1e3, 4), "chain": chain}
    if scheme == "bfv":
        line["aux_limbs"] = len(bfv.make_bfv_mul_context(params, level, device=ctx.device)[0]
                                .q_primes)
    line["device"] = _card(device)
    return line


def bench_ntt(preset_name: str, chain: int, iters: int, *, device: str = "cuda") -> dict:
    """Polys/s of ntt_fwd over a preset's full q-chain, chained on its own
    output as scripts/ntt_bench.py chains it (input from default_rng(0)),
    minus the empty chain; the first transform == the golden NTT."""
    from gpufhe_tpu_torch.golden import ntt as gntt
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.ops.ntt import ntt_fwd
    from gpufhe_tpu_torch.params.params import preset

    params = preset(preset_name)
    ctx = make_context(params, device=device)
    k, n = params.num_limbs, params.n
    rng = np.random.default_rng(0)
    x_np = np.stack([rng.integers(0, q, size=n, dtype=np.int64) for q in params.q_primes[:k]])
    x = torch.from_numpy(x_np).to(ctx.device)
    limbs = range(k)
    got = ntt_fwd(x, ctx, limbs=limbs).cpu().numpy()
    want = np.stack([gntt.ntt_fwd(x_np[i], params.q_primes[i], params.psi[i])
                     for i in range(k)])
    if not (got == want).all():
        raise AssertionError(f"ntt_fwd at {preset_name} differs from the golden NTT")
    print(f"# [{preset_name}] ntt_fwd N={n} limbs={k} chain={chain}: == the golden NTT",
          flush=True)
    floor_s = _best(f"ntt {preset_name}", "floor",
                    _passes(_chain(lambda v: v, chain), x, iters, device)[0])
    pass_s = _best(f"ntt {preset_name}", "chain",
                   _passes(_chain(lambda v: ntt_fwd(v, ctx, limbs=limbs), chain), x, iters,
                           device)[0])
    if pass_s <= floor_s:
        raise RuntimeError(f"[ntt {preset_name}] the chain did not outlast its empty floor")
    dt = (pass_s - floor_s) / chain
    return {"metric": f"ntt_fwd_polys_N{n}_L{k}", "value": round(1.0 / dt, 1),
            "unit": "polys/s/chip", "us_per_limb_transform": round(dt / k * 1e6, 4),
            "limb_transforms_per_s": round(k / dt), "kernel": "K1 csrc/ntt.cu",
            "chain": chain, "device": _card(device)}


def _steady(tag: str, secs: list[float]) -> float:
    med = float(np.median(secs))
    print(f"# [{tag}] steady calls {[round(s * 1e3, 3) for s in secs]} ms, median "
          f"{med * 1e3:.3f}, spread {min(secs) * 1e3:.3f} to {max(secs) * 1e3:.3f}", flush=True)
    return med


def bench_bootstrap(preset_name: str = "config5_boot_dw", k_bound: float = 10.0,
                    steady: int = 5, *, device: str = "cuda") -> dict:
    """Seconds per steady bootstrap, set up as scripts/bootstrap_n16_dw.py
    sets it up: device_keygen(default_rng(7)) of the factored transforms'
    steps at radix_log 3 and conj, Bootstrapper(factored, radix 3, cheb,
    k_bound, fuse_evalmod, lean_keys), keys truncated per step; z = 0.2
    (N(0,1) + i N(0,1)) from default_rng(0) encrypted at level 2 from
    default_rng(1). One first call, then `steady` calls (median)."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys.device_keygen import device_keygen
    from gpufhe_tpu_torch.keys.keys import truncate_galois_device
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    radix = 3
    params = preset(preset_name)
    ctx = make_context(params, device=device)
    t0 = time.perf_counter()
    rots = bootstrap_rotations(params, transform="factored", radix_log=radix)
    chest = device_keygen(params, np.random.default_rng(7), rotations=tuple(rots),
                          conjugation=True, ctx=ctx)
    _sync(device)
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    be = DeviceBackend(params, ctx, chest)
    bs = Bootstrapper(be, transform="factored", radix_log=radix, evalmod="cheb",
                      k_bound=k_bound, fuse_evalmod=True, lean_keys=True)
    steps, conj_lvl = bs.galois_step_levels()
    truncate_galois_device(chest, steps, conj_lvl, params)
    _sync(device)
    plan_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    z = (rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots)) * 0.2
    ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                     np.random.default_rng(1), params.scale, level=2)
    (first_s,), _ = _call_times(lambda: bs(ct), 1, device)
    secs, out = _call_times(lambda: bs(ct), steady, device)
    print(f"# [bootstrap {preset_name}] device_keygen ({len(rots)} Galois keys, conj) "
          f"{keygen_s:.2f} s, plans and truncation {plan_s:.2f} s, first call {first_s:.3f} s",
          flush=True)
    steady_s = _steady(f"bootstrap {preset_name}", secs)
    err = float(np.abs(be.decrypt_decode(out) - z).max())
    return {"metric": f"ckks_bootstrap_N{params.n}_doubleword_steady",
            "value": round(steady_s, 4), "unit": "s",
            "vs_baseline": round(steady_s / 5.0, 4), "max_err": err,
            "first_s": round(first_s, 3), "device": _card(device)}


def bench_mlp(preset_name: str = "config3_ckks", dims: tuple = (784, 128, 10), steady: int = 3,
              *, device: str = "cuda") -> dict:
    """ms per forward of the square-activation MLP `dims`, set up as
    scripts/mlp_n15.py sets it up: weights and input from default_rng(1),
    device_keygen(default_rng(0)) of the stack's own steps, no conj, the
    input encrypted at the full level from default_rng(2). One first forward
    (the plans), then `steady` forwards (median); the logits within 1e-2 of
    model.reference(x), as the script asserts."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys.device_keygen import device_keygen
    from gpufhe_tpu_torch.models.mlp import EncryptedMLP, mlp_rotations_for
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    params = preset(preset_name)
    ctx = make_context(params, device=device)
    d_in, d_h, d_out = dims
    rng = np.random.default_rng(1)
    layers = [(rng.normal(size=(d_h, d_in)) * 0.1, rng.normal(size=d_h) * 0.1),
              (rng.normal(size=(d_out, d_h)) * 0.1, rng.normal(size=d_out) * 0.1)]
    t0 = time.perf_counter()
    rots = mlp_rotations_for(layers, params.slots)
    chest = device_keygen(params, np.random.default_rng(0), rotations=tuple(rots),
                          conjugation=False, ctx=ctx)
    _sync(device)
    keygen_s = time.perf_counter() - t0
    be = DeviceBackend(params, ctx, chest)
    model = EncryptedMLP(be, layers)
    x = rng.normal(size=d_in) * 0.5
    slots_x = np.zeros(params.slots, dtype=np.complex128)
    slots_x[:d_in] = x
    ct = dct.encrypt(encoder.encode(slots_x, params), params, chest.device_pk, ctx,
                     np.random.default_rng(2), params.scale)
    (first_s,), _ = _call_times(lambda: model(ct), 1, device)
    secs, out = _call_times(lambda: model(ct), steady, device)
    got = np.real(be.decrypt_decode(out)[:d_out])
    err = float(np.abs(got - model.reference(x)).max())
    if not err < 1e-2:
        raise AssertionError(f"MLP logits off model.reference by {err}")
    print(f"# [mlp {preset_name}] device_keygen ({len(rots)} Galois keys) {keygen_s:.2f} s, "
          f"first forward (plans) {first_s:.3f} s", flush=True)
    med = _steady(f"mlp {preset_name}", secs)
    return {"metric": f"encrypted_mlp_inference_N{params.n}", "value": round(med * 1e3, 3),
            "unit": "ms/forward (median of steady, CUDA events)", "arch": list(dims),
            "max_logit_err": err, "device": _card(device)}


def bench_deep_mlp(preset_name: str = "config5_boot_dw", layers: int = 5, d: int = 8,
                   in_level: int = 8, k_bound: float = 10.0, steady: int = 2, *,
                   device: str = "cuda") -> dict:
    """s per forward of `layers` layers of width d entered at `in_level`
    and refreshed mid-inference by the bootstrap, set up as
    scripts/deep_mlp_n16.py sets it up: weights from default_rng(11),
    device_keygen(default_rng(7)) of the bootstrap's steps and the MLP's,
    conj; Bootstrapper(factored, radix 3, cheb, k_bound, fuse_evalmod,
    lean_keys), keys truncated per step (the MLP's at the bootstrap's output
    level or the entry level). One first forward, then `steady` (median);
    the logits within 1e-2, as the script asserts."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys.device_keygen import device_keygen
    from gpufhe_tpu_torch.keys.keys import truncate_galois_device
    from gpufhe_tpu_torch.models.mlp import EncryptedMLP, mlp_rotations_for
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    radix = 3
    params = preset(preset_name)
    ctx = make_context(params, device=device)
    rng = np.random.default_rng(11)
    stack = [(rng.normal(size=(4 if i == layers - 1 else d, d)) * (0.5 / np.sqrt(d)),
              rng.normal(size=4 if i == layers - 1 else d) * 0.05) for i in range(layers)]
    mlp_steps = mlp_rotations_for(stack, params.slots)
    boot_rots = bootstrap_rotations(params, transform="factored", radix_log=radix)
    rots = sorted(set(boot_rots) | set(mlp_steps))
    t0 = time.perf_counter()
    chest = device_keygen(params, np.random.default_rng(7), rotations=tuple(rots),
                          conjugation=True, ctx=ctx)
    be = DeviceBackend(params, ctx, chest)
    bs = Bootstrapper(be, transform="factored", radix_log=radix, evalmod="cheb",
                      k_bound=k_bound, fuse_evalmod=True, lean_keys=True)
    steps, conj_level = bs.galois_step_levels()
    mlp_level = max(bs.f_stc.first_lo.level - bs.f_stc.levels_used, in_level)
    for s in mlp_steps:
        steps[s] = max(steps.get(s, 0), mlp_level)
    truncate_galois_device(chest, steps, conj_level, params)
    model = EncryptedMLP(be, stack, refresh=bs)
    x = rng.normal(size=d) * 0.3
    slots_x = np.zeros(params.slots, dtype=np.complex128)
    slots_x[:d] = x
    ct = dct.encrypt(encoder.encode(slots_x, params), params, chest.device_pk, ctx,
                     np.random.default_rng(2), params.scale, level=in_level)
    _sync(device)
    setup_s = time.perf_counter() - t0
    (first_s,), _ = _call_times(lambda: model(ct), 1, device)
    secs, out = _call_times(lambda: model(ct), steady, device)
    d_out = stack[-1][0].shape[0]
    got = np.real(be.decrypt_decode(out)[:d_out])
    err = float(np.abs(got - model.reference(x)).max())
    if not err <= 1e-2:
        raise AssertionError(f"deep MLP logits off model.reference by {err}")
    print(f"# [deep_mlp {preset_name}] keys ({len(rots)} Galois keys, conj) and plans "
          f"{setup_s:.2f} s, first forward {first_s:.3f} s ({model.refreshes} bootstraps)",
          flush=True)
    med = _steady(f"deep_mlp {preset_name}", secs)
    return {"metric": f"deep_mlp_bootstrap_N{params.n}_dw", "value": round(med, 4),
            "unit": "s/forward (median of steady, CUDA events)", "layers": layers,
            "mid_inference_bootstraps": model.refreshes, "logits_max_err": err,
            "device": _card(device)}


def _first_cts_stage_diags(params, radix_log: int, k_bound: float) -> dict:
    """The bootstrap's first CoeffToSlot diagonals at the full level, with
    their share of the geometric factor (scripts/exec_n16_mesh.py's
    first_cts_stage_diags)."""
    from gpufhe_tpu_torch.ciphertext import fftboot as fb

    n_s = params.slots
    fwd = [fb._inv_stage_diags(n_s, h, w) for h, w in reversed(fb._stage_twiddles(n_s))]
    groups = fb.group_stages(fwd, n_s, radix_log)
    q0 = math.prod(params.q_primes[: params.scale_words])
    return fb.scale_diags(groups[0], abs(params.scale / (q0 * k_bound)) ** (1.0 / len(groups)))


def bench_mesh_parity(preset_name: str = "config5_boot_dw", mid_level: int = 26,
                      k_bound: float = 10.0, *, device: str = "cuda") -> dict:
    """1.0 if every program of scripts/exec_n16_mesh.py's set == the single
    device on a (2, 4) mesh of eight shards on one device: eph_ks_to at the
    base level, mod_raise2, eph_ks_from and the first CoeffToSlot fan at the
    full level, the multiply at mid_level, each fed the single device's
    output of the step before (device_keygen(default_rng(7)) of the fan's
    offsets). It times nothing and measures no scaling."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext import fftboot as fb
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys.device_keygen import device_keygen
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.parallel.backend import ShardedBackend
    from gpufhe_tpu_torch.parallel.sharded import eval3d_to_natural, make_fhe_mesh
    from gpufhe_tpu_torch.params.params import preset

    params = preset(preset_name)
    ctx = make_context(params, device=device)
    diags = _first_cts_stage_diags(params, 3, k_bound)
    offsets = tuple(sorted(r for r in diags if r != 0))
    chest = device_keygen(params, np.random.default_rng(7), rotations=offsets, ctx=ctx)
    if chest.eph is None:
        raise ValueError(f"{preset_name} has no encapsulation keys")
    single = DeviceBackend(params, ctx, chest)
    mesh = ShardedBackend(params, make_fhe_mesh(2, 4, devices=[ctx.device] * 8), chest)
    rng = np.random.default_rng(0)
    z = (rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots)) * 0.2
    ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                     np.random.default_rng(1), params.scale, level=params.scale_words)
    parity = {}

    def step(name, single_fn, mesh_fn, x, multi=False):
        want = single_fn(x)
        got = mesh_fn(mesh.from_single(x))
        pairs = zip(got, want) if multi else [(got, want)]
        parity[name] = all(
            (g.level, g.scale) == (w.level, w.scale) and all(
                torch.equal(eval3d_to_natural(torch.cat(gc[0], dim=-2)), wc)
                for gc, wc in zip(g.c, w.c, strict=True))
            for g, w in pairs)
        return want

    ct_t = step("eph_ks_to", lambda c: single.key_switch(c, "to_eph"),
                lambda c: mesh.key_switch(c, "to_eph"), ct)
    raised = step("mod_raise2", single.mod_raise, mesh.mod_raise, ct_t)
    ct_f = step("eph_ks_from", lambda c: single.key_switch(c, "from_eph"),
                lambda c: mesh.key_switch(c, "from_eph"), raised)
    full = params.num_limbs
    plan_single, plan_mesh = fb.DiagPlan(single, diags, full), fb.DiagPlan(mesh, diags, full)
    step(f"fan_{len(offsets)}off", plan_single.apply_multi, plan_mesh.apply_multi, ct_f,
         multi=True)
    step("mult_rescale", lambda c: single.mul(c, c), lambda c: mesh.mul(c, c),
         single.drop_to_level(ct_f, mid_level))
    print(f"# [mesh {preset_name}] parity per program {parity}", flush=True)
    return {"metric": f"n{params.n.bit_length() - 1}_dw_mesh_numeric_execution",
            "value": 1.0 if all(parity.values()) else 0.0,
            "unit": f"all_parity (sharded == single-device limbs, N=2^{params.n.bit_length() - 1}"
                    " dw)",
            "programs": list(parity), "device": _card(device)}


def _stage_rows(preset_name: str, device) -> None:
    """The stage leaves of scripts/profile_mult_stages.py, under its names,
    each beside its bound on the card (benchkit.bench_all)."""
    for row in benchkit.bench_all(preset_name, device=device):
        print(f"# [{preset_name}] stage {json.dumps(row)}", flush=True)


def _free(device) -> None:
    gc.collect()
    if _on_card(device):
        torch.cuda.empty_cache()


def main(*, device: str = "cuda") -> None:
    """Print every line (the module docstring), the --preset multiply last."""
    if _on_card(device) and not torch.cuda.is_available():
        raise SystemExit("bench needs a CUDA device and none is available (pass --cpu to run "
                         "it on the CPU)")
    preset_name = os.environ.get("BENCH_PRESET", "config5_boot")
    chain = int(os.environ.get("BENCH_CHAIN", "128"))
    iters = int(os.environ.get("BENCH_ITERS", "3"))
    hbm_bw = float(os.environ.get("PEAK_HBM_GBPS", PEAK_HBM_GBPS))
    t_run = time.perf_counter()
    print(f"# device: {_card(device)}", flush=True)
    if _on_card(device):
        from gpufhe_tpu_torch.ops import cuda_build

        t0 = time.perf_counter()
        built = cuda_build.build_all()
        print(f"# built {sorted(built)} in {time.perf_counter() - t0:.1f} s", flush=True)

    def line(name, fn, show=True):
        t0 = time.perf_counter()
        if _on_card(device):
            torch.cuda.reset_peak_memory_stats(device)
        out = fn()
        peak = (f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
                if _on_card(device) else "not measured on the CPU")
        _free(device)
        print(f"# [{name}] {time.perf_counter() - t0:.1f} s; peak device memory {peak}",
              flush=True)
        if show:
            print(json.dumps(out), flush=True)
        return out

    # the primary multiply first (BFV's vs_ckks_mult divides by it), printed last
    primary = line(preset_name, lambda: bench_mult(preset_name, chain, iters, hbm_bw,
                                                   device=device), show=False)
    _stage_rows(preset_name, device)
    _free(device)
    line("bootstrap", lambda: bench_bootstrap(device=device))
    line("deep_mlp", lambda: bench_deep_mlp(device=device))
    line("mlp", lambda: bench_mlp(device=device))
    line("ntt", lambda: bench_ntt(preset_name, chain, iters, device=device))
    s29 = "config5_boot_s29"
    ntt29 = line("ntt s29", lambda: bench_ntt(s29, chain, iters, device=device), show=False)
    print(json.dumps({**ntt29, "metric": ntt29["metric"] + "_s29_lazy"}), flush=True)
    mult29 = line("mult s29", lambda: bench_mult(s29, chain, iters, hbm_bw, device=device),
                  show=False)
    print(json.dumps({"metric": mult29["metric"] + "_s29_lazy", "value": mult29["value"],
                      "unit": mult29["unit"], "ms_per_mult": mult29["ms_per_mult"],
                      "device": mult29["device"]}), flush=True)
    line("mesh", lambda: bench_mesh_parity(device=device))
    bfv_line = line("bfv", lambda: bench_int_mult("bfv", chain=chain, iters=iters,
                                                  device=device), show=False)
    bfv_line["vs_ckks_mult"] = round(bfv_line["ms_per_mult"] / primary["ms_per_mult"], 3)
    print(json.dumps(bfv_line), flush=True)
    line("bgv", lambda: bench_int_mult("bgv", chain=chain, iters=iters, device=device))
    if os.environ.get("BENCH_DW", "1") != "0":
        try:  # the reference's: never let the double-word line kill the primary
            line("config5_boot_dw", lambda: bench_mult("config5_boot_dw", chain, iters, hbm_bw,
                                                       device=device))
            _stage_rows("config5_boot_dw", device)
        except Exception as e:  # noqa: BLE001
            print(f"# dw headline failed: {type(e).__name__}: {e}", flush=True)
        _free(device)
    print(f"# whole run {time.perf_counter() - t_run:.1f} s on {_card(device)}", flush=True)
    print(json.dumps(primary), flush=True)


if __name__ == "__main__":
    main()
