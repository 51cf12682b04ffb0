#!/usr/bin/env python3
"""Smoke run of gpufhe_tpu_torch on one NVIDIA GPU (the H100 it targets).

    python3 chip_smoke.py

Builds the CUDA kernels from gpufhe_tpu_torch/csrc with nvcc, holds each
against its plain PyTorch version on the card, drives the CKKS multiply of
the config5_boot preset (N=2^16, 30 q-limbs, 15 special primes, dnum=2)
through the package's entry points, checks the result against the same path
on the CPU and against the cleartext product, and times the kernels and the
multiply with CUDA events. Every phase prints one line with its name, its
result and its seconds. The run fails (non-zero exit, no result line) when
no CUDA device is present, when a phase fails, or when it outlasts BUDGET_S.

The last two lines are a JSON object of per-kernel numbers and the result
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

BUDGET_S = 300  # the whole run, builds included; it needs under a minute
PRESET = "config5_boot"
DEVICE = "cuda:0"
SEED = 2024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12  # H100 SXM peak outside the tensor cores (float32 rate)
DECODE_TOL = 1e-2  # tests/test_pipeline.py:109

T0 = time.perf_counter()


def say(name: str, result: str, t_start: float) -> None:
    print(f"phase {name}: {result} ({time.perf_counter() - t_start:.2f} s)", flush=True)
    if time.perf_counter() - T0 > BUDGET_S:
        raise RuntimeError(f"over the {BUDGET_S} s budget after phase {name}")


def card() -> tuple[str, str]:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return line, torch.cuda.get_device_name(0)


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


def device_profile(fn, iters: int = 5) -> tuple[float, float, list]:
    """Profile `iters` calls: (device-busy ms per call, busy share of the host
    wall clock, [(device ms per call, kernel name)] largest first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    per = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            us = ev.self_cuda_time_total if us is None else us
            per.append((us / 1e3 / iters, ev.key))
    busy = sum(ms for ms, _ in per)
    return busy, busy * iters / wall_ms, sorted(per, reverse=True)


def exact(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    """Max |a - b|; raises unless the two are equal element for element."""
    torch.cuda.synchronize()
    err = int((a - b).abs().max().item())
    if a.shape != b.shape or err != 0:
        raise AssertionError(f"{what}: kernel and plain version differ (max |diff| {err})")
    return err


def unit_disk(rng: np.random.Generator, size: int) -> np.ndarray:
    """Slot values uniform on the unit disk, the usual CKKS input range.

    The decoded error is the scheme's noise times |z|: at N=2^16 and
    Delta=2^28 a fresh ciphertext carries about 1e-3 per slot, and complex
    Gaussian slots (|z| up to ~4.6 over 32768 slots) put the product's
    largest slot error near 1e-2, on the CPU path as on the card.
    """
    return np.sqrt(rng.random(size)) * np.exp(2j * np.pi * rng.random(size))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.ops import convert_cuda, cuda_build, ntt_cuda
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.ops.modops import mont_mac
    from gpufhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
    from gpufhe_tpu_torch.params.params import preset
    from gpufhe_tpu_torch.primitives import keyswitch, rns

    dev = torch.device(DEVICE)
    kernels = {"ntt": ntt_cuda.KERNEL, "convert": convert_cuda.KERNEL}

    # 0. the card
    t = time.perf_counter()
    smi, kind = card()
    print(smi, flush=True)
    say("card", f"{kind}; name, power.limit = {smi}", t)

    # 1. build every kernel (one nvcc per source, all at once)
    t = time.perf_counter()
    logs = cuda_build.build_all()
    for name, log in logs.items():
        print(f"nvcc {name}.cu -Xptxas -v:\n{log.strip()}", flush=True)
    say("build", f"built {sorted(logs)} into {cuda_build.BUILD_DIR.name}/", t)

    params = preset(PRESET)
    ctx = make_context(params, dev)
    n, L = params.n, params.num_limbs
    qp = L + len(params.p_primes)
    rng = np.random.default_rng(SEED)

    def rand_limbs(rows):
        x = np.stack([rng.integers(0, ctx.primes[r], size=n, dtype=np.int64) for r in rows])
        return torch.from_numpy(x).to(dev)

    # 2. K1 against its plain version, exact, at N = 2^16, at every shape that
    #    ct_mul_full launches it with (batches of 2, the rescale's L-1 limbs)
    t = time.perf_counter()
    ntt_err = 0
    ntt_cases = ((range(qp), 1), (range(L), 1), (range(L, qp), 1),
                 (range(qp), 2), (range(L), 2), (range(L - 1), 2))
    for sel, batch in ntt_cases:
        idx = ctx.index(sel, torch.int32)
        x = rand_limbs(list(sel) * batch)
        what = f"NTT limbs {sel} x {batch}"
        for inverse in (False, True):
            got = ntt_cuda.fourstep_cuda(x, idx, ctx, inverse)
            want = ntt_cuda.fourstep_plain(x, idx, ctx, inverse)
            ntt_err = max(ntt_err, exact(got, want, f"{what} inverse={inverse}"))
        back = ntt_cuda.fourstep_cuda(ntt_cuda.fourstep_cuda(x, idx, ctx, False), idx, ctx, True)
        exact(back, x, f"{what} round trip")
    say("ntt_vs_plain", "== fwd, inv and round trip at (limbs x batch) "
        + ", ".join(f"{len(sel)}x{b}" for sel, b in ntt_cases), t)

    # 3. K3 against its plain version, exact, at the ModUp and ModDown shapes
    t = time.perf_counter()
    ksc = rns.make_ks_context(params, L, dev)
    conv_err = 0
    shapes = {"modup": (ksc.modup[0], range(params.alpha)), "moddown": (ksc.p2q, range(L, qp))}
    for what, (tabs, rows) in shapes.items():
        x = rand_limbs(rows)
        got = convert_cuda.base_convert_cuda(x, tabs)
        want = convert_cuda.base_convert_plain(x, tabs)
        conv_err = max(conv_err, exact(got, want, f"base conversion {what}"))
    say("convert_vs_plain", f"== at ModUp {params.alpha}->{qp} and ModDown "
        f"{len(params.p_primes)}->{L}", t)

    # 4. the main path, through the entry points, with launch counts
    t = time.perf_counter()
    zr = np.random.default_rng(SEED + 1)
    za, zb = unit_disk(zr, params.slots), unit_disk(zr, params.slots)

    def main_path(ctx_):
        chest = dkeys.keygen(params, np.random.default_rng(SEED), ctx_)
        ca = dct.encrypt(encoder.encode(za, params), params, chest.device_pk, ctx_,
                         np.random.default_rng(SEED + 2), params.scale)
        cb = dct.encrypt(encoder.encode(zb, params), params, chest.device_pk, ctx_,
                         np.random.default_rng(SEED + 3), params.scale)
        return chest, ca, cb

    for k in kernels.values():
        k.reset()
    chest, ca, cb = main_path(ctx)
    before = {name: k.launches for name, k in kernels.items()}
    prod = dct.ct_mul_full(ca, cb, params, ctx, chest.device_rlk)
    per_mul = {name: k.launches - before[name] for name, k in kernels.items()}
    got = dct.decrypt_decode(prod, params, chest.device_sk, ctx)
    launches = {name: k.launches for name, k in kernels.items()}
    say("main_path", f"keygen, encode, encrypt x2, ct_mul_full, decrypt_decode at {PRESET}; "
        f"launches {launches}, per ct_mul_full {per_mul}", t)

    # 5. checks: (a) == the CPU path, (b) decodes to za * zb, (c) kernels ran
    t = time.perf_counter()
    ctx_cpu = make_context(params, "cpu")
    chest_c, ca_c, cb_c = main_path(ctx_cpu)
    prod_c = dct.ct_mul_full(ca_c, cb_c, params, ctx_cpu, chest_c.device_rlk)
    if prod.level != prod_c.level or prod.scale != prod_c.scale:
        raise AssertionError("level or scale differ from the CPU path")
    for i, (g, c) in enumerate(zip(prod.c, prod_c.c)):
        if not torch.equal(g.cpu(), c):
            raise AssertionError(f"ct_mul_full component {i} differs from the CPU path")
    say("check_vs_cpu", f"ct_mul_full limbs == the CPU path ({prod.level} limbs x 2)", t)
    t = time.perf_counter()
    err = float(np.abs(got - za * zb).max())
    if not np.isfinite(got).all() or got.shape != (params.slots,) or err >= DECODE_TOL:
        raise AssertionError(f"decoded product off by {err} (tolerance {DECODE_TOL})")
    if min(per_mul.values()) <= 0:
        raise AssertionError(f"a kernel did not run inside ct_mul_full: {per_mul}")
    say("check_decode", f"max |dec - za*zb| = {err:.3e} < {DECODE_TOL}; launches in "
        f"ct_mul_full {per_mul} > 0", t)

    # 6. times on the card (CUDA events, after warm-up)
    t = time.perf_counter()
    idx = ctx.index(range(qp), torch.int32)
    x45 = rand_limbs(range(qp))
    times = {
        "ntt": cuda_ms(lambda: ntt_cuda.fourstep_cuda(x45, idx, ctx, False)),
        "ntt_plain": cuda_ms(lambda: ntt_cuda.fourstep_plain(x45, idx, ctx, False), iters=5),
    }
    for what, (tabs, rows) in shapes.items():
        x = rand_limbs(rows)
        times[f"convert_{what}"] = cuda_ms(lambda: convert_cuda.base_convert_cuda(x, tabs))
        times[f"convert_{what}_plain"] = cuda_ms(
            lambda: convert_cuda.base_convert_plain(x, tabs), iters=5)

    qp_idx = keyswitch.qp_indices(params, L)
    xk = rand_limbs(range(L))
    xqp = rand_limbs(range(qp))
    raised = torch.stack([xqp, xqp])
    rlk = chest.device_rlk
    qcol, qinv = ctx.col("q", qp_idx), ctx.col("qinv_neg", qp_idx)
    leaves = {
        "ntt_fwd_k": lambda: ntt_fwd(xk, ctx, limbs=range(L)),
        "ntt_inv_qp": lambda: ntt_inv(xqp, ctx, limbs=qp_idx),
        "mod_up": lambda: rns.mod_up(xk, params, L, ctx, ksc),
        "ks_mac": lambda: [mont_mac([(r, k[d]) for d, r in enumerate(raised)], qcol, qinv)
                           for k in (rlk.b_mont, rlk.a_mont)],
        "mod_down": lambda: rns.mod_down(xqp, params, L, ctx, ksc),
        "rescale": lambda: rns.rescale(torch.stack([xk, xk]), params, L, ctx, ksc),
        "key_switch": lambda: keyswitch.key_switch_core(xk, params, L, ctx, ksc, rlk,
                                                        eval_out=False),
        "mul_full": lambda: dct.ct_mul_full(ca, cb, params, ctx, rlk),
    }
    for name, fn in leaves.items():
        times[name] = cuda_ms(fn, iters=10)
    for name, ms in times.items():
        print(f"time {name}: {ms:.4f} ms  [{smi}]", flush=True)
    busy, share, top = device_profile(leaves["mul_full"])
    print(f"profile mul_full: device busy {busy:.4f} ms per call, {share:.1%} of the host "
          f"wall clock under the profiler  [{smi}]", flush=True)
    for ms, name in top[:12]:
        print(f"profile mul_full kernel {ms:.4f} ms/call  {name[:90]}", flush=True)
    say("timing", f"mul_full {times['mul_full']:.3f} ms, NTT[{qp}] {times['ntt']:.4f} ms, "
        f"ModUp {times['convert_modup']:.4f} ms", t)

    # bounds from this run's shapes: each input read once, each output written
    # once. K1 needs its data and, per selected prime, q, mu, the n1/2 + n2/2
    # roots of its two passes, the n1 psi1 twists and the n1 + 2 n2 twiddle
    # factors; its modular products are the twist, the twiddle (two) and one
    # per butterfly. K3 needs its data, its tables and two products per term.
    n1, n2 = ctx.n1, ctx.n2
    log_n = n.bit_length() - 1

    def ntt_work(rows, limbs):
        per_prime = 2 + n1 // 2 + n2 // 2 + n1 + n1 + 2 * n2
        nbytes = 8 * (2 * rows * n + limbs * per_prime) + 4 * limbs
        return nbytes, rows * (3 * n + (n // 2) * log_n)

    def conv_work(s_dim, t_dim):
        nbytes = 8 * (s_dim * n + t_dim * n + 3 * s_dim + 2 * t_dim + s_dim * t_dim)
        return nbytes, 2 * s_dim * t_dim * n

    def bound(nbytes, nops):
        b, o = nbytes / HBM_BYTES_PER_S * 1e3, nops / ALU_OPS_PER_S * 1e3
        return (b, "bytes") if b >= o else (o, "operations")

    # the shapes of one ct_mul_full's launches, recorded around the wrappers
    seen = {"ntt": [], "convert": []}
    real_ntt, real_conv = ntt_cuda.fourstep_cuda, convert_cuda.base_convert_cuda

    def ntt_rec(x, idx_, ctx_, inverse):
        seen["ntt"].append(ntt_work(x.shape[0], idx_.numel()))
        return real_ntt(x, idx_, ctx_, inverse)

    def conv_rec(x, tabs):
        seen["convert"].append(conv_work(x.shape[0], tabs.dq.numel()))
        return real_conv(x, tabs)

    ntt_cuda.fourstep_cuda, convert_cuda.base_convert_cuda = ntt_rec, conv_rec
    try:
        dct.ct_mul_full(ca, cb, params, ctx, rlk)
    finally:
        ntt_cuda.fourstep_cuda, convert_cuda.base_convert_cuda = real_ntt, real_conv
    for key, work in seen.items():
        ms = sum(bound(nb, no)[0] for nb, no in work)
        print(f"bound per ct_mul_full {key}: {ms:.4f} ms over {len(work)} launches, "
              f"{sum(nb for nb, _ in work) / 1e6:.2f} MB", flush=True)
    ntt_bytes, ntt_ops = ntt_work(qp, qp)
    s_up, t_up = params.alpha, qp
    conv_bytes, conv_ops = conv_work(s_up, t_up)
    s_dn, t_dn = len(params.p_primes), L
    print(f"bound per call: ntt[{qp}] {bound(ntt_bytes, ntt_ops)[0]:.5f} ms, convert "
          f"ModUp {s_up}->{t_up} {bound(conv_bytes, conv_ops)[0]:.5f} ms, ModDown "
          f"{s_dn}->{t_dn} {bound(*conv_work(s_dn, t_dn))[0]:.5f} ms", flush=True)

    rows = []
    for name, key, src, repl, err, nb, no in (
        ("ntt_fourstep", "ntt", "gpufhe_tpu_torch/csrc/ntt.cu",
         "gpufhe_tpu/ops/ntt_pallas.py:601", ntt_err, ntt_bytes, ntt_ops),
        ("base_convert", "convert", "gpufhe_tpu_torch/csrc/convert.cu",
         "gpufhe_tpu/ops/convert_pallas.py:152", conv_err, conv_bytes, conv_ops),
    ):
        b_ms, b_by = bound(nb, no)
        plain_key = "ntt_plain" if key == "ntt" else "convert_modup_plain"
        ms_key = "ntt" if key == "ntt" else "convert_modup"
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[key], "max_abs_err": err, "ms": times[ms_key],
            "plain_ms": times[plain_key], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
        })
    print(f"# shapes: ntt_fourstep fwd {qp} x 2^{n.bit_length() - 1}; base_convert ModUp "
          f"{s_up}->{t_up}; no single PyTorch call computes either function mod q, "
          f"so library_ms is null; total {time.perf_counter() - T0:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
