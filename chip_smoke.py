#!/usr/bin/env python3
"""Smoke run of gpufhe_tpu_torch on one NVIDIA GPU (the H100 it targets).

    python3 chip_smoke.py

Builds the CUDA kernels from gpufhe_tpu_torch/csrc with nvcc and holds each
against its plain PyTorch version on the card: K1 (NTT), K3 (base
conversion, and ModDown with its epilogue at the dw key switch's shape),
K4 (key-switch MAC), the rescale kernel (rescale_kernel_run,
which also times it alone at the benchmark cells' shapes), the tensor
kernel (tensor_kernel_run, the same at the cells' tensor shapes), and the two
probes, the integer rate (P2)
and the K1 ablation builds (P1), and K1's pass entry point (ntt_pass, the
distributed four-step's stage, `mesh_kernels`). Then it drives the paths
below through the package's entry points, each with the launch counts set
to 0 just before it and read just after:

  mul     the CKKS multiply of config5_boot (N=2^16, 30 q-limbs, 15 special
          primes, dnum=2): keygen (with the rotation keys of the third path),
          encode, encrypt x2, ct_mul_full, decrypt;
  dw      the double-word multiply of config5_boot_dw (N=2^16, 48 q-limbs,
          10 special primes, dnum=5, scale_words=2, encapsulation keys);
  rotate  at config5_boot: ct_rotate, ct_conjugate, ct_rotate_hoisted,
          ct_mul_plain and ct_plain_mac;
  bgv     the BGV multiply at bfv_n16 (N=2^16, 30 q-limbs, alpha=15, dnum=2,
          t=786433): keygen (rlk, Galois 1 and 3), encode and encrypt two
          slot vectors mod t, ct_mul, three squarings (level 30 -> 27),
          ct_mul_plain, ct_add, ct_rotate and ct_rotate_hoisted, every
          decrypt exact in all 65536 slots; one ct_mul == the CPU path;
  bfv     the BFV multiply at bfv_n16: keygen, ct_mul, three squarings,
          ct_mod_reduce, ct_add_plain, ct_rotate, and bgv_to_bfv then
          bfv_to_bgv on the BGV path's first square, every decrypt exact;
          one ct_mul == the CPU path. Before both (int_kernels) K1 on the
          34-limb aux context and K3 at Q -> aux, B -> Q, B -> m_sk and BGV's
          t-folded P -> Q are held == their plain versions;
  int_ci  every BGV and BFV op at bgv_ci / bfv_ci (N=2^10), a BSGS matvec
          through each scheme's backend included, on the card == the CPU;
          then int_timing: ms per BGV and per BFV ct_mul by CUDA events,
          device time by kernel, launches, summed bounds, stage leaves;
  boot_ci the whole CKKS bootstrap at boot_dw_ci_enc (N=2^7, factored
          transforms at radix_log 3, Chebyshev EvalMod, encapsulation), on
          the card and on the CPU with the same keys and draws: every phase
          output (mod_raise, coeff_to_slot t0/t1, evalmod y0/y1,
          slot_to_coeff) == limb for limb, which holds K1, K3 and K4 at the
          bootstrap's shapes against their plain versions;
  boot    the flagship bootstrap at config5_boot_dw, as the reference's
          scripts/bootstrap_n16_dw.py drives it: device_keygen on the card
          (rlk, eph h=32, the 63 Galois keys of the factored transforms at
          radix_log 3, conj; threefry at its shapes timed alone by CUDA
          events),
          Bootstrapper(factored, radix 3, cheb, k_bound 10), per-step key
          truncation, then one first call and five steady calls on
          z = 0.2 (N(0,1) + i N(0,1)) encrypted at level 2, each decoded
          within BOOT_TOL; its ModRaise stage (to_eph, ct_mod_raise2,
          from_eph) == the CPU path at full width; per-phase times, the
          steady calls' CUDA-event times (median and spread), the
          device-busy share of one profiled call over its own event time,
          launches per phase, host encodes per call and peak device
          memory. After its counts are read, K4 is held == its plain
          version at every shape the fans give it, on the path's own
          plaintext stacks and truncated keys (boot_mac_check);
  boot_h  the single-word bootstrap at config5_boot_h (N=2^16, 30 q-limbs,
          5 special primes, dnum=6, sparse h=64, no encapsulation), as the
          reference's scripts/bootstrap_n16.py drives it, nothing cut, after
          the flagship's keys are freed: device_keygen (rlk, the 55 Galois
          keys of the factored transforms at radix_log 2, conj),
          Bootstrapper(factored, radix 2, cheb, k_bound 12), one first and
          five steady calls on z = 0.2 (N(0,1) + i N(0,1)) encrypted at level
          1; each phase of the first call within DECODE_TOL of its own
          function of its decrypted input, every steady call == the first
          limb for limb; the end-to-end decode error is printed, not gated:
          the reference's own bootstrap on this chain, which gives the
          port's limbs at N = 2^8 to 2^14, decodes off by more than
          DECODE_TOL from N = 2^12 on (tests/test_torch_boot_h_ring.py);
          CUDA-event times, per phase, busy share, launches, peak memory;
          then (boot_h_check) its ModRaise
          stage == the CPU path, regen_pk_a on the card == on the CPU, one
          Galois key's a == regen_ks_a of its seed, and one key switch of the
          raised ciphertext taken apart with K1, K3 (ModUp 5->35, ModDown
          5->30) and K4 (D = 6 x 35) each == plain on those operands; and
          (boot_h_shapes) each kernel alone at those shapes; and
          (boot_h_ring) the chain and settings at N = 2^BOOT_H_RING_LOGN on
          the card and on the CPU, every phase == limb for limb, decoded
          end to end within DECODE_TOL;
  deep_mlp the 5-layer d=8 MLP at config5_boot_dw entered at level 8, as the
          reference's scripts/deep_mlp_n16.py drives it, after boot_h's keys
          are freed: its own device_keygen (the bootstrap's 63 steps and the
          MLP's, conj), Bootstrapper(factored, radix 3, cheb, k_bound 10,
          lean_keys), keys truncated per step; one first and two steady
          forwards (each == the first), two mid-inference bootstraps each,
          timed apart by CUDA events; the logits within 1e-2 of the
          cleartext forward, printed beside DEEP_MLP_N16.json's error;
  mlp_n15 the MNIST-shaped MLP (784 -> 128 -> 10, square activation) at
          config3_ckks (N=2^15, 12 q-limbs, 3 special primes, dnum 4), as
          scripts/mlp_n15.py drives it, its plans built from the layers'
          blocks: device_keygen of the stack's 134 rotation steps, one first
          forward (its plans timed apart) and three steady forwards (each ==
          the first) by CUDA events, one profiled forward; the logits within
          1e-2, printed beside MLP_N15.json's error; then (mlp_n15_check) one
          key switch of the input taken apart, K1 at 12 and 15 limbs, K3 at
          3->15 and 3->12 and K4 at D = 4 x 15 each == plain on those
          operands, and (mlp_n15_shapes) each kernel alone at those shapes;
  models_ci the libraries and models at CI size (MODELS_CI_SMOKE: approx's
          inverse and layer_norm, EncryptedCNN, threshold's device partial,
          ct_mul_batched), on the card and on the CPU with the same keys and
          draws, every output == limb for limb, each decoded within its
          reference test's tolerance; tests/test_torch_kernels_gpu.py runs
          every item of MODELS_CI_ITEMS the same way.
  session_ckks the Session facade (gpufhe_tpu_torch.api) at config5_boot:
          Session.create(rotations=(1,), seed), two unit-disk vectors
          encrypted at the preset's 2^28, mul, add, mul_plain, add_plain,
          rotate 1, rescale and level, each decrypted (the rotation gated at
          SESSION_ROT_TOL, the others at DECODE_TOL); each op timed by CUDA
          events, mul, add and rotate in turns with the call below the
          Session (the facade's own cost), beside phase timing's;
  session_bfv Session.create(bfv_n16, scheme="bfv", rotations=(1,)):
          encrypt, mul, add and rotate 1, each decrypt exact in all 65536
          slots, noise_budget falling after the multiply;
  session_ci Sessions at CI size (SESSION_CI_SMOKE: CKKS at tiny2 and BFV
          at bfv_tiny with the BSGS keys and a matmul each, a 3-party
          ThresholdSession at tiny2 through its combine) on the card and on
          the CPU, every output == limb for limb; tests/test_torch_kernels_gpu.py
          runs every item of SESSION_CI_ITEMS (BGV at bgv_tiny and
          Session.bootstrap at boot_dw_ci_enc too) the same way;
  session_io Session.save and save_ct of session_ckks's session (the
          reference's npz format, written in a background thread from
          session_ckks on, beside deep_mlp, mlp_n15, models_ci, session_bfv
          and session_ci), then Session.load and load_ct on the
          card: the loaded ciphertexts and their decrypts == the originals,
          the loaded session's mul == the original's limb for limb; seconds
          and bytes of each file;
  cli     python -m gpufhe_tpu_torch.cli in process: security at
          config5_boot_dw, keygen at tiny2 loaded by Session.load on the
          card, kernels at config5_boot (each row beside its bound),
          scaling at tiny2 (one card: the 1 x 1 row alone), and demo-bfv
          and demo-mlp on the card == with --cpu;
  bench   gpufhe_tpu_torch/bench.py's primary line (`cli bench`'s last):
          bench_mult at config5_boot on a chain of BENCH_CHAIN data-dependent
          ct_mul_full steps, its floor subtracted, timed by CUDA events;
          its final carry == a hand-written loop of ct_mul_full on the card
          from the same inputs, limb for limb;
  mesh    gpufhe_tpu_torch/parallel on a (2, 4) mesh of eight shards on the
          card: mesh_mul (after int_timing) the sharded multiply at
          config5_boot == ct_mul_full, the sharded BGV and BFV multiplies at
          bfv_n16 == bgv.ct_mul and bfv.ct_mul, each decrypt exact, ms per
          call beside the single device's and the launches of K1's passes,
          K3 and K4 per call; mesh_n16 (after cli) the reference's
          scripts/exec_n16_mesh.py program set at config5_boot_dw, nothing
          cut (eph_ks_to, mod_raise2, eph_ks_from, the first CoeffToSlot fan
          and the multiply at level 26), each == the single device, its
          first-call seconds, steady ms beside the single device's, peak
          memory; mesh_ci the dw bootstrap at boot_dw_ci over
          ShardedBackend (== the single device's) and the BGV and BFV
          rotations and hoisted fans at CI size, card == CPU;
  golden  golden_vectors (after mesh_kernels, its own launch counts): the
          five files of tests/vectors that a device path reaches
          (config2_rns, config3_ckks, config4_rotations, bgv_integer,
          bfv_integer), each reproduced on the card from the seed and preset
          it stores, every stored array == the card's output; golden_n16
          (after cli): the port's golden model (golden/*: numpy, none of the
          port's kernels or torch ops), in a third CPU twins process,
          regenerates all six files (config1's 60-bit NTT too), each == its
          file, and computes the config5_boot ct_mul, ct_rotate 1,
          ct_conjugate, ct_rotate_hoisted (1, 3) and ct_mod_raise and the
          bfv_n16 BGV and BFV ct_mul from the mul, rotate, bgv and bfv paths'
          seeds: the card's outputs == them limb for limb, an oracle at
          N=2^16 that shares no code with the card's side but the host
          encoders and samplers.

Each path's ciphertexts are checked == the same path on the CPU and decoded
against the cleartext result. The CPU twins run beside the card's paths and
are joined after cli, where every check against them is made: those of mul,
rotate, dw and one BGV and one BFV ct_mul in one process from the start, those
of the CI-size items (boot_ci, int_ci, boot_h_ring, models_ci, session_ci,
mesh_ci) in another, the golden model's (golden_n16) in a third (CpuTwins),
and the boot path's ModRaise stage in a background thread. The kernels and
stage leaves are timed with CUDA events and the kernels also by the
profiler's kernel time, and every
bound is restated with the integer rates measured in this run. K1 is also
timed alone, forward and inverse, at config5_boot's Q+P chain (45 limbs)
and at the dw key switch's raised digits (58 limbs x 5), beside its bound
and its achieved bandwidth; K3 alone at ModUp 15->45, ModDown 15->30 and
ModUp 10->58 likewise, with a sweep of its launch (destinations per block,
coefficients per thread) and its registers and spills, and the fused
ModDown [2, 58] -> 48 with a two-row addend beside its bound. Every phase prints one line
with its name, its result, its seconds and the seconds into the run. The run fails (non-zero exit,
no result line) when no CUDA device is present, when a phase fails, or
when it outlasts BUDGET_S.

The last two lines are a JSON object of per-kernel numbers and the result
line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import pathlib
import re
import subprocess
import time

import numpy as np
import torch

from gpufhe_tpu_torch.utils.benchkit import HBM_BYTES_PER_S, Bounds

BUDGET_S = 300  # the whole run, builds included
PRESET = "config5_boot"
DW_PRESET = "config5_boot_dw"
DEVICE = "cuda:0"
SEED = 2024
ROTATIONS = (1, 3)
# The rotation path encrypts at 2^40, not at the preset's 2^28: a key switch
# adds the ModDown error times the secret at the ciphertext's own scale, and
# at N=2^16 that decodes to 0.068 at 2^28 in the reference's golden model as
# in the port (tests/test_torch_rotation_noise.py), above DECODE_TOL for any
# input; at 2^40 it is 2^12 times smaller, so the check tells a wrong
# rotation from the scheme's noise. (The multiply's key switch runs at the
# product's scale 2^56 and is rescaled away.)
ROT_SCALE_BITS = 40
# The integer-rate probe's own bound (its rows in the kernels line; the
# kernels' bounds use the rates it measures): the CUDA C++ programming
# guide's arithmetic-throughput table gives 64 results per clock per SM for a
# 32-bit integer multiply-add at compute capability 9.0, counted as two
# operations as the probe counts them, on every SM at the card's maximum SM
# clock (int_peak_ops_per_s): 132 x 64 x 2 x 1.98 GHz = 33.45 T ops/s on an
# H100 SXM, half the float32 rate outside the tensor cores.
INT_MAD_PER_CLOCK_PER_SM = 64
DECODE_TOL = 1e-2  # tests/test_pipeline.py:109
BOOT_PRESET = "config5_boot_dw"
BOOT_CI_PRESET = "boot_dw_ci_enc"
BOOT_RADIX = 3
BOOT_K_BOUND = 10.0  # the reference flagship's (scripts/bootstrap_n16_dw.py)
BOOT_CI_K_BOUND = 5.0  # the reference's at CI size (tests/test_fftboot.py)
BOOT_TOL = 1e-3  # tests/test_fftboot.py:193, the dw bootstrap's tolerance
BOOT_STEADY = 5
# the single-word N=2^16 bootstrap, as the reference's scripts/bootstrap_n16.py
# drives it: config5_boot_h (30 q-limbs, 5 special primes, dnum 6, h=64),
# factored transforms at radix_log 2, Chebyshev EvalMod with k_bound 12
BOOT_H_PRESET = "config5_boot_h"
BOOT_H_RADIX = 2
BOOT_H_K_BOUND = 12.0
BOOT_H_STEADY = 5
# config5_boot_h's chain and the path's settings at a ring of 2^10, where the
# reference's bootstrap on this chain still decodes within DECODE_TOL: it
# gives the port's limbs at N = 2^8 to 2^14 and an error about 4.4 times
# larger for each 4 times N (tests/test_torch_boot_h_ring.py, PERF.md)
BOOT_H_RING_LOGN = 10
# the integer schemes: bfv_n16 (N=2^16, 30 q-limbs, alpha=15, dnum=2, t=786433)
# read as BGV and as BFV, as the reference's scripts/bgv_n16_mult.py and
# bfv_n16_mult.py drive it; the CI presets bgv_ci / bfv_ci
INT_PRESET = "bfv_n16"
INT_ROTATIONS = (1, 3)
INT_TIMED = 7  # ct_mul calls timed one by one with CUDA events, per scheme
# the models: the MNIST-shaped MLP (784 -> 128 -> 10, square activation) at
# config3_ckks as scripts/mlp_n15.py drives it, and the 5-layer d=8 MLP at
# config5_boot_dw entered at level 8 and refreshed mid-inference by the
# flagship's Bootstrapper, as scripts/deep_mlp_n16.py drives it; beside each
# error the reference's record of it (MLP_N15.json, DEEP_MLP_N16.json)
MLP_PRESET = "config3_ckks"
MLP_STEADY = 3
MLP_TOL = 1e-2  # scripts/mlp_n15.py:117
MLP_RECORD = 0.00800225619296624  # MLP_N15.json max_logit_err
DEEP_PRESET = "config5_boot_dw"
DEEP_LAYERS, DEEP_D, DEEP_IN_LEVEL = 5, 8, 8
DEEP_STEADY = 2
DEEP_TOL = 1e-2  # scripts/deep_mlp_n16.py:170
DEEP_RECORD = 2.294809462073666e-08  # DEEP_MLP_N16.json logits_max_err

T0 = time.perf_counter()
# the host seconds spent in device_profile (its calls, the trace and its
# processing), for the run's last summary line
PROFILER = {"windows": 0, "s": 0.0}


def say(name: str, result: str, t_start: float) -> None:
    now = time.perf_counter()
    print(f"phase {name}: {result} ({now - t_start:.2f} s; {now - T0:.1f} s into the run)",
          flush=True)
    if time.perf_counter() - T0 > BUDGET_S:
        raise RuntimeError(f"over the {BUDGET_S} s budget after phase {name}")


def in_background(fn, name: str):
    """Start fn() in a thread of its own (host work on CPU tensors, which
    launches no kernel); the returned callable joins it and gives its result,
    or raises its error."""
    import os
    import threading

    box = {}

    def run():
        # background work: the card's paths come first on the host
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
        try:
            box["out"] = fn()
        except BaseException as e:  # re-raised by the join
            box["error"] = e

    thread = threading.Thread(target=run, name=name, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["out"]

    return join


def card() -> tuple[str, str]:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return line, torch.cuda.get_device_name(0)


def int_peak_ops_per_s() -> tuple[float, str]:
    """The card's peak 32-bit integer multiply-add rate in operations per
    second (two per multiply-add), from its SM count and its maximum SM
    clock as nvidia-smi reports it, and how it was formed."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * INT_MAD_PER_CLOCK_PER_SM * 2 * mhz * 1e6
    return rate, (f"{sms} SMs x {INT_MAD_PER_CLOCK_PER_SM} 32-bit multiply-adds per clock x 2 "
                  f"ops x {mhz:.0f} MHz (clocks.max.sm)")


def device_profile(fn, iters: int = 5) -> tuple[float, float, list]:
    """Profile `iters` calls: (device-busy ms per call, the profiled calls'
    own CUDA-event ms per call, [(device ms per call, kernel name, launches
    seen)] largest first). Busy over span is the device's busy share of
    those very calls, the profiler's own host cost included. Only the CUDA
    activity is traced: the kernels' device times are all that is read, and
    a trace of the CPU activity (every aten op) cost the host seconds per
    window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
    span_ms = start.elapsed_time(stop) / iters
    per = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            us = ev.self_cuda_time_total if us is None else us
            per.append((us / 1e3 / iters, ev.key, ev.count))
    PROFILER["windows"] += 1
    PROFILER["s"] += time.perf_counter() - t0
    return sum(ms for ms, _, _ in per), span_ms, sorted(per, reverse=True)


# the kernels' names as the profiler reports them
K1_NAME, K3_NAME, K4_NAME = r"k1_pass<[^>]*>", r"base_convert_kernel", r"mac_kernel"


def kernel_ms(fn, pattern: str, kinds: int = 1, iters: int = 20,
              tries: int = 3) -> tuple[float, str]:
    """Device ms per call of `fn` in the `kinds` kernels whose name matches
    `pattern` (profiler kernel time, which no host overhead enters), in all
    and per kernel (for K1 per pass: k1_pass<log2 R, kind>). Each matching
    kernel launches once per call, so its time per call is its mean per
    launch traced: the profiler has been seen to drop launches from a trace
    (some, or all of a kernel's), which a division by `iters` would read as
    a faster kernel. A trace that lacks a kernel is taken again; after
    `tries` such traces the time is nan (null in the kernels line)."""
    for _ in range(tries):
        _, _, per = device_profile(fn, iters=iters)
        per = [(ms * iters / seen, m.group(0), seen) for ms, name, seen in per
               if (m := re.search(pattern, name))]
        if len(per) == kinds:
            return sum(ms for ms, _, _ in per), ", ".join(
                f"{name} {ms:.4f} ({seen} of {iters} launches traced)" for ms, name, seen in per)
    return math.nan, f"no complete trace of {pattern} in {tries} tries"


def ptxas_summary(log: str, pattern: str) -> list[str]:
    """'(template arguments): registers, spills' for each entry function of
    an nvcc -Xptxas -v log whose mangled name matches `pattern`."""
    rows, args, spill = [], None, ""
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            args = (m2 := re.search(pattern, m.group(1))) and m2.groups()
        elif args and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spill = f"spills {m.group(1)}/{m.group(2)} bytes"
        elif args and (m := re.search(r"Used (\d+) registers", line)):
            rows.append(f"({', '.join(args)}) {m.group(1)} registers, {spill}")
            args = None
    return rows


def or_null(ms: float) -> float | None:
    return None if math.isnan(ms) else ms


def kernel_missing(per: dict) -> bool:
    """Whether K1, K3 or K4 made no launch in `per` (launches by kernel). The
    rescale kernel runs only where a path rescales, and is counted where it
    must run."""
    return min(per[k] for k in ("ntt", "convert", "mac")) <= 0


def exact(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    """Max |a - b|; raises unless the two are equal element for element."""
    if a.is_cuda or b.is_cuda:
        torch.cuda.synchronize()
    if a.shape != b.shape:
        raise AssertionError(f"{what}: shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
    err = int((a - b).abs().max().item())
    if err != 0:
        raise AssertionError(f"{what}: kernel and plain version differ (max |diff| {err})")
    return err


def same_limbs(got, want, what: str) -> int:
    """A card ciphertext == its twin (the CPU path's, or the golden model's
    numpy one): level, scale (CKKS) or pt_factor (BGV) and every limb.
    Returns the limbs compared."""
    from gpufhe_tpu_torch.golden.ckks import host_limbs

    tags = [(c.level, getattr(c, "scale", None), getattr(c, "pt_factor", None), len(c.c))
            for c in (got, want)]
    if tags[0] != tags[1]:
        raise AssertionError(f"{what}: level, scale, pt_factor or size differ from its twin: "
                             f"{tags}")
    for i, (g, c) in enumerate(zip(got.c, want.c)):
        if not np.array_equal(host_limbs(g), host_limbs(c)):
            raise AssertionError(f"{what}: component {i} differs from its twin")
    return sum(c.shape[0] for c in want.c)


def decode_err(got: np.ndarray, want: np.ndarray, slots: int, what: str,
               tol: float = DECODE_TOL) -> float:
    err = float(np.abs(got - want).max())
    if not np.isfinite(got).all() or got.shape != (slots,) or err >= tol:
        raise AssertionError(f"{what}: decoded result off by {err} (tolerance {tol})")
    return err


def unit_disk(rng: np.random.Generator, size: int) -> np.ndarray:
    """Slot values uniform on the unit disk, the usual CKKS input range.

    The decoded error is the scheme's noise times |z|: at N=2^16 and
    Delta=2^28 a fresh ciphertext carries about 1e-3 per slot, and complex
    Gaussian slots (|z| up to ~4.6 over 32768 slots) put the product's
    largest slot error near 1e-2, on the CPU path as on the card.
    """
    return np.sqrt(rng.random(size)) * np.exp(2j * np.pi * rng.random(size))


def phase_hook(counts, phases: dict, per_phase: dict, events: list | None = None):
    """A Bootstrapper `_phase` hook that keeps each phase's outputs and the
    kernel launches made since the previous mark (or since this call); with
    `events`, also a recorded CUDA event per mark, after one recorded now."""
    state = {"c": counts()}

    def record(name):
        if events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

    def mark(name, outs):
        record(name)
        now = counts()
        phases[name] = outs
        per_phase[name] = {k: now[k] - state["c"][k] for k in now}
        state["c"] = now

    record("start")
    return mark


def event_ms(events: list) -> dict:
    """{phase: CUDA-event ms since the previous mark} of phase_hook's events."""
    torch.cuda.synchronize()
    return {name: start.elapsed_time(ev)
            for (_, start), (name, ev) in zip(events, events[1:])}


def gib(nbytes: float) -> str:
    return f"{nbytes / 2**30:.3f} GiB"


def peak_marker(dev, peak: dict):
    """mark(what): the peak device memory since the last mark, kept as peak[what]."""
    def mark(what):
        torch.cuda.synchronize()
        peak[what] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    return mark


def key_bytes(chest) -> int:
    """Device bytes of a chest's Galois and conjugation keys."""
    keys = [k for _, k in chest.galois.values()] + [chest.conj[1]]
    return sum(8 * (k.b_mont.numel() + k.a_mont.numel()) for k in keys)


def timed_keygen(params, rots, ctx) -> tuple:
    """device_keygen(params, default_rng(7), rots, conjugation=True) on ctx,
    as the reference's N=2^16 scripts draw their keys: (chest, host seconds
    with the device synchronised, threefry's CUDA-event ms, its draws).
    Threefry's share is timed apart, after the keygen: keys/prng.py bits_u32
    at the shapes the keygen drew, as many times (two draws of 32-bit words
    per uniform row: the public key's row over Q, each switching key's gadget
    rows over Q+P, one set per recorded seed). Its cost does not depend on
    the key, so the same work timed alone is the keygen's share of it."""
    from gpufhe_tpu_torch.golden import ckks as gckks
    from gpufhe_tpu_torch.keys import prng
    from gpufhe_tpu_torch.keys.device_keygen import device_keygen

    t = time.perf_counter()
    chest = device_keygen(params, np.random.default_rng(7), rots, conjugation=True, ctx=ctx)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t
    qp, dnum = len(params.q_primes + params.p_primes), len(gckks.gadget_factors(params))
    shapes = [(params.num_limbs, params.n) if name == "pk" else (qp, params.n)
              for name in chest.seeds for _ in range(1 if name == "pk" else dnum)]
    key = prng.key(0)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for shape in shapes:
        for _ in range(2):
            prng.bits_u32(key, shape, ctx.device)
    stop.record()
    torch.cuda.synchronize()
    return chest, keygen_s, start.elapsed_time(stop), 2 * len(shapes)


def boot_ci_run(device, counts) -> tuple:
    """The whole bootstrap at BOOT_CI_PRESET on `device`, keys and draws from
    numpy seeds: (backend, {phase: outputs}, {phase: launches}, output, z)."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    params = preset(BOOT_CI_PRESET)
    rots = tuple(bootstrap_rotations(params, "factored", BOOT_RADIX))
    zr = np.random.default_rng(0)
    z = (zr.normal(size=params.slots) + 1j * zr.normal(size=params.slots)) * 0.2
    ctx = make_context(params, device=device)
    chest = dkeys.keygen(params, np.random.default_rng(7), rots, conjugation=True, ctx=ctx)
    be = DeviceBackend(params, ctx, chest)
    bs = Bootstrapper(be, transform="factored", radix_log=BOOT_RADIX, evalmod="cheb",
                      k_bound=BOOT_CI_K_BOUND)
    ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                     np.random.default_rng(1), params.scale, level=params.scale_words)
    phases, per_phase = {}, {}
    out = bs(ct, _phase=phase_hook(counts, phases, per_phase))
    return be, phases, per_phase, out, z


def boot_ci_path(dev, counts, reset, launches: dict):
    """Path boot_ci (the card): the whole bootstrap at BOOT_CI_PRESET.
    Returns its check against the CPU twin (boot_ci_run("cpu"), run in the
    CI twins' process): == phase for phase."""
    from gpufhe_tpu_torch.ciphertext.bootstrap import bootstrap_rotations

    t = time.perf_counter()
    reset()
    be, phases, per_phase, out, z = boot_ci_run(dev, counts)
    params = be.params
    err = decode_err(be.decrypt_decode(out), z, params.slots, "boot_ci bootstrap", BOOT_TOL)
    launches["boot_ci"] = counts()
    for name, per in per_phase.items():
        if kernel_missing(per):
            raise AssertionError(f"boot_ci phase {name}: a kernel did not run ({per})")
    say("boot_ci_path", f"keygen ({len(bootstrap_rotations(params, 'factored', BOOT_RADIX))} Galois keys, conj, eph h="
        f"{params.eph_hamming_weight}), Bootstrapper(factored, radix {BOOT_RADIX}, cheb, k_bound "
        f"{BOOT_CI_K_BOUND}), one bootstrap at {BOOT_CI_PRESET} (N={params.n}); output level "
        f"{out.level}, max |dec - z| = {err:.3e} < {BOOT_TOL}; launches {launches['boot_ci']}, "
        f"per phase {per_phase}; K1, K3 and K4 launched in every phase", t)

    def check(cpu):
        t = time.perf_counter()
        n_cts = 0
        for name, outs in phases.items():
            for i, (g, c) in enumerate(zip(outs, cpu["boot_ci"][name], strict=True)):
                same_limbs(g, c, f"boot_ci {name} [{i}]")
                n_cts += 1
        say("boot_ci_check", f"{n_cts} phase outputs ({', '.join(phases)}) == the CPU path "
            "limb for limb", t)

    return check


def boot_mac_check(params, ctx, bs, chest, smi) -> None:
    """K4 == its plain version at the shapes every fan stage of the flagship
    gives it, on the path's own plaintext stacks and truncated Galois keys
    (random canonical ciphertext operands): per stage, the first MAC level
    (raised digits through an offset's automorphism against its key,
    written into a slot of the [2, R, K+alpha, N] stack through `out`; the
    offset whose key is stored with the fewest rows), and per output set
    the second (the R-diagonal plaintext stack against that stack), the
    gathered c0 stack against the plaintext stack's q rows, and the
    zero-offset diagonal against c0 and c1. Called after the path's launch
    counts are read."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.golden import ckks as gckks
    from gpufhe_tpu_torch.ops import mac_cuda
    from gpufhe_tpu_torch.primitives import keyswitch, rns

    t = time.perf_counter()
    gen = torch.Generator(ctx.device).manual_seed(SEED)

    def rand(lead, rows):
        q = ctx.col("q", rows)
        return torch.randint(0, 2**62, (*lead, len(rows), params.n), generator=gen,
                             device=ctx.device) % q

    full_rows = params.num_limbs + len(params.p_primes)
    cts, stc = bs.f_cts, bs.f_stc
    plans = ([("CtS", p) for p in (*cts.shared, cts.last)]
             + [("StC", p) for p in (stc.first_lo, stc.first_hi, *stc.rest)])
    done, truncated, n_checks = [], 0, 0
    for stage, plan in plans:
        fan = plan.fan
        level, r_count = fan.level, len(fan.offsets)
        qp = keyswitch.qp_indices(params, level)
        chain = ctx.index(qp, torch.int32)
        rows_qp = ctx.index(range(len(qp)), torch.int32)
        rows_q = ctx.index(range(level), torch.int32)
        j, step = min(enumerate(fan.offsets), key=lambda o: chest.galois_key(o[1]).b_mont.shape[1])
        key = chest.galois_key(step)
        stored = key.b_mont.shape[1]
        truncated += stored < full_rows
        perm = dct.galois_perm(gckks.galois_exponent(step, params.n), ctx, torch.int32)
        key_rows = ctx.index(keyswitch.key_row_index(params, level, stored), torch.int32)
        raised = rand((len(rns.ks_groups(params, level)),), qp)
        stack = rand((2, r_count), qp)
        args = (raised, key.b_mont, key.a_mont, key_rows, chain, ctx, perm)
        mac_cuda.mac_cuda(*args, out=stack[:, j])
        exact(stack[:, j], mac_cuda.mac_plain(*args), f"K4 {stage} level {level} fan level 1")
        n_checks += 1
        for pts, pt0 in zip(fan.pt_stacks, fan.pt0s):
            cases = {"level 2": (pts, stack[0], stack[1], rows_qp, chain, ctx),
                     "gathered c0": (rand((r_count,), range(level)), pts, None, rows_q, rows_q,
                                     ctx)}
            if pt0 is not None:
                cs = rand((2, 1), range(level))
                cases["zero offset"] = (pt0[:level][None], cs[0], cs[1], rows_q, rows_q, ctx)
            for what, args in cases.items():
                exact(mac_cuda.mac_cuda(*args), mac_cuda.mac_plain(*args),
                      f"K4 {stage} level {level} fan {what}")
                n_checks += 1
        done.append(f"{stage} {level}: R={r_count} x {len(fan.pt_stacks)} sets, D={raised.shape[0]} "
                    f"x T={len(qp)}, key {stored}/{full_rows} rows")
        del stack, raised
    if not truncated:
        raise AssertionError("no fan stage of the flagship read a truncated Galois key")
    say("boot_mac_check", f"K4 == plain in {n_checks} launches at every fan stage's shapes, on "
        f"the flagship's plans and keys (stage level: offsets R x output sets, the first MAC "
        f"level's digits D x rows T, the least-stored key's rows; the second level is D=R x T, "
        f"the gathered c0 D=R x level rows): " + "; ".join(done) + f"  [{smi}]", t)


def boot_path(dev, smi, counts, reset, launches: dict, ctx_cpu) -> dict:
    """Path boot: the flagship bootstrap at BOOT_PRESET (see the module
    docstring). Returns its numbers for the summary, and under "call" one
    more steady call for the bounds of its kernels' launches."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.ops.probes import cuda_ms
    from gpufhe_tpu_torch.params.params import preset

    params = preset(BOOT_PRESET)
    ctx = make_context(params, device=dev)
    peak = {}
    mark_peak = peak_marker(dev, peak)

    t = time.perf_counter()
    reset()
    torch.cuda.reset_peak_memory_stats(dev)
    rots = tuple(bootstrap_rotations(params, "factored", BOOT_RADIX))
    chest, keygen_s, threefry_ms, draws = timed_keygen(params, rots, ctx)
    mark_peak("keygen")
    t1 = time.perf_counter()
    be = DeviceBackend(params, ctx, chest)
    bs = Bootstrapper(be, transform="factored", radix_log=BOOT_RADIX, evalmod="cheb",
                      k_bound=BOOT_K_BOUND)
    mark_peak("plan")
    plan_s, plan_misses = time.perf_counter() - t1, be.encode_misses
    t1 = time.perf_counter()
    full_bytes = key_bytes(chest)
    steps, conj_level = bs.galois_step_levels()
    dkeys.truncate_galois_device(chest, steps, conj_level, params)
    mark_peak("truncate")
    trunc_s = time.perf_counter() - t1
    say("boot_setup", f"{BOOT_PRESET}: device_keygen (rlk, eph h={params.eph_hamming_weight}, "
        f"{len(rots)} Galois keys, conj) {keygen_s:.2f} s, threefry at its shapes timed alone "
        f"{threefry_ms / 1e3:.3f} s by CUDA events over {draws} draws; Bootstrapper("
        f"factored, radix {BOOT_RADIX}, cheb, k_bound {BOOT_K_BOUND}) plans {plan_s:.2f} s, "
        f"{plan_misses} host encodes; key truncation {trunc_s:.2f} s, Galois and conj keys "
        f"{gib(full_bytes)} -> {gib(key_bytes(chest))}; StC at level "
        f"{bs.f_stc.first_lo.level}; peak device memory keygen {gib(peak['keygen'])}, plans "
        f"{gib(peak['plan'])}  [{smi}]", t)

    t = time.perf_counter()
    zr = np.random.default_rng(0)
    z = (zr.normal(size=params.slots) + 1j * zr.normal(size=params.slots)) * 0.2
    ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                     np.random.default_rng(1), params.scale, level=2)
    torch.cuda.synchronize()
    phases, per_phase = {}, {}
    m0, t1 = be.encode_misses, time.perf_counter()
    out = bs(ct, _phase=phase_hook(counts, phases, per_phase))
    torch.cuda.synchronize()
    first_s, first_misses = time.perf_counter() - t1, be.encode_misses - m0
    mark_peak("first call")
    errs = [decode_err(be.decrypt_decode(out), z, params.slots, "boot first call", BOOT_TOL)]
    for name, per in per_phase.items():
        if kernel_missing(per):
            raise AssertionError(f"boot phase {name}: a kernel did not run ({per})")
    say("boot_first", f"first call {first_s:.3f} s, {first_misses} host encodes; output level "
        f"{out.level}, scale 2^{math.log2(out.scale):.6f}; max |dec - z| = {errs[0]!r} < "
        f"{BOOT_TOL}; launches per phase {per_phase}  [{smi}]", t)

    t = time.perf_counter()
    steady, steady_ms, steady_launches = [], [], None
    for i in range(BOOT_STEADY):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        m0, before, t1 = be.encode_misses, counts(), time.perf_counter()
        start.record()
        out = bs(ct)
        stop.record()
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t1)
        steady_ms.append(start.elapsed_time(stop))
        steady_launches = {k: v - before[k] for k, v in counts().items()}
        if be.encode_misses != m0:
            raise AssertionError(f"steady call {i}: {be.encode_misses - m0} host encodes")
        errs.append(decode_err(be.decrypt_decode(out), z, params.slots, f"boot steady call {i}",
                               BOOT_TOL))
    call_ms = float(np.median(steady_ms))
    out, phase_s = bs.timed_call(ct)
    errs.append(decode_err(be.decrypt_decode(out), z, params.slots, "boot timed call", BOOT_TOL))
    events, steady_phase = [], {}
    bs(ct, _phase=phase_hook(counts, {}, steady_phase, events))
    phase_ms = event_ms(events)
    mark_peak("steady calls")
    say("boot_steady", f"{BOOT_STEADY} steady calls {[round(x, 4) for x in steady]} s (host "
        f"clock, synchronised), 0 host encodes each, launches per call {steady_launches}; "
        f"by CUDA events {[round(x, 3) for x in steady_ms]} ms, median {call_ms:.3f}, spread "
        f"{min(steady_ms):.3f} to {max(steady_ms):.3f}; one more call, per phase, CUDA events "
        f"(ms) " + ", ".join(f"{k} {v:.3f}" for k, v in phase_ms.items())
        + "; timed_call (host clock, synchronised at each phase; s) "
        + ", ".join(f"{k} {v:.4f}" for k, v in phase_s.items())
        + f"; launches per phase of a steady call {steady_phase}; max |dec - z| per call "
        f"{[f'{e:.3e}' for e in errs[1:]]} < {BOOT_TOL}  [{smi}]", t)

    t = time.perf_counter()
    busy, span, top = device_profile(lambda: bs(ct), iters=1)
    groups = {"K1": "k1_pass", "K3": K3_NAME, "K4": K4_NAME}
    traced = {g: sum(c for _, name, c in top if key in name) for g, key in groups.items()}
    per_group = {g: sum(ms for ms, name, _ in top if key in name) for g, key in groups.items()}
    say("boot_profile", f"one steady call under the profiler: device busy {busy:.3f} ms, "
        f"{busy / span:.1%} of its own CUDA-event time ({span:.3f} ms, the profiler's host cost "
        f"included), {busy / call_ms:.1%} of the unprofiled calls' median; per kernel (ms) "
        + ", ".join(f"{g} {ms:.3f}" for g, ms in per_group.items())
        + f", the rest {busy - sum(per_group.values()):.3f}; launches traced {traced}, made "
        f"{ {'K1': 2 * steady_launches['ntt'], 'K3': steady_launches['convert'], 'K4': steady_launches['mac']} }"
        f"; largest: " + "; ".join(f"{ms:.3f} {name[:50]}" for ms, name, _ in top[:6])
        + f"  [{smi}]", t)

    # the ModRaise stage on the CPU, from the same input and encapsulation
    # keys, in a background thread beside the card's next phases; boot_check
    # joins it at the end of the run
    launches["boot"] = counts()
    eph = {k: dkeys.DeviceKSKey(*(x.cpu() for x in chest.eph[k][1]))
           for k in ("to_eph", "from_eph")}
    x = dct.Ciphertext([c.cpu() for c in ct.c], ct.level, ct.scale)
    raised = phases["mod_raise"][0]

    def mod_raise_cpu():
        y = dct.ct_key_switch(x, params, ctx_cpu, eph["to_eph"])
        y = dct.ct_mod_raise2(y, params, ctx_cpu)
        return dct.ct_key_switch(y, params, ctx_cpu, eph["from_eph"])

    cpu_raise = in_background(mod_raise_cpu, "boot_check")

    def check(_cpu):
        t = time.perf_counter()
        y = cpu_raise()
        same_limbs(raised, y, "boot ModRaise stage")
        say("boot_check", f"ModRaise stage (to_eph, ct_mod_raise2, from_eph) == the CPU path at "
            f"{BOOT_PRESET} ({y.level} limbs x 2), computed in a background thread; peak "
            "device memory per step " + ", ".join(f"{k} {gib(v)}" for k, v in peak.items())
            + f"; launches {launches['boot']}  [{smi}]", t)

    boot_mac_check(params, ctx, bs, chest, smi)
    return {"check": check, "keygen_s": keygen_s, "threefry_s": threefry_ms / 1e3, "plan_s": plan_s,
            "first_s": first_s, "steady_s": steady,
            "event_ms": steady_ms, "busy_ms": busy, "span_ms": span, "max_err": max(errs),
            "call": lambda: bs(ct)}


def decode_float(coeffs: np.ndarray) -> np.ndarray:
    """The slots of a polynomial with float (or complex) coefficients: the
    canonical embedding that decode applies to integer ones."""
    from gpufhe_tpu_torch.golden import ckks as gckks

    n = coeffs.shape[0]
    tw = np.exp(1j * np.pi * np.arange(n) / n)
    return (np.fft.ifft(coeffs * tw) * n)[gckks._slot_positions(n)]


def boot_h_phase_errors(params, be, bs, chest, phases: dict, out, z) -> tuple[dict, dict]:
    """Each phase of a boot_h call against its own function applied to its
    own decrypted input, max |.| over the slots: CoeffToSlot against the
    exact t = u / (q0 k_bound) of the decrypted ModRaise output u (in the
    bit-reversed slot order of the factored transform), EvalMod against the
    Chebyshev series of sin(2 pi k_bound t) at the decrypted t, SlotToCoeff
    against q0 / (2 pi Delta) times the canonical embedding of the decrypted
    y as coefficients. Beside them (second dict) the largest |I| of the
    ModRaise overflow u = m + q0 I, the CoeffToSlot error's real and
    imaginary parts apart (the imaginary part is the conjugation's key-switch
    noise: u's values are real), and max |. - z| of the decrypted t taken
    through the exact sine and SlotToCoeff: the end-to-end error that the
    CoeffToSlot output's noise alone gives."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.fftboot import bit_rev_perm
    from gpufhe_tpu_torch.ciphertext.polyeval import sine_coeffs
    from gpufhe_tpu_torch.golden import ckks as gckks

    n, slots = params.n, params.slots
    q0k = params.q_primes[0] * bs.k_bound
    br = bit_rev_perm(slots)
    coeff = dct.decrypt_to_coeff(phases["mod_raise"][0], params, chest.device_sk, be.ctx)
    u = gckks.crt_compose_centered(coeff, params.q_primes).astype(np.float64)
    t = [be.decrypt_decode(x) for x in phases["coeff_to_slot"]]
    y = [be.decrypt_decode(x) for x in phases["evalmod"]]
    cheb = sine_coeffs(bs.k_bound)
    c = np.zeros(n, dtype=np.complex128)
    c[:slots][br], c[slots:][br] = y
    exact_sine = np.zeros(n, dtype=np.complex128)
    exact_sine[:slots][br], exact_sine[slots:][br] = (np.sin(2 * np.pi * bs.k_bound * ti)
                                                      for ti in t)
    m = gckks.crt_compose_centered(gckks.encode(z, params.scale, params.q_primes[:1], n),
                                   params.q_primes[:1]).astype(np.float64)
    dt = [ti - ui[br] / q0k for ti, ui in zip(t, (u[:slots], u[slots:]))]
    notes = {"|I| max": float(np.abs(np.round((u - m) / params.q_primes[0])).max()),
             "CtS real": max(float(np.abs(d.real).max()) for d in dt),
             "CtS imag": max(float(np.abs(d.imag).max()) for d in dt),
             "CtS noise end to end": float(np.abs(
                 decode_float(exact_sine * bs._stc_factor) - z).max())}
    return notes, {
        "CoeffToSlot": max(float(np.abs(d).max()) for d in dt),
        "EvalMod": max(float(np.abs(yi - np.polynomial.chebyshev.chebval(ti, cheb)).max())
                       for yi, ti in zip(y, t)),
        "SlotToCoeff": float(np.abs(be.decrypt_decode(out)
                                    - decode_float(c * bs._stc_factor)).max()),
    }


def key_switch_apart(tag, params, ctx, c1, chest, step, back=False) -> dict:
    """One key switch of c1 (NTT domain, at its level) against Galois key
    `step`, taken apart with each kernel == its plain version on these
    operands: K1 (the iNTT of c1, the NTT of the dnum raised digits, the iNTT
    of both Q+P accumulators; with `back`, the NTT of both ModDown outputs),
    K3 (ModUp per digit group, ModDown per component) and K4 (the digits
    against the key, its automorphism folded in). Returns the shapes held."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.golden import ckks as gckks
    from gpufhe_tpu_torch.ops import convert_cuda, mac_cuda, ntt_cuda
    from gpufhe_tpu_torch.primitives import keyswitch, rns

    level, n = c1.shape[0], params.n
    key = chest.galois_key(step)
    ksc = rns.make_ks_context(params, level, device=ctx.device)
    qp = keyswitch.qp_indices(params, level)
    idx_q, idx_qp = ctx.index(range(level), torch.int32), ctx.index(qp, torch.int32)
    held = {}

    def k1(v, idx, inverse, what):
        got = ntt_cuda.fourstep_cuda(v.reshape(-1, n).contiguous(), idx, ctx, inverse)
        exact(got, ntt_cuda.fourstep_plain(v.reshape(-1, n).contiguous(), idx, ctx, inverse),
              f"{tag} K1 {what}")
        held[f"K1 {what}"] = tuple(v.shape[:-1])
        return got.view(v.shape)

    def k3(v, tabs, what):
        got = convert_cuda.base_convert_cuda(v.contiguous(), tabs)
        exact(got, convert_cuda.base_convert_plain(v.contiguous(), tabs), f"{tag} K3 {what}")
        held[f"K3 {what}"] = f"{tabs.sq.numel()}->{tabs.dq.numel()}"
        return got

    coeff = k1(c1, idx_q, True, f"inv {level}")
    digits = torch.stack([k3(coeff[d0:d1], ksc.modup[g], f"ModUp group {g}")
                          for g, (d0, d1) in enumerate(rns.ks_groups(params, level))])
    digits = k1(digits, idx_qp, False, f"fwd {len(qp)} x {digits.shape[0]}")
    perm = dct.galois_perm(gckks.galois_exponent(step, n), ctx, torch.int32)
    rows = ctx.index(keyswitch.key_row_index(params, level, key.b_mont.shape[1]), torch.int32)
    args = (digits, key.b_mont, key.a_mont, rows, idx_qp, ctx, perm)
    acc = mac_cuda.mac_cuda(*args)
    exact(acc, mac_cuda.mac_plain(*args), f"{tag} K4")
    held["K4"] = f"D={digits.shape[0]} x T={len(qp)}, key {step}"
    acc = k1(acc, idx_qp, True, f"inv {len(qp)} x 2")
    down = torch.stack([k3(acc[i, level:], ksc.p2q, f"ModDown component {i}")
                        for i in range(2)])
    if back:
        k1(down, idx_q, False, f"fwd {level} x 2")
    return held


def boot_h_check(params, ctx, chest, ct, raised, smi) -> dict:
    """After the boot_h path's counts are read: the path's ModRaise stage ==
    the CPU path; regen_pk_a of the chest's pk seed on the card == on the CPU
    (== the key's own a); one Galois key's a rows == regen_ks_a of its seed;
    and one key switch of the raised ciphertext's c1 taken apart, each kernel
    == its plain version on these operands: K1 (iNTT at 30 limbs, the NTT of
    the 6 x 35 raised digits, the iNTT of both 35-limb accumulators), K3
    (ModUp 5->35 per group, ModDown 5->30 per component) and K4 (D = 6 x 35
    against the key, its automorphism folded in). Returns the shapes held."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.keys import device_keygen as dkg
    from gpufhe_tpu_torch.ops.context import make_context

    t = time.perf_counter()
    t1 = time.perf_counter()
    ctx_cpu = make_context(params, device="cpu")
    ctx_s = time.perf_counter() - t1
    x = dct.ct_mod_raise(dct.Ciphertext([c.cpu() for c in ct.c], ct.level, ct.scale), params,
                         ctx_cpu)
    same_limbs(raised, x, "boot_h ModRaise stage")
    pk_a = dkg.regen_pk_a(params, ctx, chest.seeds["pk"])
    exact(pk_a.cpu(), dkg.regen_pk_a(params, ctx_cpu, chest.seeds["pk"]),
          "boot_h regen_pk_a on the card against the CPU")
    exact(pk_a, chest.device_pk.a_mont, "boot_h regen_pk_a against the public key's a")
    step = next(iter(chest.galois))
    exact(dkg.regen_ks_a(params, ctx, chest.seeds[f"gk{step}"]), chest.galois_key(step).a_mont,
          f"boot_h regen_ks_a against Galois key {step}")

    held = key_switch_apart("boot_h", params, ctx, raised.c[1], chest, step)
    say("boot_h_check", f"ModRaise stage (ct_mod_raise from level 1) == the CPU path at "
        f"{params.num_limbs} limbs x 2 (CPU context {ctx_s:.2f} s); regen_pk_a card == CPU == "
        f"pk.a; regen_ks_a == Galois key {step}'s a; one key switch of the raised c1 against "
        f"Galois key {step}, each kernel == plain: " + "; ".join(
            f"{k} {v}" for k, v in held.items()) + f"  [{smi}]", t)
    return held


def boot_h_ring_run(device) -> tuple:
    """config5_boot_h's chain (its q and p primes, h=64, dnum 6) and the boot_h
    path's settings at N = 2^BOOT_H_RING_LOGN, with the path's draws
    (device_keygen from rng 7, z from rng 0, encryption from rng 1): the
    bootstrap on `device`: (backend, {phase: outputs}, output, z, Galois
    keys)."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys.device_keygen import device_keygen
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    params = dataclasses.replace(preset(BOOT_H_PRESET), n=2**BOOT_H_RING_LOGN)
    rots = tuple(bootstrap_rotations(params, "factored", BOOT_H_RADIX))
    zr = np.random.default_rng(0)
    z = (zr.normal(size=params.slots) + 1j * zr.normal(size=params.slots)) * 0.2
    ctx = make_context(params, device=device)
    chest = device_keygen(params, np.random.default_rng(7), rots, conjugation=True, ctx=ctx)
    be = DeviceBackend(params, ctx, chest)
    bs = Bootstrapper(be, transform="factored", radix_log=BOOT_H_RADIX, evalmod="cheb",
                      k_bound=BOOT_H_K_BOUND)
    ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                     np.random.default_rng(1), params.scale, level=1)
    phases = {}
    out = bs(ct, _phase=lambda name, outs: phases.__setitem__(
        name, outs if isinstance(outs, tuple) else (outs,)))
    return be, phases, out, z, len(rots)


def boot_h_ring(dev, smi) -> tuple:
    """Phase boot_h_ring: boot_h_ring_run on the card, its output decoded
    within DECODE_TOL of z, end to end. Returns that error and the check of
    every phase output == the CPU twin's (boot_h_ring_run("cpu"), run in
    the CI twins' process), limb for limb."""
    t = time.perf_counter()
    be, card, out, z, n_rots = boot_h_ring_run(dev)
    err = decode_err(be.decrypt_decode(out), z, be.params.slots, "boot_h_ring bootstrap")
    say("boot_h_ring", f"{BOOT_H_PRESET}'s chain and settings at N=2^{BOOT_H_RING_LOGN} "
        f"({n_rots} Galois keys, conj) on the card: phases {', '.join(card)}; end to end max "
        f"|dec - z| = {err:.6e} < {DECODE_TOL}  [{smi}]", t)

    def check(cpu):
        t = time.perf_counter()
        for name in card:
            for i, (g, w) in enumerate(zip(card[name], cpu["boot_h_ring"][name], strict=True)):
                same_limbs(g, w, f"boot_h_ring {name} output {i}")
        say("boot_h_ring_check", f"every phase output ({', '.join(card)}) of boot_h_ring on the "
            f"card == the CPU path limb for limb  [{smi}]", t)

    return err, check


def boot_h_path(dev, smi, counts, reset, launches: dict, bounds) -> dict:
    """Path boot_h: the single-word bootstrap at BOOT_H_PRESET, as the
    reference's scripts/bootstrap_n16.py drives it (see the module
    docstring). Returns its numbers for the summary and the kernels line."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    params = preset(BOOT_H_PRESET)
    peak = {}
    mark_peak = peak_marker(dev, peak)

    t = time.perf_counter()
    resident = torch.cuda.memory_allocated(dev)
    t1 = time.perf_counter()
    ctx = make_context(params, device=dev)
    ctx_s = time.perf_counter() - t1
    reset()
    torch.cuda.reset_peak_memory_stats(dev)
    rots = tuple(bootstrap_rotations(params, "factored", BOOT_H_RADIX))
    chest, keygen_s, threefry_ms, draws = timed_keygen(params, rots, ctx)
    mark_peak("keygen")
    t1 = time.perf_counter()
    be = DeviceBackend(params, ctx, chest)
    bs = Bootstrapper(be, transform="factored", radix_log=BOOT_H_RADIX, evalmod="cheb",
                      k_bound=BOOT_H_K_BOUND)
    mark_peak("plan")
    plan_s, plan_misses = time.perf_counter() - t1, be.encode_misses
    say("boot_h_setup", f"{BOOT_H_PRESET} (N={params.n}, {params.num_limbs} q-limbs, "
        f"{len(params.p_primes)} special primes, dnum {params.dnum}, h={params.hamming_weight}): "
        f"device memory held before it {gib(resident)}; context {ctx_s:.2f} s; device_keygen "
        f"(rlk, {len(rots)} Galois keys, conj) {keygen_s:.2f} s, threefry at its shapes timed "
        f"alone {threefry_ms / 1e3:.3f} s by CUDA events over {draws} draws; Galois and conj keys "
        f"{gib(key_bytes(chest))}; Bootstrapper(factored, radix {BOOT_H_RADIX}, cheb, k_bound "
        f"{BOOT_H_K_BOUND}) plans {plan_s:.2f} s, {plan_misses} host encodes; StC at level "
        f"{bs.f_stc.first_lo.level}; peak device memory keygen {gib(peak['keygen'])}, plans "
        f"{gib(peak['plan'])}  [{smi}]", t)

    t = time.perf_counter()
    zr = np.random.default_rng(0)
    z = (zr.normal(size=params.slots) + 1j * zr.normal(size=params.slots)) * 0.2
    ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                     np.random.default_rng(1), params.scale, level=1)
    torch.cuda.synchronize()
    phases, per_phase = {}, {}
    m0, t1 = be.encode_misses, time.perf_counter()
    out = bs(ct, _phase=phase_hook(counts, phases, per_phase))
    torch.cuda.synchronize()
    first_s, first_misses = time.perf_counter() - t1, be.encode_misses - m0
    mark_peak("first call")
    for name, per in per_phase.items():
        # a single-word ModRaise without encapsulation is two NTTs and no switch;
        # the tensor runs only in a phase that multiplies two ciphertexts
        need = ("ntt",) if name == "mod_raise" else tuple(k for k in per if k != "tensor")
        if min(per[k] for k in need) <= 0:
            raise AssertionError(f"boot_h phase {name}: a kernel did not run ({per})")
    # At full width the decode is printed, not held to DECODE_TOL: the
    # reference's own bootstrap on this chain decodes off by more than it from
    # N = 2^12 on (PERF.md section 6); boot_h_ring holds the path end to end
    # at N = 2^BOOT_H_RING_LOGN. Here each phase is held to its own function
    # of its own decrypted input, which a faulty phase would miss by far more.
    notes, phase_err = boot_h_phase_errors(params, be, bs, chest, phases, out, z)
    for name, err in phase_err.items():
        if not err < DECODE_TOL:
            raise AssertionError(f"boot_h {name} off its function by {err} (gate {DECODE_TOL})")
    got = be.decrypt_decode(out)
    if got.shape != (params.slots,) or not np.isfinite(got).all() or out.level < 1:
        raise AssertionError(f"boot_h output: shape {got.shape}, level {out.level}, finite "
                             f"{np.isfinite(got).all()}")
    err = float(np.abs(got - z).max())
    first = out
    say("boot_h_first", f"first call {first_s:.3f} s, {first_misses} host encodes; output "
        f"level {out.level}, scale 2^{math.log2(out.scale):.6f}; each phase against its "
        f"function of its decrypted input, max |.|: " + ", ".join(
            f"{k} {v:.3e}" for k, v in phase_err.items()) + f" < {DECODE_TOL}; end to end max "
        f"|dec - z| = {err:.6e} (not gated at this width: boot_h_ring gates it at N=2^"
        f"{BOOT_H_RING_LOGN}); CoeffToSlot output off u / (q0 k_bound) by max "
        f"{notes['CtS real']:.3e} in its real part, {notes['CtS imag']:.3e} in its imaginary "
        f"part; ModRaise |I| max {notes['|I| max']:.0f} (k_bound "
        f"{BOOT_H_K_BOUND}); the decrypted CoeffToSlot output through the exact sine and "
        f"SlotToCoeff: max |. - z| = {notes['CtS noise end to end']:.6e}; launches per phase "
        f"{per_phase}  [{smi}]", t)

    t = time.perf_counter()
    steady_ms, steady_launches = [], None
    for i in range(BOOT_H_STEADY):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        m0, before = be.encode_misses, counts()
        start.record()
        out = bs(ct)
        stop.record()
        torch.cuda.synchronize()
        steady_ms.append(start.elapsed_time(stop))
        steady_launches = {k: v - before[k] for k, v in counts().items()}
        if be.encode_misses != m0:
            raise AssertionError(f"boot_h steady call {i}: {be.encode_misses - m0} host encodes")
        same_limbs(out, first, f"boot_h steady call {i} against the first call")
    call_ms = float(np.median(steady_ms))
    out, phase_s = bs.timed_call(ct)
    events, steady_phase = [], {}
    bs(ct, _phase=phase_hook(counts, {}, steady_phase, events))
    phase_ms = event_ms(events)
    busy, span, top = device_profile(lambda: bs(ct), iters=1)
    mark_peak("steady calls")
    launches["boot_h"] = counts()
    groups = {"K1": "k1_pass", "K3": K3_NAME, "K4": K4_NAME}
    per_group = {g: sum(ms for ms, name, _ in top if key in name) for g, key in groups.items()}
    traced = {g: sum(c for _, name, c in top if key in name) for g, key in groups.items()}
    say("boot_h_steady", f"{BOOT_H_STEADY} steady calls by CUDA events "
        f"{[round(x, 3) for x in steady_ms]} ms, median {call_ms:.3f}, spread "
        f"{min(steady_ms):.3f} to {max(steady_ms):.3f}, 0 host encodes each, launches per call "
        f"{steady_launches}; one more call, per phase, CUDA events (ms) "
        + ", ".join(f"{k} {v:.3f}" for k, v in phase_ms.items())
        + "; timed_call (host clock, synchronised at each phase; s) "
        + ", ".join(f"{k} {v:.4f}" for k, v in phase_s.items())
        + f"; launches per phase of a steady call {steady_phase}; one profiled call: device "
        f"busy {busy:.3f} ms, {busy / span:.1%} of its own CUDA-event time ({span:.3f} ms, the "
        f"profiler's host cost included), {busy / call_ms:.1%} of the median; per kernel (ms) "
        + ", ".join(f"{g} {ms:.3f}" for g, ms in per_group.items())
        + f", the rest {busy - sum(per_group.values()):.3f}; launches traced {traced}; peak "
        f"device memory " + ", ".join(f"{k} {gib(v)}" for k, v in peak.items())
        + f"; every steady call's output == the first call's limb for limb; launches "
        f"{launches['boot_h']}  [{smi}]", t)

    held = boot_h_check(params, ctx, chest, ct, phases["mod_raise"][0], smi)
    bound = bounds.report(f"bootstrap at {BOOT_H_PRESET} (steady)", lambda: bs(ct))
    shapes = kernel_shapes("boot_h", params, ctx, chest, bounds, smi)
    ring_err, ring_check = boot_h_ring(dev, smi)
    return {"keygen_s": keygen_s, "threefry_s": threefry_ms / 1e3, "plan_s": plan_s,
            "first_s": first_s, "event_ms": steady_ms, "busy_ms": busy, "span_ms": span,
            "per_group": per_group, "per_call": steady_launches, "bound": bound,
            "max_err": err, "phase_err": phase_err, "notes": notes, "held": held, "peak": peak,
            "shapes": shapes, "ring_err": ring_err, "ring_check": ring_check}


def kernel_shapes(tag, params, ctx, chest, bounds, smi, inv_q=False) -> dict:
    """K1, K3 and K4 alone at the shapes a path's key switch at its top level
    gives them (the hoist's NTT of the dnum raised digits over Q+P: 6 x 35 at
    boot_h; ModUp of one digit group: 5->35; ModDown: 5->30; the MAC against
    one of its Galois keys: D = 6 x 35; with inv_q also the iNTT of one
    component over Q), on random canonical operands: CUDA-event and device
    ms per call, the bound, the plain version's ms."""
    from gpufhe_tpu_torch.ops import convert_cuda, mac_cuda, ntt_cuda
    from gpufhe_tpu_torch.ops.probes import cuda_ms
    from gpufhe_tpu_torch.primitives import keyswitch, rns

    t = time.perf_counter()
    level, alpha, n = params.num_limbs, len(params.p_primes), params.n
    gen = torch.Generator(ctx.device).manual_seed(SEED + 70)

    def rand(rows, lead=()):
        return torch.randint(0, 2**62, (*lead, len(rows), n), generator=gen,
                             device=ctx.device) % ctx.col("q", rows)

    ksc = rns.make_ks_context(params, level, device=ctx.device)
    qp = keyswitch.qp_indices(params, level)
    idx_qp = ctx.index(qp, torch.int32)
    key = next(iter(chest.galois.values()))[1]
    digits = rand(qp, (params.dnum,))
    x_up, x_down = rand(range(alpha)), rand(range(level, level + alpha))
    mac_rows = ctx.index(keyswitch.key_row_index(params, level, key.b_mont.shape[1]), torch.int32)
    flat = digits.reshape(-1, n)
    x_q = rand(range(level)) if inv_q else None
    cases = {
        **({f"ntt inv {level} x 1": (
            K1_NAME, 2, bounds.ntt(level, level),
            lambda: ntt_cuda.fourstep_cuda(x_q, ctx.index(range(level), torch.int32), ctx, True),
            lambda: ntt_cuda.fourstep_plain(x_q, ctx.index(range(level), torch.int32), ctx,
                                            True))} if inv_q else {}),
        f"ntt fwd {len(qp)} x {params.dnum}": (
            K1_NAME, 2, bounds.ntt(flat.shape[0], len(qp)),
            lambda: ntt_cuda.fourstep_cuda(flat, idx_qp, ctx, False),
            lambda: ntt_cuda.fourstep_plain(flat, idx_qp, ctx, False)),
        f"convert ModUp {alpha}->{len(qp)}": (
            K3_NAME, 1, bounds.conv(alpha, len(qp)),
            lambda: convert_cuda.base_convert_cuda(x_up, ksc.modup[0]),
            lambda: convert_cuda.base_convert_plain(x_up, ksc.modup[0])),
        f"convert ModDown {alpha}->{level}": (
            K3_NAME, 1, bounds.conv(alpha, level),
            lambda: convert_cuda.base_convert_cuda(x_down, ksc.p2q),
            lambda: convert_cuda.base_convert_plain(x_down, ksc.p2q)),
        f"mac D={params.dnum} T={len(qp)}": (
            K4_NAME, 1, bounds.mac(params.dnum, len(qp)),
            lambda: mac_cuda.mac_cuda(digits, key.b_mont, key.a_mont, mac_rows, idx_qp, ctx),
            lambda: mac_cuda.mac_plain(digits, key.b_mont, key.a_mont, mac_rows, idx_qp, ctx)),
    }
    out = {}
    for what, (pattern, kinds, work, call, plain) in cases.items():
        exact(call(), plain(), f"{tag} {what}")
        b_ms, b_by = bounds.ms(*work)
        out[what] = {"ms": cuda_ms(call), "device_ms": or_null(kernel_ms(call, pattern, kinds)[0]),
                     "plain_ms": cuda_ms(plain, iters=3), "bound_ms": b_ms, "bound_by": b_by}
    say(f"{tag}_shapes", f"alone at the {tag} path's shapes, == plain; CUDA-event / device / "
        "bound / plain ms per call: " + "; ".join(
            f"{k} {v['ms']:.4f} / {v['device_ms'] or math.nan:.4f} / {v['bound_ms']:.5f} "
            f"({v['bound_by']}) / "
            f"{v['plain_ms']:.3f}" for k, v in out.items()) + f"  [{smi}]", t)
    return out


# ---------------------------------------------------------------------------
# The integer schemes: BGV and BFV at INT_PRESET (bfv_n16, one chain that
# both read), and every op of both at CI size
# ---------------------------------------------------------------------------


class OpLog:
    """Runs named ops in turn and keeps each one's outputs (a list), the
    cleartexts its decrypts must give, and the kernel launches it made."""

    def __init__(self, counts):
        self.counts = counts
        self.outs, self.want, self.launches = {}, {}, {}

    def __call__(self, name: str, fn, want: list):
        before = self.counts()
        out = fn()
        self.outs[name] = out if isinstance(out, list) else [out]
        self.want[name] = want
        self.launches[name] = {k: v - before[k] for k, v in self.counts().items()}
        return out

    def check(self, path: str, k4: dict, rescales: dict) -> None:
        """K1, K3 and K4 ran on the path; K4 ran as often as each op in k4
        needs, and the rescale kernel as often as each op in rescales (every
        op of the log named there)."""
        total = {k: sum(p[k] for p in self.launches.values()) for k in self.counts()}
        if kernel_missing(total):
            raise AssertionError(f"{path}: a kernel did not run ({total})")
        for key, wants in (("mac", k4), ("rescale", rescales)):
            for name, want in wants.items():
                if self.launches[name][key] != want:
                    raise AssertionError(f"{path} {name}: {key} launched "
                                         f"{self.launches[name][key]} times, not {want}")
        if set(rescales) != set(self.launches):
            raise AssertionError(f"{path}: rescale launches given for {sorted(rescales)}, not "
                                 f"for each op {sorted(self.launches)}")


def exact_slots(got: np.ndarray, want: np.ndarray, what: str) -> int:
    """Raises unless an integer decrypt equals the cleartext mod t in every slot."""
    if got.shape != want.shape or not (got == want).all():
        bad = int((got != want).sum()) if got.shape == want.shape else got.size
        raise AssertionError(f"{what}: the decrypt differs from the cleartext mod t in {bad} "
                             f"of {want.size} slots")
    return want.size


def int_kernels(dev, smi) -> dict:
    """Phase int_kernels: on the card, K1 on BFV's aux context (all its limbs,
    at the batches the multiply gives it) and K3 at the integer paths' new
    tables (Q -> aux, B -> Q, B -> m_sk, and BGV's t-folded P -> Q), each ==
    its plain version, random and at x = q - 1. K4 runs at config5_boot's
    shapes (the same chain), held in mac_vs_plain."""
    from gpufhe_tpu_torch.ciphertext import bfv as dbfv
    from gpufhe_tpu_torch.ops import convert_cuda, ntt_cuda
    from gpufhe_tpu_torch.params.params import preset
    from gpufhe_tpu_torch.primitives import rns

    t = time.perf_counter()
    params = preset(INT_PRESET)
    level = params.num_limbs
    auxp, aux_ctx, tabs = dbfv.make_bfv_mul_context(params, level, device=dev)
    aux = auxp.q_primes
    rng = np.random.default_rng(SEED + 30)

    def rand(primes, batch=1):
        q = np.tile(np.asarray(primes, dtype=np.int64), batch)[:, None]
        return torch.from_numpy(rng.integers(0, q, size=(len(q), params.n),
                                             dtype=np.int64)).to(dev)

    ntt_err = 0
    idx = aux_ctx.index(range(len(aux)), torch.int32)
    for batch in (1, 3, 4):
        x = rand(aux, batch)
        for inverse in (False, True):
            ntt_err = max(ntt_err, exact(ntt_cuda.fourstep_cuda(x, idx, aux_ctx, inverse),
                                         ntt_cuda.fourstep_plain(x, idx, aux_ctx, inverse),
                                         f"K1 aux {len(aux)} x {batch} inverse={inverse}"))
    cases = {"Q->aux": tabs.q2aux, "B->Q": tabs.b2q, "B->m_sk": tabs.b2msk,
             "P->Q t-folded (BGV)": rns.make_ks_context(params, level, device=dev).p2q}
    conv_err = 0
    for what, tb in cases.items():
        top = (tb.sq[:, None] - 1).expand(tb.sq.numel(), params.n).contiguous()
        for data in (rand(tb.sq.tolist()), top):
            conv_err = max(conv_err, exact(convert_cuda.base_convert_cuda(data, tb),
                                           convert_cuda.base_convert_plain(data, tb),
                                           f"K3 {what}"))
    say("int_kernels", f"at {INT_PRESET}: K1 == plain, fwd and inv, on the aux context "
        f"({len(aux)} limbs, {min(aux).bit_length()}-{max(aux).bit_length()} bits) x 1, 3, 4; "
        f"K3 == plain at " + ", ".join(f"{k} {tb.sq.numel()}->{tb.dq.numel()}"
                                       for k, tb in cases.items())
        + f", random and at x = q - 1  [{smi}]", t)
    return {"ntt_err": ntt_err, "conv_err": conv_err, "conv": cases, "aux_ctx": aux_ctx}


def _decrypt_all(log: OpLog, decrypt, what: str) -> tuple[int, float]:
    """Decrypt every output of log's ops: (slots checked, seconds)."""
    t = time.perf_counter()
    slots = 0
    for name, cts in log.outs.items():
        for ct, w in zip(cts, log.want[name], strict=True):
            slots += exact_slots(decrypt(ct), w, f"{what} {name}")
    return slots, time.perf_counter() - t


def mul_inputs(params) -> tuple:
    """The mul path's two unit-disk slot vectors."""
    zr = np.random.default_rng(SEED + 1)
    return unit_disk(zr, params.slots), unit_disk(zr, params.slots)


def mul_path(ctx_, counts) -> tuple:
    """Path mul on ctx_'s device: keygen (rlk, Galois ROTATIONS, conj),
    encrypt x2, ct_mul_full: (chest, cts, product, launches in ct_mul_full)."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.params.params import preset

    params = preset(PRESET)
    chest = dkeys.keygen(params, np.random.default_rng(SEED), rotations=ROTATIONS,
                         conjugation=True, ctx=ctx_)
    cts = [dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx_,
                       np.random.default_rng(SEED + 2 + i), params.scale)
           for i, z in enumerate(mul_inputs(params))]
    before = counts()
    prod = dct.ct_mul_full(cts[0], cts[1], params, ctx_, chest.device_rlk)
    return chest, cts, prod, {k: v - before[k] for k, v in counts().items()}


def dw_inputs(dw) -> tuple:
    zd = np.random.default_rng(SEED + 5)
    return unit_disk(zd, dw.slots), unit_disk(zd, dw.slots)


def dw_path(ctx_, counts) -> tuple:
    """Path dw: the config5_boot_dw multiply on ctx_'s device."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.params.params import preset

    dw = preset(DW_PRESET)
    chest_ = dkeys.keygen(dw, np.random.default_rng(SEED + 6), ctx=ctx_)
    ca, cb = (dct.encrypt(encoder.encode(z, dw), dw, chest_.device_pk, ctx_,
                          np.random.default_rng(SEED + 7 + i), dw.scale)
              for i, z in enumerate(dw_inputs(dw)))
    before = counts()
    out = dct.ct_mul_full(ca, cb, dw, ctx_, chest_.device_rlk)
    return chest_, (ca, cb), out, {k: v - before[k] for k, v in counts().items()}


def rotate_inputs(params) -> tuple:
    zr = np.random.default_rng(SEED + 9)
    zs = [unit_disk(zr, params.slots) for _ in range(3)]
    return zs, [unit_disk(zr, params.slots) for _ in range(3)]


def golden_mod_raise_input(params) -> tuple:
    """The rotate path's first ciphertext's slot vector, encryption seed and
    scale: golden_n16 holds the card's ct_mod_raise of its base limbs, and
    the rotation family on it, == the golden model's."""
    return rotate_inputs(params)[0][0], SEED + 10, float(2**ROT_SCALE_BITS)


def card_mod_raise(params, ctx_, chest_):
    """ct_mod_raise on ctx_'s device of the rotate path's first ciphertext
    (encrypted again from its seed) cut to its base limbs."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.encoding import encoder

    z, seed, scale = golden_mod_raise_input(params)
    ct = dct.encrypt(encoder.encode(z, params, scale), params, chest_.device_pk, ctx_,
                     np.random.default_rng(seed), scale)
    w = params.scale_words
    return dct.ct_mod_raise(dct.Ciphertext([c[:w] for c in ct.c], w, ct.scale), params, ctx_)


def rotate_path(ctx_, chest_, counts) -> tuple:
    """Path rotate at PRESET on the mul path's keys: three ciphertexts at
    2^ROT_SCALE_BITS, three plaintexts at the preset's scale; ({op:
    outputs}, {op: launches})."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.params.params import preset

    params = preset(PRESET)
    zs, ws = rotate_inputs(params)
    scale, rot_scale = params.scale, float(2**ROT_SCALE_BITS)
    cts_ = [dct.encrypt(encoder.encode(z, params, rot_scale), params, chest_.device_pk, ctx_,
                        np.random.default_rng(SEED + 10 + i), rot_scale)
            for i, z in enumerate(zs)]
    ct = cts_[0]
    pts = [encoder.encode_to_device(w, params, ctx_) for w in ws]
    gks = {s: chest_.galois_key(s) for s in ROTATIONS}
    ops = {
        "ct_rotate 1": lambda: [dct.ct_rotate(ct, 1, params, ctx_, gks[1])],
        "ct_conjugate": lambda: [dct.ct_conjugate(ct, params, ctx_, chest_.conj_key())],
        f"ct_rotate_hoisted {list(ROTATIONS)}":
            lambda: dct.ct_rotate_hoisted(ct, list(ROTATIONS), params, ctx_, gks),
        "ct_mul_plain": lambda: [dct.ct_mul_plain(ct, pts[0], scale, ctx_)],
        "ct_plain_mac x3": lambda: [dct.ct_plain_mac(cts_, pts, None, params, ctx_,
                                                     rot_scale * scale)],
    }
    outs, per_op = {}, {}
    for name, op in ops.items():
        before = counts()
        outs[name] = op()
        per_op[name] = {k: v - before[k] for k, v in counts().items()}
    return outs, per_op


def int_inputs(scheme: str, params, ctx) -> tuple:
    """The bgv or bfv path's draws on ctx's device, from its seeds: (m1, m2,
    chest, plaintexts, (a, b), keygen seconds)."""
    from gpufhe_tpu_torch.ciphertext import bfv as dbfv
    from gpufhe_tpu_torch.ciphertext import bgv as dbgv
    from gpufhe_tpu_torch.golden import bfv as gbfv
    from gpufhe_tpu_torch.golden import bgv as gbgv

    mod, gold, base, rots = ((dbgv, gbgv, SEED + 31, INT_ROTATIONS) if scheme == "bgv"
                             else (dbfv, gbfv, SEED + 41, (1,)))
    tm = params.plain_modulus
    zr = np.random.default_rng(base)
    m1, m2 = (zr.integers(0, tm, size=params.n, dtype=np.int64) for _ in range(2))
    t = time.perf_counter()
    chest = mod.keygen(params, np.random.default_rng(base + 1), rotations=rots, ctx=ctx)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t
    pts = [gold.encode(m, params) for m in (m1, m2)]
    a, b = (mod.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(base + 2 + i))
            for i, pt in enumerate(pts))
    return m1, m2, chest, pts, (a, b), keygen_s


VECTOR_DIR = pathlib.Path(__file__).resolve().parent / "tests" / "vectors"
# the known-answer vectors a device path reaches (config1's 60-bit prime lies
# outside the device's word: golden_n16 checks it on the host)
GOLDEN_VECTORS = ("config2_rns", "config3_ckks", "config4_rotations", "bgv_integer",
                  "bfv_integer")


def golden_vector_run(name: str, dev) -> dict:
    """One file of tests/vectors through the port's device path on dev, from
    the seed and preset it stores (as tests/test_torch_rns.py,
    test_torch_pipeline.py, test_torch_rotations.py, test_torch_bgv.py and
    test_torch_bfv.py reproduce it on the CPU): every array it stores that a
    device path computes == dev's output. Returns the arrays and limbs
    compared."""
    from gpufhe_tpu_torch.ciphertext import bfv as dbfv
    from gpufhe_tpu_torch.ciphertext import bgv as dbgv
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.golden import bgv as gbgv
    from gpufhe_tpu_torch.golden import ckks as gckks
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.ops import convert_cuda
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.ops.modops import add_mod, mul_mod
    from gpufhe_tpu_torch.params.params import preset
    from gpufhe_tpu_torch.primitives import rns

    want = np.load(VECTOR_DIR / f"{name}.npz")
    params = preset(name if name == "config2_rns" else want["preset"].item().decode())
    ctx = make_context(params, device=dev)
    seed = None if name == "config2_rns" else int(want["seed"])
    got = {}

    def ct_arrays(tag, ct):
        for i, c in enumerate(ct.c):
            got[f"{tag}_c{i}"] = c

    if name == "config2_rns":
        if tuple(want["q_primes"]) != params.q_primes or tuple(want["p_primes"]) != params.p_primes:
            raise AssertionError("config2_rns: the stored primes are not the preset's")
        level = params.num_limbs
        q = ctx.col("q", range(level))
        a, b = (torch.from_numpy(want[k]).to(ctx.device) for k in ("a", "b"))
        got["add"], got["mul"] = add_mod(a, b, q), mul_mod(a, b, q)
        got["base_convert_to_p"] = convert_cuda.base_convert(
            a, convert_cuda.make_convert_tables(params.q_primes, params.p_primes, ctx.device))
        got["rescale"] = rns.rescale(a, params, level, ctx,
                                     rns.make_ks_context(params, level, device=ctx.device))
    elif name == "config3_ckks":
        chest = dkeys.keygen(params, np.random.default_rng(seed), ctx=ctx)
        ca, cb = (dct.encrypt(encoder.encode(want[z], params), params, chest.device_pk, ctx,
                              np.random.default_rng(seed + 2 + i), params.scale)
                  for i, z in enumerate(("za", "zb")))
        t = dct.ct_tensor(ca, cb, ctx)
        r = dct.ct_relinearize(t, params, ctx, chest.device_rlk)
        s = dct.ct_rescale(r, params, ctx)
        got.update({"ct_a0": ca.c[0], "ct_a1": ca.c[1], **{f"tensor_d{i}": c for i, c in
                                                          enumerate(t.c)}})
        ct_arrays("relin", r)
        ct_arrays("rescale", s)
        got["decrypt_coeff"] = dct.decrypt_to_coeff(s, params, chest.device_sk, ctx)
    elif name == "config4_rotations":
        # the vector draws sk, pk and the two Galois keys, no rlk: the golden
        # key functions with ctx, in its order
        rng = np.random.default_rng(seed)
        sk, pk = gckks.keygen(params, rng, ctx=ctx)
        gks = {s: dkeys.upload_ks_key(gckks.make_galois_key(params, s, sk, rng, ctx=ctx), params,
                                      ctx=ctx) for s in (1, 3)}
        ct = dct.encrypt(encoder.encode(want["z"], params), params,
                         dkeys.upload_public_key(pk, params, ctx=ctx), ctx,
                         np.random.default_rng(seed + 2), params.scale)
        for s, out in zip((1, 3), dct.ct_rotate_hoisted(ct, [1, 3], params, ctx, gks)):
            ct_arrays(f"rot{s}", out)
    else:
        mod = dbgv if name == "bgv_integer" else dbfv
        tm = params.plain_modulus
        chest = mod.keygen(params, np.random.default_rng(seed), rotations=(1,), ctx=ctx)
        mrng = np.random.default_rng(seed + 1)
        m1, m2 = (mrng.integers(0, tm, size=params.n, dtype=np.int64) for _ in range(2))
        if not ((m1 == want["m1"]).all() and (m2 == want["m2"]).all()):
            raise AssertionError(f"{name}: the messages drawn from its seed are not its own")
        c1, c2 = (mod.encrypt(gbgv.encode(m, params), params, chest.device_pk, ctx,
                              np.random.default_rng(seed + 2 + i)) for i, m in enumerate((m1, m2)))
        prod = mod.ct_mul(c1, c2, params, ctx, chest.device_rlk)
        ct_arrays("ct1", c1)
        ct_arrays("mul", prod)
        ct_arrays("rot1", mod.ct_rotate(c1, 1, params, ctx, chest.galois_key(1)))
        if mod is dbgv:
            got["mul_pt_factor"] = prod.pt_factor
        else:
            ct_arrays("modred", dbfv.ct_mod_reduce(prod, params, ctx))
            sw = dbfv.bfv_to_bgv(c1, params, ctx)
            ct_arrays("switch", sw)
            got["switch_pt_factor"] = sw.pt_factor
    computed = {"m1", "m2", "za", "zb", "z", "a", "b", "q_primes", "p_primes", "seed", "preset"}
    missing = set(want.files) - computed - set(got)
    if missing:
        raise AssertionError(f"{name}: no device output for {sorted(missing)}")
    limbs = 0
    for key, value in got.items():
        arr = gckks.host_limbs(value)
        if arr.shape != want[key].shape or not (arr == want[key]).all():
            raise AssertionError(f"{name}: {key} on {dev} != the stored vector")
        limbs += arr.shape[0] if arr.ndim == 2 else 0
    return {"arrays": len(got), "limbs": limbs, "n": params.n}


def golden_vectors(dev, smi, counts, reset, launches: dict) -> None:
    """Phase golden_vectors: the five device-reachable files of tests/vectors
    on the card, every stored array == the card's output (golden_vector_run)."""
    t = time.perf_counter()
    reset()
    done = {}
    for name in GOLDEN_VECTORS:
        t1 = time.perf_counter()
        r = golden_vector_run(name, dev)
        done[name] = r
        print(f"golden_vectors {name}: {r['arrays']} arrays, {r['limbs']} limbs == the stored "
              f"vector at N={r['n']} ({time.perf_counter() - t1:.2f} s)  [{smi}]", flush=True)
    launches["golden_vectors"] = counts()
    if kernel_missing(launches["golden_vectors"]):
        raise AssertionError(f"golden_vectors: a kernel did not run ({launches['golden_vectors']})")
    say("golden_vectors", f"the card == {sum(r['arrays'] for r in done.values())} stored arrays "
        f"({sum(r['limbs'] for r in done.values())} limbs) of {', '.join(done)}; launches "
        f"{launches['golden_vectors']}  [{smi}]", t)


def golden_twins(lap) -> dict:
    """The "golden" CPU twins (golden_n16's host side, numpy only): all six
    known-answer vectors regenerated by the port's golden model, each == its
    file; the golden ct_mul at PRESET from the mul path's seeds, and from
    the rotate path's seeds its first ciphertext's ct_rotate 1,
    ct_conjugate, ct_rotate_hoisted ROTATIONS and the ct_mod_raise of its
    base limbs (golden_mod_raise_input); the golden BGV and BFV ct_mul at
    INT_PRESET from int_inputs' seeds; every key drawn in keys.keygen's order
    (sk, pk, rlk, the Galois keys of ROTATIONS, conj)."""
    from gpufhe_tpu_torch.golden import bfv as gbfv
    from gpufhe_tpu_torch.golden import bgv as gbgv
    from gpufhe_tpu_torch.golden import ckks as gckks
    from gpufhe_tpu_torch.golden import native, vectors
    from gpufhe_tpu_torch.params.params import preset

    out = {"native": native.get_lib() is not None}
    for name, gen in vectors.GENERATORS.items():
        got, want = gen(), np.load(VECTOR_DIR / f"{name}.npz")
        if sorted(got) != sorted(want.files) or any(
                np.asarray(got[k]).dtype != want[k].dtype
                or not (np.asarray(got[k]) == want[k]).all() for k in want.files):
            raise AssertionError(f"golden {name}: the regenerated vector != its file")
    lap("golden vectors x6")
    params = preset(PRESET)
    rng = np.random.default_rng(SEED)
    sk, pk = gckks.keygen(params, rng)
    rlk = gckks.make_relin_key(params, sk, rng)
    gks = {s: gckks.make_galois_key(params, s, sk, rng) for s in ROTATIONS}
    ck = gckks.make_conj_key(params, sk, rng)
    lap(f"golden keygen (sk, pk, rlk, Galois {list(ROTATIONS)}, conj)")
    cts = [gckks.encrypt(gckks.encode(z, params.scale, params.q_primes, params.n), params, pk,
                         np.random.default_rng(SEED + 2 + i), params.scale)
           for i, z in enumerate(mul_inputs(params))]
    lap("golden encrypt x2")
    out["mul"] = gckks.ct_mul(cts[0], cts[1], params, rlk)
    lap("golden ct_mul")
    z, seed, rot_scale = golden_mod_raise_input(params)
    ct = gckks.encrypt(gckks.encode(z, rot_scale, params.q_primes, params.n), params, pk,
                       np.random.default_rng(seed), rot_scale)
    lap(f"golden encrypt at 2^{ROT_SCALE_BITS}")
    out["ct_rotate 1"] = [gckks.ct_rotate(ct, 1, params, gks[1])]
    lap("golden ct_rotate 1")
    out["ct_conjugate"] = [gckks.ct_conjugate(ct, params, ck)]
    lap("golden ct_conjugate")
    out[f"ct_rotate_hoisted {list(ROTATIONS)}"] = gckks.ct_rotate_hoisted(
        ct, list(ROTATIONS), params, gks)
    lap(f"golden ct_rotate_hoisted {list(ROTATIONS)}")
    w = params.scale_words
    out["ct_mod_raise"] = [gckks.ct_mod_raise(gckks.Ciphertext([c[:w] for c in ct.c], w,
                                                               ct.scale), params)]
    lap("golden ct_mod_raise")
    ip = preset(INT_PRESET)
    for scheme, mod, base in (("bgv", gbgv, SEED + 31), ("bfv", gbfv, SEED + 41)):
        zr = np.random.default_rng(base)
        ms = [zr.integers(0, ip.plain_modulus, size=ip.n, dtype=np.int64) for _ in range(2)]
        rng = np.random.default_rng(base + 1)
        sk, pk = mod.keygen(ip, rng)
        rlk = mod.make_relin_key(ip, sk, rng)
        lap(f"golden {scheme} keygen (sk, pk, rlk)")
        a, b = (mod.encrypt(mod.encode(m, ip), ip, pk, np.random.default_rng(base + 2 + i))
                for i, m in enumerate(ms))
        out[scheme] = mod.ct_mul(a, b, ip, rlk)
        lap(f"golden {scheme} encrypt x2, ct_mul")
    return out


# torch threads of the CPU twins' processes (CpuTwins): the N=2^16 paths'
# twins take 3, the CI-size items', which are host work in small ops, take 1;
# the rest of the host's cores stay with the card's paths, whose launches are
# host work
CPU_TWIN_THREADS = {"n16": 3, "ci": 1, "golden": 1}


def cpu_twins(group: str, path: str) -> None:
    """The CPU twins of one group, from the same seeds as the card's paths,
    run in a process of their own (CpuTwins), their outputs and seconds
    written to `path` (torch.save). "n16": the mul, rotate and dw paths and
    one ct_mul each of bgv and bfv at INT_PRESET; "ci": the CI-size items
    checked card == CPU (boot_ci, int_ci, boot_h_ring, models_ci,
    session_ci, mesh_ci); "golden": the golden model's side of golden_n16
    (golden_twins, numpy)."""
    import os

    from gpufhe_tpu_torch.ciphertext import bfv as dbfv
    from gpufhe_tpu_torch.ciphertext import bgv as dbgv
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    torch.set_num_threads(CPU_TWIN_THREADS[group])
    os.nice(10)  # background work: the card's paths come first on the host
    none = dict
    out = {}
    secs = {}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        secs[name], t = time.perf_counter() - t, time.perf_counter()

    if group == "n16":
        ctx = make_context(preset(PRESET), device="cpu")
        chest, _, out["mul"], _ = mul_path(ctx, none)
        lap("mul")
        out["rotate"] = rotate_path(ctx, chest, none)[0]
        del chest
        lap("rotate")
        out["dw"] = dw_path(make_context(preset(DW_PRESET), device="cpu"), none)[2]
        lap("dw")
        ip = preset(INT_PRESET)
        ictx = make_context(ip, device="cpu")
        for scheme, mod in (("bgv", dbgv), ("bfv", dbfv)):
            _, _, chest, _, (a, b), _ = int_inputs(scheme, ip, ictx)
            out[scheme] = mod.ct_mul(a, b, ip, ictx, chest.device_rlk)
            lap(scheme)
    elif group == "golden":
        out = golden_twins(lap)
    else:
        out["boot_ci"] = boot_ci_run("cpu", none)[1]
        lap("boot_ci")
        out["int_ci"] = {scheme: int_ci_ops(scheme, "cpu") for scheme in ("bgv", "bfv")}
        lap("int_ci")
        out["boot_h_ring"] = boot_h_ring_run("cpu")[1]
        lap("boot_h_ring")
        out["models_ci"] = models_ci_run("cpu", none)[0]
        lap("models_ci")
        out["session_ci"] = session_ci_run("cpu", none)[0]
        lap("session_ci")
        out["mesh_ci"] = mesh_ci_run("cpu")
        lap("mesh_ci")
    out["secs"] = secs
    torch.save(out, path)


class CpuTwins:
    """cpu_twins(group) in a spawned process, started at once; result()
    waits for it and loads its outputs. The process never outlives the run."""

    def __init__(self, group: str):
        import atexit
        import multiprocessing
        import tempfile

        self.group = group
        self._dir = tempfile.TemporaryDirectory(prefix=f"cpu_twins_{group}")
        self._path = f"{self._dir.name}/twins.pt"
        self._proc = multiprocessing.get_context("spawn").Process(
            target=cpu_twins, args=(group, self._path), name=f"cpu_twins_{group}")
        self._proc.start()
        self._out = None
        atexit.register(self.stop)

    def result(self) -> dict:
        if self._out is None:
            self._proc.join()
            if self._proc.exitcode != 0:
                raise RuntimeError(f"the CPU twins' process {self.group} failed (exit "
                                   f"{self._proc.exitcode})")
            self._out = torch.load(self._path, weights_only=False)
            self.stop()
        return self._out

    def stop(self) -> None:
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join()
        self._dir.cleanup()


# the rotation family and ModRaise at PRESET that golden_n16 holds == the
# golden model (the rotate path's outputs, by their names there)
GOLDEN_ROTATE_OPS = ("ct_rotate 1", "ct_conjugate", f"ct_rotate_hoisted {list(ROTATIONS)}",
                     "ct_mod_raise")


def golden_n16(card: dict, smi):
    """Returns the check golden_n16: the card's ct_mul_full at PRESET (the
    mul path's product), its rotation family at PRESET (the rotate path's
    ct_rotate 1, ct_conjugate and ct_rotate_hoisted outputs, and
    card_mod_raise) and its BGV and BFV ct_mul at INT_PRESET (the bgv and
    bfv paths' first products) == the port's golden model from the same
    seeds, limb for limb, computed by the "golden" CPU twins in numpy (none
    of the port's kernels or torch ops), with the six known-answer vectors
    regenerated there, each == its file."""

    def check(cpu):
        t = time.perf_counter()
        gold = cpu["golden"]
        limbs = {k: same_limbs(card[k], gold[k], f"golden_n16 {k}")
                 for k in ("mul", "bgv", "bfv")}
        rot = {}
        for k in GOLDEN_ROTATE_OPS:
            outs, wants = card[k], gold[k]
            if len(outs) != len(wants):
                raise AssertionError(f"golden_n16 {k}: {len(outs)} outputs against "
                                     f"{len(wants)}")
            rot[k] = sum(same_limbs(o, g, f"golden_n16 {k} [{i}]")
                         for i, (o, g) in enumerate(zip(outs, wants)))
        say("golden_n16", f"the card == the golden model (numpy; the "
            f"{'native C' if gold['native'] else 'numpy'} golden NTT) limb for limb: "
            f"{PRESET} ct_mul_full {limbs['mul']} limbs, " + ", ".join(
                f"{k} {v}" for k, v in rot.items())
            + f" limbs (at 2^{ROT_SCALE_BITS}); {INT_PRESET} BGV ct_mul {limbs['bgv']} "
            f"(pt_factor {card['bgv'].pt_factor}) and BFV ct_mul {limbs['bfv']}; the six "
            f"vectors of tests/vectors regenerated == their files; host seconds "
            + ", ".join(f"{k} {v:.2f}" for k, v in gold["secs"].items())
            + f" (total {sum(gold['secs'].values()):.2f})  [{smi}]", t)

    return check


def bgv_path(dev, smi, counts, reset, launches) -> dict:
    """Paths bgv (the card) and bgv_check (one ct_mul on the CPU): keygen,
    encode and encrypt two slot vectors mod t, ct_mul, three squarings
    (level 30 -> 27, as the reference's scripts/bgv_n16_mult.py checks),
    ct_mul_plain, ct_add, ct_rotate(1) and ct_rotate_hoisted([1, 3]); every
    decrypt exact in all N slots."""
    from gpufhe_tpu_torch.ciphertext import bgv as dbgv
    from gpufhe_tpu_torch.golden import bgv as gbgv
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    params = preset(INT_PRESET)
    tm, n = params.plain_modulus, params.n
    t = time.perf_counter()
    reset()
    ctx = make_context(params, device=dev)
    m1, m2, chest, pts, (a, b), keygen_s = int_inputs("bgv", params, ctx)
    t1 = time.perf_counter()
    perms = {s: gbgv.slot_rotation_perm(params, s) for s in INT_ROTATIONS}
    host_s, t1 = time.perf_counter() - t1, time.perf_counter()
    rlk, gks = chest.device_rlk, {s: chest.galois_key(s) for s in INT_ROTATIONS}
    hoisted = f"ct_rotate_hoisted {list(INT_ROTATIONS)}"
    log = OpLog(counts)
    log("ct_mul a*b", lambda: dbgv.ct_mul(a, b, params, ctx, rlk), [m1 * m2 % tm])
    x, w = a, m1
    for i in range(3):
        w = w * w % tm
        x = log(f"square {i + 1}", lambda x=x: dbgv.ct_mul(x, x, params, ctx, rlk), [w])
    log("ct_mul_plain", lambda: dbgv.ct_mul_plain(
        a, dbgv.plaintext_to_device(pts[1], params, ctx, a.level), ctx), [m1 * m2 % tm])
    log("ct_add", lambda: dbgv.ct_add(a, b, ctx), [(m1 + m2) % tm])
    log("ct_rotate 1", lambda: dbgv.ct_rotate(a, 1, params, ctx, gks[1]), [m1[perms[1]]])
    log(hoisted, lambda: dbgv.ct_rotate_hoisted(a, list(INT_ROTATIONS), params, ctx, gks),
        [m1[perms[s]] for s in INT_ROTATIONS])
    torch.cuda.synchronize()
    ops_s = time.perf_counter() - t1
    slots, decrypt_s = _decrypt_all(
        log, lambda ct: dbgv.decrypt_decode(ct, params, chest.device_sk, ctx), "BGV")
    launches["bgv"] = counts()
    levels = [log.outs[f"square {i}"][0].level for i in (1, 2, 3)]
    if levels != [params.num_limbs - i for i in (1, 2, 3)]:
        raise AssertionError(f"three squarings went through levels {levels}")
    log.check("bgv", {"ct_mul a*b": 1, "square 1": 1, "ct_mul_plain": 1, "ct_add": 0,
                      "ct_rotate 1": 1, hoisted: len(INT_ROTATIONS)},
              # one ModSwitch a multiply, one launch each
              {**{f"square {i}": 1 for i in (1, 2, 3)}, "ct_mul a*b": 1, "ct_mul_plain": 0,
               "ct_add": 0, "ct_rotate 1": 0, hoisted: 0})
    say("bgv_path", f"at {INT_PRESET} (N={n}, L={params.num_limbs}, t={tm}): keygen (rlk, "
        f"Galois {INT_ROTATIONS}) {keygen_s:.2f} s; host encode x2 and slot permutations "
        f"{host_s:.2f} s; encrypt x2, {', '.join(log.outs)} {ops_s:.2f} s; {slots} slots "
        f"decrypted exactly in {decrypt_s:.2f} s; square levels {levels}, the third's "
        f"pt_factor {x.pt_factor}; launches {launches['bgv']}, per op {log.launches}  [{smi}]",
        t)

    def check(cpu):  # the CPU twin (cpu_twins), from the same seeds
        t = time.perf_counter()
        got = cpu["bgv"]
        same_limbs(log.outs["ct_mul a*b"][0], got, "BGV ct_mul")
        say("bgv_check", f"ct_mul limbs and pt_factor == the CPU path ({got.level} limbs x 2, "
            f"pt_factor {got.pt_factor})", t)

    return {"check": check, "params": params, "ctx": ctx, "chest": chest, "a": a, "b": b,
            "square_1": (log.outs["square 1"][0], log.want["square 1"][0]),
            "mul": (log.outs["ct_mul a*b"][0], log.want["ct_mul a*b"][0]),
            "per_mul": log.launches["ct_mul a*b"]}


def bfv_path(dev, smi, counts, reset, launches, bgv: dict) -> dict:
    """Paths bfv (the card) and bfv_check (one ct_mul on the CPU): keygen,
    encode and encrypt two slot vectors mod t, ct_mul, three squarings (the
    level stays, as the reference's scripts/bfv_n16_mult.py checks),
    ct_mod_reduce, ct_add_plain, ct_rotate(1), and bgv_to_bfv then
    bfv_to_bgv on the BGV path's first square (pt_factor != 1, the BGV
    keys); every decrypt exact in all N slots, the switches' with their
    message factors applied."""
    from gpufhe_tpu_torch.ciphertext import bfv as dbfv
    from gpufhe_tpu_torch.ciphertext import bgv as dbgv
    from gpufhe_tpu_torch.golden import bfv as gbfv
    from gpufhe_tpu_torch.ops.context import make_context

    params = bgv["params"]
    tm, n = params.plain_modulus, params.n
    t = time.perf_counter()
    reset()
    ctx = make_context(params, device=dev)
    m1, m2, chest, pts, (a, b), keygen_s = int_inputs("bfv", params, ctx)
    t1 = time.perf_counter()
    perm1 = gbfv.slot_rotation_perm(params, 1)
    rlk = chest.device_rlk
    log = OpLog(counts)
    prod = log("ct_mul a*b", lambda: dbfv.ct_mul(a, b, params, ctx, rlk), [m1 * m2 % tm])
    x, w = a, m1
    for i in range(3):
        w = w * w % tm
        x = log(f"square {i + 1}", lambda x=x: dbfv.ct_mul(x, x, params, ctx, rlk), [w])
    log("ct_mod_reduce", lambda: dbfv.ct_mod_reduce(prod, params, ctx), [m1 * m2 % tm])
    log("ct_add_plain", lambda: dbfv.ct_add_plain(a, pts[1], params, ctx), [(m1 + m2) % tm])
    log("ct_rotate 1", lambda: dbfv.ct_rotate(a, 1, params, ctx, chest.galois_key(1)),
        [m1[perm1]])
    torch.cuda.synchronize()
    ops_s = time.perf_counter() - t1
    slots, decrypt_s = _decrypt_all(
        log, lambda ct: dbfv.decrypt_decode(ct, params, chest.device_sk, ctx), "BFV")
    # the switches on the BGV path's ciphertext, decrypted under its keys
    t1 = time.perf_counter()
    sq, w = bgv["square_1"]
    sk = bgv["chest"].device_sk
    sw, factor = dbfv.bgv_to_bfv(sq, params, ctx)
    back = dbfv.bfv_to_bgv(sw, params, ctx)
    finv = pow(factor, -1, tm)
    slots += exact_slots(gbfv.decode(dbfv.decrypt(sw, params, sk, ctx) * finv % tm, params), w,
                         "bgv_to_bfv")
    slots += exact_slots(gbfv.decode(dbgv.decrypt(back, params, sk, ctx) * finv % tm, params),
                         w, "bfv_to_bgv")
    switch_s = time.perf_counter() - t1
    launches["bfv"] = counts()
    if [log.outs[f"square {i}"][0].level for i in (1, 2, 3)] != [params.num_limbs] * 3:
        raise AssertionError("a BFV multiply changed the level")
    log.check("bfv", {"ct_mul a*b": 1, "square 1": 1, "ct_mod_reduce": 0, "ct_add_plain": 0,
                      "ct_rotate 1": 1},
              # the multiply keeps its level; ct_mod_reduce drops one limb
              {**{f"square {i}": 0 for i in (1, 2, 3)}, "ct_mul a*b": 0, "ct_mod_reduce": 1,
               "ct_add_plain": 0, "ct_rotate 1": 0})
    say("bfv_path", f"at {INT_PRESET}: keygen (rlk, Galois (1,)) {keygen_s:.2f} s; encrypt "
        f"x2, {', '.join(log.outs)} {ops_s:.2f} s; bgv_to_bfv and bfv_to_bgv of the BGV "
        f"square (pt_factor {sq.pt_factor}, message factor {factor}, then pt_factor "
        f"{back.pt_factor}) {switch_s:.2f} s with their decrypts; {slots} slots decrypted "
        f"exactly ({decrypt_s:.2f} s for the ops'); launches {launches['bfv']}, per op "
        f"{log.launches}  [{smi}]", t)

    def check(cpu):  # the CPU twin (cpu_twins), from the same seeds
        t = time.perf_counter()
        got = cpu["bfv"]
        same_limbs(prod, got, "BFV ct_mul")
        say("bfv_check", f"ct_mul limbs == the CPU path ({got.level} limbs x 2)", t)

    return {"check": check, "ctx": ctx, "chest": chest, "a": a, "b": b, "per_mul": log.launches["ct_mul a*b"],
            "mul": (prod, log.want["ct_mul a*b"][0])}


def int_ci_ops(scheme: str, dev) -> dict:
    """Every op of one integer scheme at its CI preset (N=2^10) on one
    device, keys and data from SEED: {op: [ciphertexts]}, with a BSGS matvec
    and add_plain through the scheme's backend."""
    from gpufhe_tpu_torch.ciphertext import bfv as dbfv
    from gpufhe_tpu_torch.ciphertext import bgv as dbgv
    from gpufhe_tpu_torch.ciphertext import linalg
    from gpufhe_tpu_torch.ciphertext.bfv_backend import BFVDeviceBackend
    from gpufhe_tpu_torch.ciphertext.bgv_backend import BGVDeviceBackend
    from gpufhe_tpu_torch.golden import bgv as gbgv
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    mod, backend = (dbgv, BGVDeviceBackend) if scheme == "bgv" else (dbfv, BFVDeviceBackend)
    params = preset(f"{scheme}_ci")
    tm, n_s = params.plain_modulus, params.slots
    ctx = make_context(params, device=dev)
    rots = tuple(linalg.bsgs_rotations(n_s))
    chest = mod.keygen(params, np.random.default_rng(SEED + 50), rotations=rots, ctx=ctx)
    rng = np.random.default_rng(SEED + 51)
    m1, m2 = (rng.integers(0, tm, size=params.n) for _ in range(2))
    pts = [gbgv.encode(m, params) for m in (m1, m2)]
    a, b = (mod.encrypt(pt, params, chest.device_pk, ctx, np.random.default_rng(SEED + 52 + i))
            for i, pt in enumerate(pts))
    rlk, steps = chest.device_rlk, list(rots[:3])
    tensor = mod.ct_tensor(a, b, params, ctx)
    relin = mod.ct_relinearize(tensor, params, ctx, rlk)
    out = {"encrypt": [a, b], "ct_add": [mod.ct_add(a, b, ctx)], "ct_sub": [mod.ct_sub(a, b, ctx)],
           "ct_mul_plain": [mod.ct_mul_plain(a, mod.plaintext_to_device(pts[1], params, ctx,
                                                                        a.level), ctx)],
           "ct_tensor": [tensor], "ct_relinearize": [relin],
           "ct_mul": [mod.ct_mul(a, b, params, ctx, rlk)],
           "ct_rotate": [mod.ct_rotate(a, steps[0], params, ctx, chest.galois_key(steps[0]))],
           "ct_rotate_hoisted": mod.ct_rotate_hoisted(
               a, steps, params, ctx, {s: chest.galois_key(s) for s in steps})}
    if scheme == "bgv":
        out["ct_modswitch"] = [dbgv.ct_modswitch(relin, params, ctx)]
        sw, _ = dbfv.bgv_to_bfv(out["ct_mul"][0], params, ctx)
        out["bgv_to_bfv, bfv_to_bgv"] = [sw, dbfv.bfv_to_bgv(sw, params, ctx)]
    else:
        out["ct_mod_reduce"] = [dbfv.ct_mod_reduce(out["ct_mul"][0], params, ctx)]
        out["ct_add_plain"] = [dbfv.ct_add_plain(a, pts[1], params, ctx)]
        back = dbfv.bfv_to_bgv(a, params, ctx)
        out["bfv_to_bgv, bgv_to_bfv"] = [back, dbfv.bgv_to_bfv(back, params, ctx)[0]]
    be = backend(params, ctx, chest)
    mat = rng.integers(0, tm, size=(n_s, n_s))
    v = rng.integers(0, tm, size=(2, n_s))
    raw = np.empty(params.n, dtype=np.int64)
    raw[be.rings[0]], raw[be.rings[1]] = v[0], v[1]
    ct = mod.encrypt(gbgv.encode(raw, params), params, chest.device_pk, ctx,
                     np.random.default_rng(SEED + 54))
    av = linalg.matmul_plain(be, ct, mat)
    exact_slots(be.decrypt_decode(av), (mat.astype(object) @ v.T.astype(object) % tm).T
                .astype(np.int64), f"{scheme} backend matvec")
    out["backend matvec, add_plain"] = [av, be.add_plain(av, v)]
    return out


def int_ci(dev, smi, counts, reset, launches):
    """Phase int_ci: every BGV and BFV op at bgv_ci / bfv_ci (N=2^10) on the
    card, backends' matvecs included. Returns its check, int_ci_check: ==
    the CPU twin (int_ci_ops(scheme, "cpu"), run in the CI twins' process),
    limb for limb."""
    t = time.perf_counter()
    reset()
    card = {scheme: int_ci_ops(scheme, dev) for scheme in ("bgv", "bfv")}
    launches["int_ci"] = counts()
    if kernel_missing(launches["int_ci"]):
        raise AssertionError(f"int_ci: a kernel did not run ({launches['int_ci']})")
    done = "; ".join(f"{scheme}: {', '.join(ops)}" for scheme, ops in card.items())
    say("int_ci", f"on the card, {done}; launches {launches['int_ci']}  [{smi}]", t)

    def check(cpu):
        t = time.perf_counter()
        for scheme, ops in card.items():
            for name, cts in ops.items():
                for i, (g, c) in enumerate(zip(cts, cpu["int_ci"][scheme][name], strict=True)):
                    same_limbs(g, c, f"{scheme}_ci {name} [{i}]")
        say("int_ci_check", f"card == CPU limb for limb, {done}  [{smi}]", t)

    return check


def int_timing(bgv: dict, bfv: dict, ik: dict, bounds: Bounds, counts, smi) -> dict:
    """Phase int_timing at INT_PRESET, level 30: ms per BGV and per BFV
    ct_mul by CUDA events (INT_TIMED calls, each timed alone: median and
    spread), one call's launches, the device time of five profiled calls
    split by kernel (K1, K3, K4, the rest: the int64 elementwise layer),
    the busy share, each kernel's summed bound; the stage leaves (named as
    the reference's scripts/profile_mult_stages.py and profile_bfv_stages.py
    name them) by events; and K1 and K3 alone at the integer shapes (event
    and device time, bound). Returns the numbers for the kernels line."""
    from gpufhe_tpu_torch.ciphertext import bfv as dbfv
    from gpufhe_tpu_torch.ciphertext import bgv as dbgv
    from gpufhe_tpu_torch.ops import convert_cuda, ntt_cuda
    from gpufhe_tpu_torch.ops.convert_cuda import base_convert
    from gpufhe_tpu_torch.ops.modops import mul_mod, sub_mod
    from gpufhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
    from gpufhe_tpu_torch.ops.probes import cuda_ms
    from gpufhe_tpu_torch.primitives import keyswitch, rns

    t = time.perf_counter()
    params = bgv["params"]
    level, n = params.num_limbs, params.n
    rng = np.random.default_rng(SEED + 60)
    groups = {"K1": K1_NAME, "K3": K3_NAME, "K4": K4_NAME}

    def rand(c, rows, lead=()):
        q = np.asarray([c.primes[r] for r in rows], dtype=np.int64)[:, None]
        return torch.from_numpy(rng.integers(0, q, size=(*lead, len(rows), n),
                                             dtype=np.int64)).to(c.device)

    out = {}
    for scheme, st, mod in (("bgv", bgv, dbgv), ("bfv", bfv, dbfv)):
        ctx, a, b, rlk = st["ctx"], st["a"], st["b"], st["chest"].device_rlk

        def call(mod=mod, ctx=ctx, a=a, b=b, rlk=rlk):
            return mod.ct_mul(a, b, params, ctx, rlk)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        ev = []
        for _ in range(INT_TIMED):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            stop.record()
            torch.cuda.synchronize()
            ev.append(start.elapsed_time(stop))
        med = float(np.median(ev))
        before = counts()
        call()
        per_mul = {k: v - before[k] for k, v in counts().items()}
        iters = 5
        busy, span, top = device_profile(call, iters=iters)
        traced_ms = {g: sum(ms for ms, name, _ in top if re.search(pat, name))
                     for g, pat in groups.items()}
        traced = {g: sum(c for _, name, c in top if re.search(pat, name))
                  for g, pat in groups.items()}
        # the profiler drops launches from some traces: a kernel's time per
        # call is its mean per launch traced times the launches a call makes
        made = {"K1": 2 * per_mul["ntt"], "K3": per_mul["convert"], "K4": per_mul["mac"]}
        per_group = {g: traced_ms[g] * iters / traced[g] * made[g] if traced[g] else math.nan
                     for g in groups}
        rest = busy - sum(traced_ms.values())
        busy_all = rest + sum(per_group.values())
        bnd = bounds.report(f"{scheme} ct_mul", call)
        print(f"{scheme} ct_mul at {INT_PRESET} level {level}: CUDA events "
              f"{[round(x, 4) for x in ev]} ms, median {med:.4f}, spread {min(ev):.4f} to "
              f"{max(ev):.4f}; launches per call {per_mul}; {iters} profiled calls: device busy "
              f"{busy_all:.4f} ms per call with dropped kernel launches restored ({busy:.4f} as "
              f"traced; {busy_all / med:.1%} of the median, {busy / span:.1%} traced over the "
              f"profiled calls' own event time {span:.4f} ms); per kernel "
              + ", ".join(f"{g} {ms:.4f}" for g, ms in per_group.items())
              + f", the rest {rest:.4f} ms; kernel launches traced {traced} of "
              f"{ {g: m * iters for g, m in made.items()} }; summed bounds "
              + ", ".join(f"{k} {ms:.4f} ms over {c}" for k, (ms, c) in bnd.items())
              + f"  [{smi}]", flush=True)
        for ms, name, _ in top[:8]:
            print(f"profile {scheme} ct_mul kernel {ms:.4f} ms/call  {name[:90]}", flush=True)
        out[scheme] = {"event_ms": ev, "median_ms": med, "busy_ms": busy_all, "span_ms": span,
                       "per_kernel_ms": per_group, "per_mul": per_mul, "bounds": bnd}

    # stage leaves on random data at the multiply's shapes
    ctx, aux_ctx = bgv["ctx"], ik["aux_ctx"]
    auxp, _, tabs = dbfv.make_bfv_mul_context(params, level, device=ctx.device)
    a_rows = range(len(auxp.q_primes))
    q, aq = ctx.col("q", range(level)), aux_ctx.col("q", a_rows)
    xq, x_aux = rand(ctx, range(level)), rand(aux_ctx, a_rows)
    xqp = rand(ctx, keyswitch.qp_indices(params, level))
    xx = rand(ctx, range(level), (2,))
    ksc = rns.make_ks_context(params, level, device=ctx.device)
    fa, fb, frlk = bfv["a"], bfv["b"], bfv["chest"].device_rlk
    d_coeff = dbfv._tensor_coeff(fa.c, fb.c, params, ctx, level)

    def round_mid():
        r = mul_mod(xq, tabs.t_q, q)
        y = mul_mod(sub_mod(mul_mod(x_aux, tabs.t_aux, aq), base_convert(r, tabs.q2aux), aq),
                    tabs.qinv_aux, aq)
        return dbfv.sk_convert_to_q(y, tabs, q)

    leaves = {
        "bgv mul_full": lambda: dbgv.ct_mul(bgv["a"], bgv["b"], params, ctx,
                                            bgv["chest"].device_rlk),
        "bgv key_switch": lambda: keyswitch.key_switch_core(xq, params, level, ctx, ksc,
                                                            bgv["chest"].device_rlk,
                                                            eval_out=False),
        "bgv mod_down (t-folded)": lambda: rns.mod_down(xqp, params, level, ctx, ksc),
        "bgv modswitch": lambda: rns.bgv_modswitch(xx, params, level, ctx, ksc),
        "bfv bfv_mul_full": lambda: dbfv.ct_mul(fa, fb, params, ctx, frlk),
        "bfv bfv_tensor (coeff out)": lambda: dbfv._tensor_coeff(fa.c, fb.c, params, ctx,
                                                                 level),
        "bfv relin (coeff in and out)": lambda: dbfv._relin_coeff(d_coeff, params, ctx, level,
                                                                  frlk),
        "bfv to_aux_full": lambda: ntt_fwd(base_convert(ntt_inv(xq, ctx, limbs=range(level)),
                                                        tabs.q2aux), aux_ctx, limbs=a_rows),
        "bfv round_mid": round_mid,
        "bfv intt_q": lambda: ntt_inv(xq, ctx, limbs=range(level)),
        "bfv ntt_aux": lambda: ntt_fwd(x_aux, aux_ctx, limbs=a_rows),
        "bfv intt_aux": lambda: ntt_inv(x_aux, aux_ctx, limbs=a_rows),
    }
    leaf_ms = {name: cuda_ms(fn, iters=10) for name, fn in leaves.items()}
    print("integer stage leaves at " + INT_PRESET + ", CUDA events, ms per call: " + ", ".join(
        f"{k} {v:.4f}" for k, v in leaf_ms.items()) + f"  [{smi}]", flush=True)

    # K1 and K3 alone at the integer shapes
    shapes = {}
    idx = aux_ctx.index(a_rows, torch.int32)
    fwd = lambda: ntt_cuda.fourstep_cuda(x_aux, idx, aux_ctx, False)  # noqa: E731
    b_ms, b_by = bounds.ms(*bounds.ntt(len(a_rows), len(a_rows)))
    shapes[f"ntt aux {len(a_rows)}x1 fwd"] = {
        "ms": cuda_ms(fwd, iters=20), "device_ms": or_null(kernel_ms(fwd, K1_NAME, 2)[0]),
        "bound_ms": b_ms, "bound_by": b_by}
    for what, tb in ik["conv"].items():
        sq = tb.sq.cpu().numpy()[:, None]
        x = torch.from_numpy(rng.integers(0, sq, size=(len(sq), n), dtype=np.int64)).to(ctx.device)
        conv = lambda tb=tb, x=x: convert_cuda.base_convert_cuda(x, tb)  # noqa: E731
        b_ms, b_by = bounds.ms(*bounds.conv(tb.sq.numel(), tb.dq.numel()))
        shapes[f"convert {what} {tb.sq.numel()}->{tb.dq.numel()}"] = {
            "ms": cuda_ms(conv, iters=20), "device_ms": or_null(kernel_ms(conv, K3_NAME)[0]),
            "bound_ms": b_ms, "bound_by": b_by}
    for what, r in shapes.items():
        print(f"{what} x 2^{n.bit_length() - 1}: event {r['ms']:.4f} ms, device "
              f"{r['device_ms']} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})  [{smi}]",
              flush=True)
    out["shapes"] = shapes
    out["leaves"] = leaf_ms
    say("int_timing", f"ct_mul at {INT_PRESET} level {level}, CUDA-event median (spread) "
        f"BGV {out['bgv']['median_ms']:.3f} ({min(out['bgv']['event_ms']):.3f}-"
        f"{max(out['bgv']['event_ms']):.3f}) ms, BFV {out['bfv']['median_ms']:.3f} "
        f"({min(out['bfv']['event_ms']):.3f}-{max(out['bfv']['event_ms']):.3f}) ms; device "
        f"busy {out['bgv']['busy_ms']:.3f} / {out['bfv']['busy_ms']:.3f} ms", t)
    return out


# ---------------------------------------------------------------------------
# The models: the MNIST-shaped MLP at MLP_PRESET, the deep MLP refreshed by
# the flagship bootstrap at DEEP_PRESET, and every library and model at CI
# size on the card and on the CPU
# ---------------------------------------------------------------------------


def timed_plans(model) -> list:
    """Time the plans an EncryptedMLP builds on first use (host clock, the
    device synchronised): returns a one-element list that sums them."""
    spent, build = [0.0], model._plan

    def plan(i, level):
        if (i, level) not in model._plans:
            t = time.perf_counter()
            build(i, level)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t
        return model._plans[(i, level)]

    model._plan = plan
    return spent


def profiled(fn, counts) -> dict:
    """One call under the profiler: device busy ms, its own event ms, per
    kernel group ms and launches traced, and the launches the call made."""
    before = counts()
    busy, span, top = device_profile(fn, iters=1)
    made = {k: v - before[k] for k, v in counts().items()}
    groups = {"K1": "k1_pass", "K3": K3_NAME, "K4": K4_NAME}
    return {"busy_ms": busy, "span_ms": span,
            "per_group": {g: sum(ms for ms, name, _ in top if key in name)
                          for g, key in groups.items()},
            "traced": {g: sum(c for _, name, c in top if key in name)
                       for g, key in groups.items()},
            # device_profile runs fn once unprofiled first, then once traced
            "made": {k: v // 2 for k, v in made.items()}}


def mlp_n15_path(dev, smi, counts, reset, launches: dict, bounds) -> dict:
    """Path mlp_n15: the MNIST-shaped MLP at MLP_PRESET, nothing cut, as
    scripts/mlp_n15.py:43-88 drives it: weights and input from default_rng(1),
    device_keygen from default_rng(0) with the stack's own rotation steps and
    no conjugation key, the input encrypted at the full level from
    default_rng(2); one first forward (its plans timed apart) and MLP_STEADY
    steady forwards by CUDA events, each == the first limb for limb; one
    profiled forward; the logits within MLP_TOL of model.reference(x). After
    its counts are read, one key switch of the input taken apart (each kernel
    == plain at N=2^15) and each kernel alone at those shapes."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys.device_keygen import device_keygen
    from gpufhe_tpu_torch.models.mlp import EncryptedMLP, mlp_rotations_for
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    params = preset(MLP_PRESET)
    peak = {}
    mark_peak = peak_marker(dev, peak)
    t = time.perf_counter()
    ctx = make_context(params, device=dev)
    rng = np.random.default_rng(1)
    d_in, d_h, d_out = 784, 128, 10
    layers = [(rng.normal(size=(d_h, d_in)) * 0.1, rng.normal(size=d_h) * 0.1),
              (rng.normal(size=(d_out, d_h)) * 0.1, rng.normal(size=d_out) * 0.1)]
    reset()
    torch.cuda.reset_peak_memory_stats(dev)
    rots = mlp_rotations_for(layers, params.slots)
    t1 = time.perf_counter()
    chest = device_keygen(params, np.random.default_rng(0), rotations=tuple(rots),
                          conjugation=False, ctx=ctx)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t1
    mark_peak("keygen")
    be = DeviceBackend(params, ctx, chest)
    model = EncryptedMLP(be, layers)
    x = rng.normal(size=d_in) * 0.5
    slots_x = np.zeros(params.slots, dtype=np.complex128)
    slots_x[:d_in] = x
    ct = dct.encrypt(encoder.encode(slots_x, params), params, chest.device_pk, ctx,
                     np.random.default_rng(2), params.scale)
    key_gib = sum(8 * (k.b_mont.numel() + k.a_mont.numel()) for _, k in chest.galois.values())
    say("mlp_n15_setup", f"{MLP_PRESET} (N={params.n}, {params.num_limbs} q-limbs, "
        f"{len(params.p_primes)} special primes, dnum {params.dnum}): {d_in} -> {d_h} -> "
        f"{d_out}, square activation; device_keygen (rlk, {len(rots)} Galois keys, no conj) "
        f"{keygen_s:.2f} s, Galois keys {gib(key_gib)}; peak device memory keygen "
        f"{gib(peak['keygen'])}  [{smi}]", t)

    t = time.perf_counter()
    plan_s = timed_plans(model)
    m0, t1 = be.encode_misses, time.perf_counter()
    first = model(ct)
    torch.cuda.synchronize()
    first_s, first_misses = time.perf_counter() - t1, be.encode_misses - m0
    mark_peak("first forward")
    got = np.real(be.decrypt_decode(first)[:d_out])
    want = model.reference(x)
    err = float(np.abs(got - want).max())
    if got.shape != (d_out,) or not np.isfinite(got).all() or not err < MLP_TOL:
        raise AssertionError(f"mlp_n15 logits off model.reference by {err} (gate {MLP_TOL})")
    say("mlp_n15_first", f"first forward {first_s:.3f} s, of it plans {plan_s[0]:.3f} s "
        f"({len(model._plans)} plans, {first_misses} host encodes); output level "
        f"{first.level}; max |logit - reference| = {err!r} < {MLP_TOL} (MLP_N15.json: "
        f"{MLP_RECORD!r}; |reference| max {np.abs(want).max():.3f})  [{smi}]", t)

    t = time.perf_counter()
    steady_ms, per_forward, misses = [], None, []
    for i in range(MLP_STEADY):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        m0, before = be.encode_misses, counts()
        start.record()
        out = model(ct)
        stop.record()
        torch.cuda.synchronize()
        steady_ms.append(start.elapsed_time(stop))
        per_forward = {k: v - before[k] for k, v in counts().items()}
        misses.append(be.encode_misses - m0)
        same_limbs(out, first, f"mlp_n15 steady forward {i} against the first")
    # each forward encodes its layers' bias vectors (add_plain of a vector that
    # is not uniform encodes it, in the reference's backend as in the port's);
    # the plans' diagonals are encoded once
    if misses != [len(layers)] * MLP_STEADY:
        raise AssertionError(f"mlp_n15 steady forwards made {misses} host encodes, not "
                             f"{len(layers)} (the biases) each")
    prof = profiled(lambda: model(ct), counts)
    mark_peak("steady forwards")
    launches["mlp_n15"] = counts()
    call_ms = float(np.median(steady_ms))
    say("mlp_n15_steady", f"{MLP_STEADY} steady forwards by CUDA events "
        f"{[round(v, 3) for v in steady_ms]} ms, median {call_ms:.3f}, spread "
        f"{min(steady_ms):.3f} to {max(steady_ms):.3f}; host encodes per forward {misses} "
        f"(the {len(layers)} biases); launches per forward {per_forward}; one profiled forward: "
        f"device busy {prof['busy_ms']:.3f} ms, {prof['busy_ms'] / prof['span_ms']:.1%} of its "
        f"own CUDA-event time ({prof['span_ms']:.3f} ms), {prof['busy_ms'] / call_ms:.1%} of "
        f"the median; per kernel (ms) " + ", ".join(
            f"{g} {ms:.3f}" for g, ms in prof["per_group"].items())
        + f", the rest {prof['busy_ms'] - sum(prof['per_group'].values()):.3f}; launches "
        f"traced {prof['traced']}; peak device memory " + ", ".join(
            f"{k} {gib(v)}" for k, v in peak.items())
        + f"; every steady forward == the first limb for limb; launches {launches['mlp_n15']}"
        f"  [{smi}]", t)

    t = time.perf_counter()
    step = next(iter(chest.galois))
    held = key_switch_apart("mlp_n15", params, ctx, ct.c[1], chest, step, back=True)
    say("mlp_n15_check", f"one key switch of the input's c1 (level {ct.level}) against "
        f"Galois key {step}, each kernel == plain: " + "; ".join(
            f"{k} {v}" for k, v in held.items()) + f"  [{smi}]", t)
    bound = bounds.report(f"MLP forward at {MLP_PRESET}", lambda: model(ct))
    shapes = kernel_shapes("mlp_n15", params, ctx, chest, bounds, smi, inv_q=True)
    return {"keygen_s": keygen_s, "plan_s": plan_s[0], "first_s": first_s,
            "event_ms": steady_ms, "per_forward": per_forward, "bound": bound,
            "prof": prof, "peak": peak, "max_err": err, "keys": len(rots), "held": held,
            "shapes": shapes}


def deep_mlp_path(dev, smi, counts, reset, launches: dict) -> dict:
    """Path deep_mlp: scripts/deep_mlp_n16.py:40-150 at DEEP_PRESET, nothing
    cut: DEEP_LAYERS layers of width DEEP_D from default_rng(11), entered at
    level DEEP_IN_LEVEL, refreshed mid-inference by Bootstrapper(factored,
    radix 3, cheb, k_bound 10, lean_keys=True) (fuse_evalmod is inert in the
    port: EvalMod runs eagerly). Its own chest, as the script draws it:
    device_keygen(default_rng(7)) with the bootstrap's steps and the MLP's,
    conj; every Galois key truncated to the highest level it is used at, the
    MLP's steps at max(bootstrap output level, entry level). One first and
    DEEP_STEADY steady forwards (each == the first limb for limb), each with
    its mid-inference bootstraps timed apart by CUDA events; one profiled
    forward; the logits within DEEP_TOL of model.reference(x)."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys.device_keygen import device_keygen
    from gpufhe_tpu_torch.keys.keys import truncate_galois_device
    from gpufhe_tpu_torch.models.mlp import EncryptedMLP, mlp_rotations_for
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    params = preset(DEEP_PRESET)
    peak = {}
    mark_peak = peak_marker(dev, peak)
    t = time.perf_counter()
    resident = torch.cuda.memory_allocated(dev)
    ctx = make_context(params, device=dev)
    rng = np.random.default_rng(11)
    layers = [(rng.normal(size=(4 if i == DEEP_LAYERS - 1 else DEEP_D, DEEP_D))
               * (0.5 / np.sqrt(DEEP_D)),
               rng.normal(size=4 if i == DEEP_LAYERS - 1 else DEEP_D) * 0.05)
              for i in range(DEEP_LAYERS)]
    mlp_steps = mlp_rotations_for(layers, params.slots)
    boot_rots = bootstrap_rotations(params, transform="factored", radix_log=BOOT_RADIX)
    rots = sorted(set(boot_rots) | set(mlp_steps))
    reset()
    torch.cuda.reset_peak_memory_stats(dev)
    t1 = time.perf_counter()
    chest = device_keygen(params, np.random.default_rng(7), rotations=tuple(rots),
                          conjugation=True, ctx=ctx)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t1
    mark_peak("keygen")
    t1 = time.perf_counter()
    be = DeviceBackend(params, ctx, chest)
    bs = Bootstrapper(be, transform="factored", radix_log=BOOT_RADIX, evalmod="cheb",
                      k_bound=BOOT_K_BOUND, fuse_evalmod=True, lean_keys=True)
    boot_plan_s = time.perf_counter() - t1
    steps, conj_level = bs.galois_step_levels()
    boot_out = bs.f_stc.first_lo.level - bs.f_stc.levels_used
    mlp_level = max(boot_out, DEEP_IN_LEVEL)
    for s_ in mlp_steps:
        steps[s_] = max(steps.get(s_, 0), mlp_level)
    full_bytes = key_bytes(chest)
    truncate_galois_device(chest, steps, conj_level, params)
    mark_peak("plans and truncation")
    model = EncryptedMLP(be, layers, refresh=bs)
    x = rng.normal(size=DEEP_D) * 0.3
    slots_x = np.zeros(params.slots, dtype=np.complex128)
    slots_x[:DEEP_D] = x
    ct = dct.encrypt(encoder.encode(slots_x, params), params, chest.device_pk, ctx,
                     np.random.default_rng(2), params.scale, level=DEEP_IN_LEVEL)
    say("deep_mlp_setup", f"{DEEP_PRESET}: {DEEP_LAYERS} layers, d={DEEP_D}, input at level "
        f"{DEEP_IN_LEVEL}; device memory held before it {gib(resident)}; device_keygen (rlk, "
        f"eph h={params.eph_hamming_weight}, {len(boot_rots)} bootstrap + {len(mlp_steps)} MLP "
        f"steps = {len(rots)} Galois keys, conj) {keygen_s:.2f} s; Bootstrapper(factored, radix "
        f"{BOOT_RADIX}, cheb, k_bound {BOOT_K_BOUND}, lean_keys) plans {boot_plan_s:.2f} s; "
        f"keys truncated per step (MLP steps at level {mlp_level}, bootstrap output level "
        f"{boot_out}): Galois and conj keys {gib(full_bytes)} -> {gib(key_bytes(chest))}; peak "
        f"device memory keygen {gib(peak['keygen'])}, plans {gib(peak['plans and truncation'])}"
        f"  [{smi}]", t)

    boots = []  # (start, stop) CUDA events of each mid-inference bootstrap

    def refresh(c):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = bs(c)
        stop.record()
        boots.append((start, stop))
        return out

    model.refresh = refresh
    t = time.perf_counter()
    plan_s = timed_plans(model)
    m0, t1 = be.encode_misses, time.perf_counter()
    first = model(ct)
    torch.cuda.synchronize()
    first_s, first_misses = time.perf_counter() - t1, be.encode_misses - m0
    mark_peak("first forward")
    first_boot_ms = [a.elapsed_time(b) for a, b in boots]
    if model.refreshes != 2:
        raise AssertionError(f"deep_mlp: {model.refreshes} mid-inference bootstraps, not 2")
    d_out = layers[-1][0].shape[0]
    got = np.real(be.decrypt_decode(first)[:d_out])
    want = model.reference(x)
    err = float(np.abs(got - want).max())
    if got.shape != (d_out,) or not np.isfinite(got).all() or not err <= DEEP_TOL:
        raise AssertionError(f"deep_mlp logits off model.reference by {err} (gate {DEEP_TOL})")
    say("deep_mlp_first", f"first forward {first_s:.3f} s ({model.refreshes} mid-inference "
        f"bootstraps, by CUDA events {[round(v, 3) for v in first_boot_ms]} ms, the first "
        f"with the lean keys' drop and redraw), of it MLP plans {plan_s[0]:.3f} s, "
        f"{first_misses} host encodes; output level {first.level}; max |logit - reference| = "
        f"{err!r} <= {DEEP_TOL} (DEEP_MLP_N16.json: {DEEP_RECORD!r})  [{smi}]", t)

    t = time.perf_counter()
    steady_ms, boot_ms, per_forward, misses = [], [], None, []
    for i in range(DEEP_STEADY):
        boots.clear()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        m0, before = be.encode_misses, counts()
        start.record()
        out = model(ct)
        stop.record()
        torch.cuda.synchronize()
        steady_ms.append(start.elapsed_time(stop))
        boot_ms.append(sum(a.elapsed_time(b) for a, b in boots))
        per_forward = {k: v - before[k] for k, v in counts().items()}
        misses.append(be.encode_misses - m0)
        if model.refreshes != 2:
            raise AssertionError(f"deep_mlp steady forward {i}: {model.refreshes} bootstraps")
        same_limbs(out, first, f"deep_mlp steady forward {i} against the first")
    prof = profiled(lambda: model(ct), counts)
    mark_peak("steady forwards")
    launches["deep_mlp"] = counts()
    layer_ms = [a - b for a, b in zip(steady_ms, boot_ms)]
    say("deep_mlp_steady", f"{DEEP_STEADY} steady forwards by CUDA events "
        f"{[round(v, 3) for v in steady_ms]} ms: the 2 bootstraps {[round(v, 3) for v in boot_ms]}"
        f" ms, the layers {[round(v, 3) for v in layer_ms]} ms; host encodes per forward "
        f"{misses} (the {DEEP_LAYERS} biases); launches per forward {per_forward}; one profiled "
        f"forward: device busy {prof['busy_ms']:.3f} ms, "
        f"{prof['busy_ms'] / prof['span_ms']:.1%} of its own CUDA-event time "
        f"({prof['span_ms']:.3f} ms), {prof['busy_ms'] / float(np.median(steady_ms)):.1%} of "
        f"the median; per kernel (ms) " + ", ".join(
            f"{g} {ms:.3f}" for g, ms in prof["per_group"].items())
        + f", the rest {prof['busy_ms'] - sum(prof['per_group'].values()):.3f}; launches "
        f"traced {prof['traced']}; peak device memory " + ", ".join(
            f"{k} {gib(v)}" for k, v in peak.items())
        + f"; every steady forward == the first limb for limb; launches {launches['deep_mlp']}"
        f"  [{smi}]", t)
    return {"keygen_s": keygen_s, "plan_s": boot_plan_s + plan_s[0], "first_s": first_s,
            "event_ms": steady_ms, "boot_ms": boot_ms, "per_forward": per_forward,
            "prof": prof, "peak": peak, "max_err": err, "keys": len(rots)}


# models_ci: the items the smoke runs on the card and on the CPU (the modules
# whose port code differs most from the reference: the MLP's block-built plans
# through EncryptedCNN, approx, threshold's device partial, the batched
# multiply), and the rest, which tests/test_torch_kernels_gpu.py runs card ==
# CPU on the card (the smoke's time budget holds these five)
MODELS_CI_SMOKE = ("approx.inverse", "approx.layer_norm", "EncryptedCNN",
                   "threshold.partial_decrypt_device", "ct_mul_batched")
MODELS_CI_ITEMS = MODELS_CI_SMOKE + ("compare.relu", "exact.ct_equals_plain", "pir_retrieve",
                                     "EncryptedAttention", "EncryptedTransformerBlock",
                                     "EncryptedLogRegTrainer step")


def models_ci_run(device, counts, names=MODELS_CI_SMOKE) -> tuple[dict, dict, dict]:
    """The named library and model items at CI size on `device`, each at the
    preset and with the inputs of the reference's own test, its keys drawn
    there from numpy seeds (the same host draws on every device): ({item:
    [outputs]}, {item: decode error, or the slots held exact}, {item:
    launches and seconds})."""
    from gpufhe_tpu_torch.ciphertext import approx, batch, threshold
    from gpufhe_tpu_torch.ciphertext import bfv as dbfv
    from gpufhe_tpu_torch.ciphertext import bgv as dbgv
    from gpufhe_tpu_torch.ciphertext import compare as cmp
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.ciphertext.bfv_backend import BFVDeviceBackend
    from gpufhe_tpu_torch.ciphertext.bgv_backend import BGVDeviceBackend
    from gpufhe_tpu_torch.ciphertext.exact import ct_equals_plain
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.golden import bfv as gbfv
    from gpufhe_tpu_torch.golden import bgv as gbgv
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.models import attention, cnn, logreg_train, pir, transformer
    from gpufhe_tpu_torch.models.mlp import mlp_rotations_for
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    d, seq = 8, 8  # the attention packing's block and sequence length

    def ckks(name, rots=(), seed=0):
        params = preset(name)
        ctx = make_context(params, device=device)
        chest = dkeys.keygen(params, np.random.default_rng(seed), rotations=tuple(rots), ctx=ctx)
        be = DeviceBackend(params, ctx, chest)

        def enc(v, seed_):
            z = np.zeros(params.slots, dtype=np.complex128)
            z[: np.size(v)] = np.reshape(v, -1)
            return dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                               np.random.default_rng(seed_), params.scale)
        return params, be, enc

    def integer(name, keygen, backend, gold, mod, seed, rots=()):
        params = preset(name)
        ctx = make_context(params, device=device)
        chest = keygen(params, np.random.default_rng(seed), tuple(rots), ctx=ctx)
        be = backend(params, ctx, chest)

        def enc(v, seed_):
            raw = np.empty(params.n, dtype=np.int64)
            raw[be.rings[0]], raw[be.rings[1]] = v, v
            return mod.encrypt(gold.encode(raw, params), params, chest.device_pk, ctx,
                               np.random.default_rng(seed_))
        return params, be, enc

    def close(got, want, tol, what):
        return decode_err(np.asarray(got, dtype=np.complex128),
                          np.asarray(want, dtype=np.complex128), len(got), what, tol)

    # each item: () -> (the call, the check of its output)
    def relu():  # tests/test_compare.py:58 at ci_deep
        _, be, enc = ckks("ci_deep")
        r = np.random.default_rng(3)
        x = r.uniform(0.08, 0.9, size=64) * r.choice([-1.0, 1.0], size=64)
        return (lambda: cmp.relu(be, enc(x, 4)), lambda o: close(
            np.real(be.decrypt_decode(o)[:64]), np.maximum(x, 0.0), 0.02, "relu"))

    def inverse():  # tests/test_approx.py:34 at ci_deep
        params, be, enc = ckks("ci_deep")
        x = np.random.default_rng(1).uniform(0.2, 1.0, size=params.slots)
        return (lambda: approx.inverse(be, enc(x, 2), iters=5), lambda o: close(
            np.real(be.decrypt_decode(o)) * x, np.ones_like(x), 5e-3, "inverse"))

    def layer_norm():  # tests/test_approx.py:133 at ci_attn
        slots = preset("ci_attn").slots
        _, be, enc = ckks("ci_attn", approx.rotations_for_layernorm(slots, d), seed=30)
        r = np.random.default_rng(31)
        x = r.uniform(-1.0, 1.0, size=slots)
        gamma, beta = r.uniform(0.5, 1.5, size=d), r.uniform(-0.3, 0.3, size=d)
        blocks = x.reshape(-1, d)
        want = ((blocks - blocks.mean(axis=1, keepdims=True))
                / np.sqrt(blocks.var(axis=1, keepdims=True) + 5e-2) * gamma + beta).reshape(-1)
        return (lambda: approx.layer_norm(be, enc(x, 32), d, eps=5e-2, gamma=gamma, beta=beta,
                                          var_bound=1.0, iters=4),
                lambda o: close(np.real(be.decrypt_decode(o)), want, 5e-2, "layer_norm"))

    def cnn_item():  # tests/test_cnn.py:41 at ci_small, its plans from the blocks
        r = np.random.default_rng(1)
        kernels, bias = r.normal(size=(2, 1, 3, 3)) * 0.4, r.normal(size=2) * 0.2
        dense_w, dense_b = r.normal(size=(4, 18)) * 0.3, r.normal(size=4) * 0.2
        img = (r.normal(size=(1, 8, 8)) * 0.5).reshape(-1)
        slots = preset("ci_small").slots
        rots = mlp_rotations_for(cnn.compile_cnn(kernels, bias, (8, 8), dense_w, dense_b), slots)
        _, be, enc = ckks("ci_small", rots)
        net = cnn.EncryptedCNN(be, kernels, bias, (8, 8), dense_w, dense_b)
        return (lambda: net(enc(img, 2)), lambda o: close(
            np.real(be.decrypt_decode(o))[:4], net.reference(img), 1e-2, "cnn"))

    def trainer():  # tests/test_logreg_train.py:61 at ci_small
        slots = preset("ci_small").slots
        _, be, enc = ckks("ci_small", logreg_train.train_rotations(slots), seed=7)
        r = np.random.default_rng(0)
        m, f = 32, 2
        x = r.normal(size=(m, f))
        y = (x @ r.normal(size=f) > 0).astype(np.float64)
        tr = logreg_train.EncryptedLogRegTrainer(be, n_samples=m, lr=1.0)
        w0 = np.zeros(f)
        return (lambda: tr.fit([enc(np.full(slots, w0[j]), 30 + j) for j in range(f)],
                               [enc(x[:, j], 10 + j) for j in range(f)], enc(y, 20), iters=1),
                lambda o: close(np.array([np.real(be.decrypt_decode(w)[0]) for w in o]),
                                tr.reference(w0, x, y, 1), 1e-3, "trainer step"))

    def attention_item():  # tests/test_attention.py:36 at ci_attn
        slots = preset("ci_attn").slots
        _, be, enc = ckks("ci_attn", attention.attention_rotations(slots, d))
        r = np.random.default_rng(1)
        xs = r.uniform(-0.5, 0.5, size=(seq, d))
        wq, wk, wv, wo = (r.uniform(-0.4, 0.4, size=(d, d)) for _ in range(4))
        head = attention.EncryptedAttention(be, wq, wk, wv, wo=wo, seq_len=seq)
        return (lambda: head(enc(xs, 2)), lambda o: close(
            np.real(be.decrypt_decode(o))[:d],
            attention.attention_reference(xs, wq, wk, wv, wo=wo), 2e-2, "attention"))

    def transformer_item():  # tests/test_transformer.py:24 at ci_xf
        slots = preset("ci_xf").slots
        _, be, enc = ckks("ci_xf", transformer.transformer_rotations(slots, d))
        r = np.random.default_rng(1)
        xs = r.uniform(-0.5, 0.5, size=(seq, d))
        att = tuple(r.uniform(-0.4, 0.4, size=(d, d)) for _ in range(4))
        w1, w2 = r.uniform(-0.3, 0.3, size=(16, d)), r.uniform(-0.3, 0.3, size=(d, 16))
        b1, b2 = r.uniform(-0.1, 0.1, size=16), r.uniform(-0.1, 0.1, size=d)
        g1, g2 = (r.uniform(0.8, 1.2, size=d) for _ in range(2))
        be1, be2 = (r.uniform(-0.2, 0.2, size=d) for _ in range(2))
        block = transformer.EncryptedTransformerBlock(
            be, att, (w1, b1, w2, b2), ln_weights=(g1, be1, g2, be2), seq_len=seq, ln_iters=5)
        return (lambda: block(enc(xs, 2)), lambda o: close(
            np.real(be.decrypt_decode(o))[:d], block.reference(xs), 5e-2, "transformer"))

    def equals_plain():  # tests/test_exact_predicates.py:54 at bfv_eq: exact
        params, be, enc = integer("bfv_eq", dbfv.keygen, BFVDeviceBackend, gbfv, dbfv, 51)
        r = np.random.default_rng(3)
        v, w = r.integers(0, 10, size=params.slots), r.integers(0, 10, size=params.slots)
        return (lambda: ct_equals_plain(be, enc(v, 4), w), lambda o: exact_slots(
            be.decrypt_decode(o), np.stack([v == w] * 2).astype(np.int64), "ct_equals_plain"))

    def pir_item():  # tests/test_pir.py:12 at bgv_tiny, index 17: exact
        rots = pir.pir_rotations(preset("bgv_tiny").slots)
        params, be, enc = integer("bgv_tiny", dbgv.keygen, BGVDeviceBackend, gbgv, dbgv, 3, rots)
        db = np.random.default_rng(4).integers(0, params.plain_modulus, size=(50, 8))
        query = pir.encode_query(be, 17, 50)
        return (lambda: pir.pir_retrieve(be, enc(query, 67), db), lambda o: exact_slots(
            be.decrypt_decode(o)[0][:8], db[17], "pir_retrieve"))

    def partial():  # tests/test_threshold.py:84 at tiny2, == the host partial
        params = preset("tiny2")
        ctx = make_context(params, device=device)
        a = threshold.common_a(params, 7)
        shares = [threshold.party_keygen(params, a, np.random.default_rng(100 + i))
                  for i in range(3)]
        pk = dkeys.upload_public_key(
            threshold.aggregate_public_key(params, a, [s.b for s in shares]), params, ctx=ctx)
        z = np.random.default_rng(8).uniform(-1, 1, size=params.slots)
        ct = dct.encrypt(encoder.encode(z + 0j, params), params, pk, ctx,
                         np.random.default_rng(9), params.scale)
        s_mont = threshold.upload_share(shares[0], params, ctx=ctx)

        def check(o):
            exact(o.cpu(), torch.from_numpy(threshold.partial_decrypt(
                ct, params, shares[0], np.random.default_rng(50))), "partial_decrypt_device")
            return o.numel()
        return (lambda: threshold.partial_decrypt_device(
            ct, params, ctx, s_mont, shares[0], np.random.default_rng(50)), check)

    def batched():  # tiny2, B = 3: each element == ct_mul_full of its pair
        params = preset("tiny2")
        ctx = make_context(params, device=device)
        chest = dkeys.keygen(params, np.random.default_rng(0), ctx=ctx)
        r = np.random.default_rng(1)
        zs = [r.uniform(-1, 1, size=(2, params.slots)) for _ in range(3)]
        pairs = [[dct.encrypt(encoder.encode(z[k] + 0j, params), params, chest.device_pk, ctx,
                              np.random.default_rng(10 + 2 * i + k), params.scale)
                  for k in range(2)] for i, z in enumerate(zs)]

        def call():
            return batch.unstack(batch.ct_mul_batched(
                *(batch.stack([p[k] for p in pairs]) for k in range(2)), params, ctx,
                chest.device_rlk))

        def check(o):
            for i, (got, (x, y)) in enumerate(zip(o, pairs)):
                same_limbs(got, dct.ct_mul_full(x, y, params, ctx, chest.device_rlk),
                           f"ct_mul_batched element {i} against ct_mul_full")
            return max(close(dct.decrypt_decode(got, params, chest.device_sk, ctx), z[0] * z[1],
                             DECODE_TOL, "ct_mul_batched") for got, z in zip(o, zs))
        return call, check

    items = {"compare.relu": relu, "approx.inverse": inverse, "approx.layer_norm": layer_norm,
             "EncryptedCNN": cnn_item, "EncryptedLogRegTrainer step": trainer,
             "EncryptedAttention": attention_item,
             "EncryptedTransformerBlock": transformer_item,
             "exact.ct_equals_plain": equals_plain, "pir_retrieve": pir_item,
             "threshold.partial_decrypt_device": partial, "ct_mul_batched": batched}
    outs, errs, per_item = {}, {}, {}
    for name in names:
        call, check = items[name]()
        before, t = counts(), time.perf_counter()
        out = call()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        per_item[name] = {k: v - before[k] for k, v in counts().items()}
        per_item[name]["s"] = round(time.perf_counter() - t, 3)
        outs[name] = out if isinstance(out, list) else [out]
        errs[name] = check(out)
    return outs, errs, per_item


def same_outputs(got: dict, want: dict, what: str) -> int:
    """Every output of models_ci_run == its twin: ciphertexts limb for limb,
    tensors element for element. Returns how many were held."""
    n = 0
    for name, outs in got.items():
        for i, (g, w) in enumerate(zip(outs, want[name], strict=True)):
            if isinstance(g, torch.Tensor):
                exact(g.cpu(), w.cpu(), f"{what} {name} [{i}]")
            else:
                same_limbs(g, w, f"{what} {name} [{i}]")
            n += 1
    return n


def models_ci(dev, smi, counts, reset, launches: dict) -> tuple:
    """Path models_ci: the MODELS_CI_SMOKE items of models_ci_run on the card,
    each decoded within the tolerance of the reference's test. Returns the
    launches per item and the check, models_ci_check: every output == the
    CPU twin's (models_ci_run("cpu"), with the same keys and draws, run in
    the CI twins' process), limb for limb."""
    t = time.perf_counter()
    reset()
    outs, errs, per_item = models_ci_run(dev, counts)
    launches["models_ci"] = counts()
    for name, per in per_item.items():
        if per["ntt"] <= 0:
            raise AssertionError(f"models_ci {name}: K1 did not run ({per})")
    if kernel_missing(launches["models_ci"]):
        raise AssertionError(f"models_ci: a kernel did not run ({launches['models_ci']})")
    say("models_ci", "on the card: " + "; ".join(
        f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v} values exact"
        for k, v in errs.items()) + f"; launches and seconds per item {per_item}  [{smi}]", t)

    def check(cpu):
        t = time.perf_counter()
        n = same_outputs(outs, cpu["models_ci"], "models_ci")
        say("models_ci_check", f"{n} outputs of {len(outs)} items == the CPU path limb for "
            f"limb ({', '.join(outs)}); the other items ("
            f"{', '.join(MODELS_CI_ITEMS[len(outs):])}) run card == CPU in "
            f"tests/test_torch_kernels_gpu.py  [{smi}]", t)

    return per_item, check


# The Session facade at N=2^16: config5_boot (CKKS) and bfv_n16 (BFV), through
# gpufhe_tpu_torch.api as a user would call it. Session.encrypt encrypts at the
# preset's Delta = 2^28, where a rotation's key switch decodes off by 0.068 in
# the reference's golden model as in the port (ROT_SCALE_BITS above;
# tests/test_torch_rotation_noise.py), above DECODE_TOL for any input. A wrong
# rotation (the wrong slot) is off by about 1 on unit-disk slots, so the
# session's rotation is gated below SESSION_ROT_TOL, ten times that noise's
# scale below a wrong slot.
SESSION_ROT_TOL = 0.1
# session_ci runs SESSION_CI_SMOKE; tests/test_torch_kernels_gpu.py runs every
# item of SESSION_CI_ITEMS card == CPU (with all five the smoke ran past 270 s of its
# budget on an H100 80GB HBM3 whose host ran the earlier CPU checks slowly)
SESSION_CI_SMOKE = ("ckks tiny2", "bfv bfv_tiny", "threshold tiny2")
SESSION_CI_ITEMS = SESSION_CI_SMOKE + ("bgv bgv_tiny", "bootstrap boot_dw_ci_enc")


def session_ckks(dev, smi, counts, reset, launches: dict, times: dict) -> dict:
    """Path session_ckks: Session.create(PRESET, rotations=(1,), seed=SEED) on
    the card, two unit-disk vectors encrypted, mul, add, mul_plain,
    add_plain, rotate(ct, 1), rescale (of the raw plaintext product, ==
    mul_plain's result) and level, each decrypted; then each op timed by
    CUDA events beside the lower-level call's time from phase timing."""
    from gpufhe_tpu_torch.api import Session
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ops import probes

    t = time.perf_counter()
    reset()
    t0 = time.perf_counter()
    s = Session.create(PRESET, rotations=(1,), seed=SEED, device=dev)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    slots, top = s.params.slots, s.params.num_limbs
    zr = np.random.default_rng(SEED + 40)
    za, zb = unit_disk(zr, slots), unit_disk(zr, slots)
    t0 = time.perf_counter()
    ca = s.encrypt(za)
    torch.cuda.synchronize()
    encrypt_s = time.perf_counter() - t0
    cb = s.encrypt(zb)
    pt = s.be.encode_slots(zb, s.params.scale, s.level(ca))
    ops = {
        "mul": (lambda: s.mul(ca, cb), za * zb),
        "add": (lambda: s.add(ca, cb), za + zb),
        "mul_plain": (lambda: s.mul_plain(ca, zb), za * zb),
        "add_plain": (lambda: s.add_plain(ca, zb), za + zb),
        "rotate": (lambda: s.rotate(ca, 1), np.roll(za, -1)),
        "rescale": (lambda: s.rescale(s.be.mul_plain(ca, pt)), za * zb),
    }
    outs = {name: op() for name, (op, _) in ops.items()}
    levels = {name: s.level(o) for name, o in outs.items()}
    want_levels = {"mul": top - 1, "add": top, "mul_plain": top - 1, "add_plain": top,
                   "rotate": top, "rescale": top - 1}
    if levels != want_levels:
        raise AssertionError(f"session levels {levels}, not {want_levels}")
    same_limbs(outs["rescale"], outs["mul_plain"], "session rescale of the plaintext product")
    errs, decrypt_s = {}, []
    for name, (_, want) in ops.items():
        t0 = time.perf_counter()
        got = s.decrypt(outs[name])
        decrypt_s.append(time.perf_counter() - t0)
        tol = SESSION_ROT_TOL if name == "rotate" else DECODE_TOL
        errs[name] = decode_err(got, want, slots, f"session {name}", tol)
    launches["session_ckks"] = counts()
    if kernel_missing(launches["session_ckks"]):
        raise AssertionError(f"session_ckks: a kernel did not run ({launches['session_ckks']})")
    say("session_ckks", f"Session.create({PRESET!r}, rotations=(1,), seed={SEED}) {create_s:.2f} "
        f"s, encrypt {encrypt_s:.3f} s, decrypt {np.median(decrypt_s):.3f} s (median); max |dec "
        "- want| " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (< {DECODE_TOL}; rotate < {SESSION_ROT_TOL}, the rotation's own noise at 2^"
        f"{s.params.scale_bits} being 0.068); levels {levels}; launches "
        f"{launches['session_ckks']}  [{smi}]", t)
    t = time.perf_counter()
    op_ms = {name: probes.cuda_ms(op, iters=10) for name, (op, _) in ops.items()}
    # the facade's own cost: each op and the call it makes below the Session,
    # timed here in turns (lower, Session, Session, lower; medians), beside
    # the lower-level time of phase timing
    key1 = {1: s.chest.galois_key(1)}
    lower = {
        "mul": ("ct_mul_full", lambda: dct.ct_mul_full(ca, cb, s.params, s.ctx,
                                                       s.chest.device_rlk)),
        "add": ("ct_add", lambda: dct.ct_add(ca, cb, s.ctx)),
        "rotate": ("ct_rotate_hoisted [1]",
                   lambda: dct.ct_rotate_hoisted(ca, [1], s.params, s.ctx, key1)),
    }
    turns = {}
    for name, (_, low) in lower.items():
        a, b, c, d = (probes.cuda_ms(f, iters=10) for f in (low, ops[name][0], ops[name][0], low))
        turns[name] = (float(np.median([a, d])), float(np.median([b, c])))
    phase_ms = {"mul": ("ct_mul_full", times["mul_full"]), "rotate": ("ct_rotate", times["ct_rotate"])}
    say("session_timing", "ms per op by CUDA events: " + ", ".join(
        f"{k} {v:.4f}" for k, v in op_ms.items()) + "; in turns, Session against the call "
        "below it: " + ", ".join(
            f"{k} {turns[k][1]:.4f} against {low_name} {turns[k][0]:.4f} (facade "
            f"{turns[k][1] - turns[k][0]:+.4f})" for k, (low_name, _) in lower.items())
        + "; phase timing's " + ", ".join(f"{n} {v:.4f}" for n, v in phase_ms.values())
        + f"  [{smi}]", t)
    return {"session": s, "cts": (ca, cb), "prod": outs["mul"], "errs": errs, "op_ms": op_ms,
            "turns": turns, "create_s": create_s}


def session_save(sess: dict) -> dict:
    """Start Session.save and save_ct of session_ckks's session and two
    ciphertexts in a background thread, into a temporary directory: zlib
    over ~220 MB of keys on the host, which overlaps the card's next paths
    (deep_mlp, mlp_n15, models_ci, session_bfv, session_ci). session_io
    joins it."""
    import os
    import tempfile
    import threading

    s, (ca, cb) = sess["session"], sess["cts"]
    tmp = tempfile.TemporaryDirectory()
    job = {"tmp": tmp, "secs": {}, "error": None,
           "paths": {"session": os.path.join(tmp.name, "session.npz"),
                     "ct_a": os.path.join(tmp.name, "ct_a.npz"),
                     "ct_b": os.path.join(tmp.name, "ct_b.npz")}}

    def save():
        # background work: the card's paths come first on the host
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
        try:
            t0 = time.perf_counter()
            s.save(job["paths"]["session"])
            job["secs"]["save"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            s.save_ct(job["paths"]["ct_a"], ca)
            job["secs"]["save_ct"] = time.perf_counter() - t0
            s.save_ct(job["paths"]["ct_b"], cb)
        except BaseException as e:  # re-raised by session_io
            job["error"] = e

    job["thread"] = threading.Thread(target=save, name="session_save")
    job["thread"].start()
    return job


def session_io(dev, smi, counts, reset, launches: dict, sess: dict, job: dict) -> dict:
    """Path session_io: session_save's files (the reference's npz format)
    loaded on the card (Session.load, load_ct): the loaded ciphertexts ==
    the originals limb for limb, their decrypts == the originals', and the
    loaded session's mul of them == the original's (the multiply draws
    nothing, so this holds the re-uploaded keys ==)."""
    import os

    from gpufhe_tpu_torch.api import Session

    t = time.perf_counter()
    job["thread"].join()
    waited = time.perf_counter() - t
    if job["error"] is not None:
        raise job["error"]
    s, (ca, cb), paths, secs = sess["session"], sess["cts"], job["paths"], job["secs"]
    with job["tmp"]:
        sizes = {k: os.path.getsize(v) for k, v in paths.items()}
        reset()
        t0 = time.perf_counter()
        r = Session.load(paths["session"], device=dev)
        torch.cuda.synchronize()
        secs["load"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ca2 = r.load_ct(paths["ct_a"])
        torch.cuda.synchronize()
        secs["load_ct"] = time.perf_counter() - t0
        cb2 = r.load_ct(paths["ct_b"])
    if r.scheme != s.scheme or r.params != s.params:
        raise AssertionError("the loaded session's scheme or parameters differ")
    same_limbs(ca2, ca, "load_ct a")
    same_limbs(cb2, cb, "load_ct b")
    if not (r.decrypt(ca2) == s.decrypt(ca)).all():
        raise AssertionError("the loaded session decrypts the loaded ciphertext differently")
    prod = r.mul(ca2, cb2)
    same_limbs(prod, sess["prod"], "the loaded session's mul")
    launches["session_io"] = counts()
    if kernel_missing(launches["session_io"]):
        raise AssertionError(f"session_io: a kernel did not run ({launches['session_io']})")
    say("session_io", "save / load " + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
        + f" (the saves in a background thread beside deep_mlp, mlp_n15, models_ci, "
        f"session_bfv and session_ci; "
        f"{waited:.2f} s waited for it here); files " + ", ".join(
            f"{k} {v / 2**20:.1f} MiB" for k, v in sizes.items())
        + "; loaded ciphertexts == the originals, their decrypts ==, the loaded session's mul "
        f"== the original's limb for limb; launches {launches['session_io']}  [{smi}]", t)
    return {"secs": secs, "sizes": sizes, "waited": waited}


def session_bfv(dev, smi, counts, reset, launches: dict) -> dict:
    """Path session_bfv: Session.create(INT_PRESET, scheme="bfv",
    rotations=(1,)) on the card (config5_boot's chain, t = 786433): encrypt,
    mul, add and rotate(ct, 1) of two random slot-ring pairs mod t, each
    decrypt exact in all N slots; noise_budget (host, the secret key) falls
    after the multiply."""
    from gpufhe_tpu_torch.api import Session

    t = time.perf_counter()
    reset()
    t0 = time.perf_counter()
    s = Session.create(INT_PRESET, scheme="bfv", rotations=(1,), seed=SEED, device=dev)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    tmod, slots = s.params.plain_modulus, s.params.slots
    vr = np.random.default_rng(SEED + 50)
    va, vb = (vr.integers(0, tmod, size=(2, slots), dtype=np.int64) for _ in range(2))
    ca, cb = s.encrypt(va), s.encrypt(vb)
    outs = {"encrypt": ca, "mul": s.mul(ca, cb), "add": s.add(ca, cb), "rotate": s.rotate(ca, 1)}
    want = {"encrypt": va, "mul": va * vb % tmod, "add": (va + vb) % tmod,
            "rotate": np.roll(va, -1, axis=1)}
    n = {name: exact_slots(s.decrypt(o), want[name], f"session_bfv {name}")
         for name, o in outs.items()}
    t0 = time.perf_counter()
    budgets = [s.noise_budget(ca), s.noise_budget(outs["mul"])]
    budget_s = (time.perf_counter() - t0) / 2
    if not budgets[1] < budgets[0]:
        raise AssertionError(f"session_bfv: noise_budget did not fall after mul: {budgets}")
    if s.level(outs["mul"]) != s.level(ca):
        raise AssertionError("session_bfv: the BFV multiply changed the level")
    launches["session_bfv"] = counts()
    if kernel_missing(launches["session_bfv"]):
        raise AssertionError(f"session_bfv: a kernel did not run ({launches['session_bfv']})")
    say("session_bfv", f"Session.create({INT_PRESET!r}, scheme='bfv', rotations=(1,)) "
        f"{create_s:.2f} s; encrypt, mul, add, rotate 1 each exact in "
        + ", ".join(f"{k} {v}" for k, v in n.items()) + f" slots; noise_budget {budgets[0]:.2f} "
        f"-> {budgets[1]:.2f} bits after mul ({budget_s:.2f} s each on the host); launches "
        f"{launches['session_bfv']}  [{smi}]", t)
    return {"budgets": budgets, "create_s": create_s}


def session_ci_run(device, counts, names=SESSION_CI_SMOKE) -> tuple[dict, dict, dict]:
    """The named Session items at CI size on `device`, keys and draws from
    numpy seeds (the same host draws on every device): ({item: [outputs]},
    {item: decode error, or the slots held exact}, {item: launches})."""
    from gpufhe_tpu_torch.api import Session, ThresholdSession

    def session_ops(name, scheme):
        s = Session.create(name, scheme=scheme, rotations="bsgs", seed=3, device=device)
        rng = np.random.default_rng(4)
        if scheme == "ckks":
            va, vb = rng.uniform(-1, 1, size=(2, s.params.slots))
            a_mat = rng.uniform(-0.5, 0.5, size=(s.params.slots, s.params.slots))
        else:
            tmod = s.params.plain_modulus
            va, vb = rng.integers(0, tmod, size=(2, s.params.slots), dtype=np.int64)
            a_mat = rng.integers(0, tmod, size=(s.params.slots, s.params.slots))
        ca, cb = s.encrypt(va), s.encrypt(vb)
        outs = [ca, cb, s.mul(ca, cb), s.add(ca, cb), s.sub(ca, cb), s.mul_plain(ca, vb),
                s.add_plain(ca, vb), s.rotate(ca, 1), s.rescale(s.mul(ca, cb)),
                s.matmul(ca, a_mat)]

        def check(outs):
            got = s.decrypt(outs[2])
            if scheme == "ckks":
                return decode_err(got, va * vb, s.params.slots, f"session_ci {name} mul")
            return exact_slots(got[0], va * vb % s.params.plain_modulus, f"session_ci {name}")
        return outs, check

    def threshold():
        ts = ThresholdSession.create_threshold("tiny2", n_parties=3, rotations=(1,),
                                               device=device)
        v = np.random.default_rng(5).uniform(-0.5, 0.5, size=ts.params.slots)
        ct = ts.encrypt(v)
        out = ts.rotate(ts.mul(ct, ct), 1)
        partials = [ts.partial_decrypt(out, i, np.random.default_rng(20 + i)) for i in range(3)]
        outs = [ct, out, *(torch.from_numpy(p) for p in partials)]

        def check(outs):
            got = ts.combine(outs[1], [p.numpy() for p in outs[2:]])
            return decode_err(got, np.roll(v * v, -1), ts.params.slots, "session_ci combine")
        return outs, check

    def bootstrap():
        s = Session.create(BOOT_CI_PRESET, bootstrap={
            "transform": "factored", "radix_log": BOOT_RADIX, "evalmod": "cheb",
            "k_bound": BOOT_CI_K_BOUND}, seed=7, device=device)
        zr = np.random.default_rng(0)
        z = (zr.normal(size=s.params.slots) + 1j * zr.normal(size=s.params.slots)) * 0.2
        ct = s.encrypt(z, level=s.params.scale_words)
        outs = [ct, s.bootstrap(ct)]

        def check(outs):
            return decode_err(s.decrypt(outs[1]), z, s.params.slots, "session_ci bootstrap",
                              BOOT_TOL)
        return outs, check

    items = {
        "ckks tiny2": lambda: session_ops("tiny2", "ckks"),
        "bgv bgv_tiny": lambda: session_ops("bgv_tiny", "bgv"),
        "bfv bfv_tiny": lambda: session_ops("bfv_tiny", "bfv"),
        "threshold tiny2": threshold,
        "bootstrap boot_dw_ci_enc": bootstrap,
    }
    outs, errs, per_item = {}, {}, {}
    for name in names:
        before = counts()
        outs[name], check = items[name]()
        per_item[name] = {k: v - before[k] for k, v in counts().items()}
        errs[name] = check(outs[name])
    return outs, errs, per_item


def session_ci(dev, smi, counts, reset, launches: dict) -> tuple:
    """Path session_ci: SESSION_CI_SMOKE on the card. Returns the launches per
    item and the check, session_ci_check: every output == the CPU twin's
    (session_ci_run("cpu"), with the same keys and draws, run in the CI
    twins' process), limb for limb."""
    t = time.perf_counter()
    reset()
    outs, errs, per_item = session_ci_run(dev, counts)
    launches["session_ci"] = counts()
    if kernel_missing(launches["session_ci"]):
        raise AssertionError(f"session_ci: a kernel did not run ({launches['session_ci']})")
    say("session_ci", "on the card: " + "; ".join(
        f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v} slots exact"
        for k, v in errs.items()) + f"; launches per item {per_item}  [{smi}]", t)

    def check(cpu):
        t = time.perf_counter()
        n = same_outputs(outs, cpu["session_ci"], "session_ci")
        say("session_ci_check", f"{n} outputs of {len(outs)} items ({', '.join(outs)}) == the "
            f"CPU path limb for limb; the other items ("
            f"{', '.join(SESSION_CI_ITEMS[len(outs):])}) run card == CPU in "
            f"tests/test_torch_kernels_gpu.py  [{smi}]", t)

    return per_item, check


def cli_phase(dev, smi, counts, reset, launches: dict, bounds: Bounds, params) -> list:
    """Path cli: python -m gpufhe_tpu_torch.cli's subcommands, in process:
    security at config5_boot_dw; keygen at tiny2, its file loaded by
    Session.load on the card; kernels at PRESET on the card, each row beside
    its bound (utils/benchkit.py, the smoke's own Bounds class), the byte-bound
    rows' bounds == this run's Bounds at the same shapes; demo-bfv and
    demo-mlp at their default presets on the card == with --cpu (no times in
    their lines)."""
    import contextlib
    import io
    import os
    import tempfile

    from gpufhe_tpu_torch import cli
    from gpufhe_tpu_torch.api import Session

    def run(*argv) -> list[dict]:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(list(argv))
        return [json.loads(line) for line in out.getvalue().splitlines()]

    t = time.perf_counter()
    reset()
    (sec,) = run("security", "--preset", "config5_boot_dw")
    print(f"cli security: {json.dumps(sec)}", flush=True)
    if sec["security_bits"] < 128:
        raise AssertionError(f"cli security: config5_boot_dw reaches {sec['security_bits']} bits")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "keys.npz")
        (kg,) = run("keygen", "--preset", "tiny2", "--out", path, "--rotations", "1")
        s = Session.load(path, device=dev)
    z = np.random.default_rng(SEED + 60).uniform(-1, 1, size=s.params.slots)
    kg_err = decode_err(s.decrypt(s.rotate(s.encrypt(z), 1)), np.roll(z, -1), s.params.slots,
                        "cli keygen file, Session.load, rotate")
    rows = run("kernels", "--preset", PRESET)
    for row in rows:
        print(f"cli kernels {PRESET}: {json.dumps(row)}  [{smi}]", flush=True)
    L = params.num_limbs
    own = {"ntt_fwd": bounds.ms(*bounds.ntt(L, L)), "ntt_inv": bounds.ms(*bounds.ntt(L, L))}
    for row in rows:
        if row["kernel"] in own and own[row["kernel"]][1] == "bytes" == row["bound_by"]:
            if round(own[row["kernel"]][0], 5) != row["bound_ms"]:
                raise AssertionError(f"cli kernels {row['kernel']}: bound {row['bound_ms']} is "
                                     f"not the smoke's {own[row['kernel']][0]:.5f}")
    scaling = run("scaling", "--preset", "tiny2", "--iters", "2")
    for row in scaling:
        print(f"cli scaling tiny2: {json.dumps(row)}  [{smi}]", flush=True)
    if sorted({r["mesh"] for r in scaling}) != ["limb=1 x coeff=1"] or len(scaling) != 2:
        raise AssertionError(f"cli scaling on one card printed {scaling}: only the 1 x 1 row fits "
                             "one distinct device")
    demos = {}
    for cmd in ("demo-bfv", "demo-mlp"):
        card_line, cpu_line = run(cmd), run("--cpu", cmd)
        if card_line != cpu_line:
            raise AssertionError(f"cli {cmd}: the card's line {card_line} is not the CPU's "
                                 f"{cpu_line}")
        demos[cmd] = card_line[0]
        print(f"cli {cmd}: {json.dumps(card_line[0])} (== --cpu)", flush=True)
    launches["cli"] = counts()
    if not (demos["demo-bfv"]["matvec_exact"] and demos["demo-bfv"]["mult_exact"]):
        raise AssertionError(f"cli demo-bfv is not exact: {demos['demo-bfv']}")
    if demos["demo-mlp"]["max_abs_err"] >= DECODE_TOL:
        raise AssertionError(f"cli demo-mlp off by {demos['demo-mlp']['max_abs_err']}")
    say("cli", f"security {sec['security_bits']} bits (log QP {sec['log_qp']}); keygen "
        f"{kg['preset']} -> Session.load on the card, rotate decoded within {kg_err:.3e}; "
        f"scaling at tiny2: the 1 x 1 row only, {scaling[0]['ms_per_mult']} ms per mult; "
        f"kernels at {PRESET}: " + ", ".join(
            f"{r['kernel']} {r['ms']:.4f} ms ({r['x_bound']}x its {r['bound_ms']:.5f} ms bound)"
            for r in rows) + f"; demo-bfv, demo-mlp card == --cpu; launches {launches['cli']}"
        f"  [{smi}]", t)
    return rows


# ---------------------------------------------------------------------------
# The mesh (gpufhe_tpu_torch/parallel): logical shards on this one card
# ---------------------------------------------------------------------------

# the bench phase: gpufhe_tpu_torch/bench.py bench_mult at PRESET, cut to a
# chain of BENCH_CHAIN steps and BENCH_ITERS timed passes (the bench's own
# defaults are 128 and 3)
BENCH_CHAIN, BENCH_ITERS = 16, 2


def bench_phase(dev, smi, counts, reset, launches: dict, params, ctx) -> dict:
    """Phase bench: `python -m gpufhe_tpu_torch.cli bench`'s primary line,
    bench.bench_mult at PRESET (BENCH_CHAIN, BENCH_ITERS), then its chain's
    final carry == a hand-written loop of ct_mul_full on the card over as
    many steps from the same inputs, each output padded back to the level
    with the old operand's top rows. Returns the bench's line."""
    from gpufhe_tpu_torch import bench
    from gpufhe_tpu_torch.ciphertext import ct as dct

    t = time.perf_counter()
    reset()
    got = {}
    line = bench.bench_mult(PRESET, BENCH_CHAIN, BENCH_ITERS, HBM_BYTES_PER_S, device=dev,
                            out=got)
    launches["bench"] = counts()
    level, w = params.num_limbs, params.scale_words
    a, b = got["a"], got["b"]
    for _ in range(got["steps"]):
        r = dct.ct_mul_full(a, b, params, ctx, got["rlk"])
        a, b = dct.Ciphertext([torch.cat([r.c[i], a.c[i][level - w:]]) for i in range(2)],
                              level, a.scale), a
    limbs = sum(same_limbs(g, h, f"bench carry [{i}]")
                for i, (g, h) in enumerate(zip(got["carry"], (a, b), strict=True)))
    print(f"bench line: {json.dumps(line)}", flush=True)
    say("bench", f"bench.bench_mult({PRESET}, chain {BENCH_CHAIN}, iters {BENCH_ITERS}): "
        f"{line['ms_per_mult']} ms per ct_mul_full by CUDA events over the chain, floor "
        f"subtracted; its carry after {got['steps']} steps == a hand-written ct_mul_full loop "
        f"on the card ({limbs} limbs); launches {launches['bench']}  [{smi}]", t)
    return line


MESH_SHAPE = (2, 4)  # (limb, coeff): eight shards on DEVICE
# the reference's representative N=2^16 program set (scripts/exec_n16_mesh.py
# run_parity): the first CoeffToSlot stage at radix 3, k_bound 10, and the
# multiply at level 26, the busiest multiply level of its inventory
MESH_N16_MID = 26
MESH_CI_ITEMS = ("bootstrap boot_dw_ci", "bgv_ci rotation", "bgv_ci hoisted fan",
                 "bfv_ci rotation", "bfv_ci hoisted fan")


def mesh_of(dev):
    from gpufhe_tpu_torch.parallel.sharded import make_fhe_mesh

    return make_fhe_mesh(*MESH_SHAPE, devices=[dev] * (MESH_SHAPE[0] * MESH_SHAPE[1]))


def mesh_counts(counts):
    """counts() with the K1 pass entry point (ntt_pass) beside it."""
    from gpufhe_tpu_torch.ops import ntt_cuda

    return lambda: {**counts(), "ntt_pass": ntt_cuda.PASS_KERNEL.launches}


def gathered(grid) -> torch.Tensor:
    """A component grid's eval3d blocks of limb row 0 joined on their own
    device, in natural order (sharded.unshard_ct_component without the
    host copy)."""
    from gpufhe_tpu_torch.parallel.sharded import eval3d_to_natural

    return eval3d_to_natural(torch.cat(grid[0], dim=-2))


def mesh_kernels(dev, smi, params, ctx) -> dict:
    """Phase mesh_kernels: K1's ntt_pass in each of its four kinds == its
    plain version (fourstep_pass_plain) on the card at ctx's Q+P chain, for
    the C = 4 blocks of each kind at their offsets; each kind timed per
    block by CUDA events beside its plain version and its byte bound (the
    block in and out once: 12 bytes per residue, 1/C of the limb's); the
    distributed forward and inverse NTT on the (2, 4) mesh of eight shards
    on the card == the single-device K1 transform, permuted to eval3d."""
    from gpufhe_tpu_torch.ops import ntt_cuda as nc
    from gpufhe_tpu_torch.ops.probes import cuda_ms
    from gpufhe_tpu_torch.parallel import sharded as sh

    t = time.perf_counter()
    rows = ctx.num_total
    n1, n2, n = ctx.n1, ctx.n2, ctx.n
    c_dim = MESH_SHAPE[1]
    w, h = n2 // c_dim, n1 // c_dim
    rng = np.random.default_rng(SEED + 70)
    q = torch.tensor(ctx.primes, dtype=torch.int64, device=dev)[:, None, None]

    def rand(shape, dtype):
        x = torch.from_numpy(rng.integers(0, 1 << 62, size=(rows, *shape))).to(dev)
        return torch.remainder(x, q).to(dtype)

    idx = ctx.index(range(rows), torch.int32)
    kinds = {nc.FWD_A: ("fwd A", (n1, w), torch.int64), nc.FWD_B: ("fwd B", (h, n2), torch.int32),
             nc.INV_B: ("inv B", (h, n2), torch.int64), nc.INV_A: ("inv A", (n1, w), torch.int32)}
    timing, checked = {}, 0
    for kind, (name, shape, dtype) in kinds.items():
        for c in range(c_dim):
            x = rand(shape, dtype)
            col0 = c * w if kind in (nc.FWD_A, nc.INV_A) else 0
            exact(nc.fourstep_pass_cuda(x, idx, ctx, kind, col0),
                  nc.fourstep_pass_plain(x, idx, ctx, kind, col0), f"ntt_pass {name} block {c}")
            checked += 1
        nc.PASS_KERNEL.reset()  # count the timing's launches, not the check's
        ms = cuda_ms(lambda: nc.fourstep_pass_cuda(x, idx, ctx, kind, col0), iters=20)
        plain = cuda_ms(lambda: nc.fourstep_pass_plain(x, idx, ctx, kind, col0), iters=3,
                        warmup=1)
        nbytes = 12 * rows * n // c_dim
        timing[name] = {"ms": ms, "plain_ms": plain, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                        "launches": nc.PASS_KERNEL.launches}
        timing[name]["device_ms"], _ = kernel_ms(
            lambda: nc.fourstep_pass_cuda(x, idx, ctx, kind, col0), K1_NAME)
        print(f"mesh_kernels ntt_pass {name} {rows} limbs x 1/{c_dim} of 2^{n.bit_length() - 1}: "
              f"{ms:.4f} ms per block by events, {timing[name]['device_ms']:.4f} device (plain "
              f"{plain:.3f}); bound {timing[name]['bound_ms']:.5f} "
              f"ms (bytes, {nbytes / 1e6:.2f} MB), {ms / timing[name]['bound_ms']:.2f}x  "
              f"[{smi}]", flush=True)
    mesh = mesh_of(dev)
    t_all = sh.gather_ntt_tables(sh.full_ntt_tables(params, mesh=mesh), range(rows))
    x = torch.remainder(torch.from_numpy(rng.integers(0, 1 << 62, size=(rows, n))).to(dev),
                        q[:, :, 0])
    x3 = sh.coeff_to_3d(x, n1, n2)
    e = sh.ntt_fwd_body(mesh.put(lambda l, c, d: x3[:, c * h:(c + 1) * h].contiguous()),
                        t_all)
    exact(gathered(e), nc.fourstep_cuda(x, idx, ctx, False), "distributed forward NTT")
    back = sh.ntt_inv_body(e, t_all)
    for i, row in enumerate(back):
        exact(torch.cat(row, dim=1).reshape(rows, n), x, f"distributed inverse NTT, limb row {i}")
    say("mesh_kernels", f"ntt_pass == fourstep_pass_plain in its four kinds ({checked} blocks of "
        f"{rows} limbs, C = {c_dim}); ms per block by events / device " + ", ".join(
            f"{k} {v['ms']:.4f} / {v['device_ms']:.4f} ({v['device_ms'] / v['bound_ms']:.2f}x "
            f"its bound)"
            for k, v in timing.items())
        + f"; the distributed fwd and inv NTT on {MESH_SHAPE[0]} x {MESH_SHAPE[1]} shards on "
        f"{dev} == K1 (eval3d)", t)
    return {"err": 0, "timing": timing}


def mesh_mul(dev, smi, counts, reset, launches: dict, params, ctx, chest, cts, prod,
             bgv: dict, bfv: dict) -> dict:
    """Phase mesh_mul: on the (2, 4) mesh of eight shards on the card,
    make_sharded_mult at PRESET (level L) == ct_mul_full limb for limb; at
    INT_PRESET the sharded BGV multiply == bgv.ct_mul and
    make_sharded_bfv_mult == bfv.ct_mul, each decrypt exact in every slot.
    Each timed by CUDA events beside the single-device call, with the
    launches of K1's passes, K3 and K4 per call."""
    from gpufhe_tpu_torch.ciphertext import bfv as dbfv
    from gpufhe_tpu_torch.ciphertext import bgv as dbgv
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ops.probes import cuda_ms
    from gpufhe_tpu_torch.parallel import sharded as sh
    from gpufhe_tpu_torch.parallel.bfv_sharded import make_sharded_bfv_mult

    t = time.perf_counter()
    reset()
    mcounts = mesh_counts(counts)
    mesh = mesh_of(dev)
    cases = {
        f"ckks {PRESET}": (params, sh.make_sharded_mult, chest.device_rlk, cts[0].c + cts[1].c,
                           prod, lambda: dct.ct_mul_full(cts[0], cts[1], params, ctx,
                                                         chest.device_rlk)),
        f"bgv {INT_PRESET}": (bgv["params"], sh.make_sharded_mult, bgv["chest"].device_rlk,
                              bgv["a"].c + bgv["b"].c, bgv["mul"][0],
                              lambda: dbgv.ct_mul(bgv["a"], bgv["b"], bgv["params"], bgv["ctx"],
                                                  bgv["chest"].device_rlk)),
        f"bfv {INT_PRESET}": (bgv["params"], make_sharded_bfv_mult, bfv["chest"].device_rlk,
                              bfv["a"].c + bfv["b"].c, bfv["mul"][0],
                              lambda: dbfv.ct_mul(bfv["a"], bfv["b"], bgv["params"], bfv["ctx"],
                                                  bfv["chest"].device_rlk)),
    }
    rows = {}
    for what, (pr, make, rlk, comps, want, single) in cases.items():
        run, prepare = make(pr, comps[0].shape[0], mesh)
        bundle = prepare(rlk)
        blocks = [sh.shard_ct_component(c, pr, mesh) for c in comps]
        before = mcounts()
        out = run(*blocks, bundle)
        per = {k: v - before[k] for k, v in mcounts().items()}
        got = [gathered(g) for g in out]
        for i, (g, w) in enumerate(zip(got, want.c)):
            exact(g, w, f"mesh_mul {what} component {i}")
        if min(per[k] for k in ("ntt_pass", "convert", "mac")) <= 0 or per["ntt"] != 0:
            raise AssertionError(f"mesh_mul {what}: K1's passes, K3 and K4 must all run, and no "
                                 f"whole-limb NTT: {per}")
        ms, single_ms = cuda_ms(lambda: run(*blocks, bundle), iters=5, warmup=1), \
            cuda_ms(single, iters=5, warmup=1)
        rows[what] = {"ms": ms, "single_ms": single_ms, "per_call": per,
                      "out": dataclasses.replace(want, c=got)}
        print(f"mesh_mul {what}: sharded {ms:.3f} ms per call by CUDA events, single device "
              f"{single_ms:.3f} ms ({ms / single_ms:.2f}x); launches per call {per}  [{smi}]",
              flush=True)
    # the integer products' decrypts, exact in every slot
    slots = 0
    for scheme, d in (("bgv", bgv), ("bfv", bfv)):
        got, want = rows[f"{scheme} {INT_PRESET}"].pop("out"), d["mul"][1]
        if scheme == "bgv":
            dec = dbgv.decrypt_decode(got, bgv["params"], d["chest"].device_sk, d["ctx"])
        else:
            dec = dbfv.decrypt_decode(got, bgv["params"], d["chest"].device_sk, d["ctx"])
        slots += exact_slots(dec, want, f"mesh_mul {scheme} decrypt")
    rows[f"ckks {PRESET}"].pop("out")
    launches["mesh_mul"] = counts()
    say("mesh_mul", f"on {MESH_SHAPE[0]} x {MESH_SHAPE[1]} shards on {dev}: " + "; ".join(
        f"{k} == the single-device call, {v['ms']:.3f} ms against {v['single_ms']:.3f} ms"
        for k, v in rows.items()) + f"; {slots} slots decrypted exactly", t)
    return rows


def first_cts_stage_diags(params, radix_log: int, k_bound: float):
    """The flagship bootstrap's first CoeffToSlot diagonals at the full
    level: FactoredCtS's groups[0] with its geometric factor spread (the
    reference's scripts/exec_n16_mesh.py first_cts_stage_diags)."""
    from gpufhe_tpu_torch.ciphertext import fftboot as fb

    n_s = params.slots
    fwd = [fb._inv_stage_diags(n_s, h, w) for h, w in reversed(fb._stage_twiddles(n_s))]
    groups = fb.group_stages(fwd, n_s, radix_log)
    q0 = math.prod(params.q_primes[: params.scale_words])
    mag = abs(params.scale / (q0 * k_bound)) ** (1.0 / len(groups))
    return fb.scale_diags(groups[0], mag)


def mesh_n16(dev, smi, counts, reset, launches: dict, params, ctx) -> dict:
    """Phase mesh_n16: the reference's scripts/exec_n16_mesh.py run_parity at
    DW_PRESET, nothing cut, on the (2, 4) mesh of eight shards on the card:
    device_keygen(params, default_rng(7), rotations=<the first CtS stage's
    offsets>), one ShardedBackend beside one DeviceBackend, and the
    programs eph_ks_to (level 2), mod_raise2, eph_ks_from (48), the first
    CtS fan (48) and mult_rescale (MESH_N16_MID), each fed the
    single-device output of the step before: each == the single-device
    port limb for limb; seconds of the first call, CUDA-event ms of a
    steady call beside the single device's, peak device memory."""
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext import fftboot as fb
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.keys.device_keygen import device_keygen
    from gpufhe_tpu_torch.ops.probes import cuda_ms
    from gpufhe_tpu_torch.parallel.backend import ShardedBackend

    t = time.perf_counter()
    reset()
    mcounts = mesh_counts(counts)
    diags0 = first_cts_stage_diags(params, BOOT_RADIX, BOOT_K_BOUND)
    offsets = tuple(sorted(r for r in diags0 if r != 0))
    chest = device_keygen(params, np.random.default_rng(7), rotations=offsets, ctx=ctx)
    dev_be, shb = DeviceBackend(params, ctx, chest), ShardedBackend(params, mesh_of(dev), chest)
    rng = np.random.default_rng(0)
    z = (rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots)) * 0.2
    ct_w = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                       np.random.default_rng(1), params.scale, level=params.scale_words)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    peaks = {}
    peak = peak_marker(dev, peaks)
    rows = {}

    def step(name, level, dev_fn, sh_fn, x, multi=False):
        want = dev_fn(x)
        sx = shb.from_single(x)
        peak(f"{name} before")
        t1 = time.perf_counter()
        before = mcounts()
        got = sh_fn(sx)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t1
        per = {k: v - before[k] for k, v in mcounts().items()}
        peak(name)
        gots, wants = (got, want) if multi else ([got], [want])
        for g, w in zip(gots, wants, strict=True):
            if (g.level, g.scale) != (w.level, w.scale):
                raise AssertionError(f"mesh_n16 {name}: level or scale differ")
            for i, (gc, wc) in enumerate(zip(g.c, w.c, strict=True)):
                exact(gathered(gc), wc, f"mesh_n16 {name} component {i}")
        ms = cuda_ms(lambda: sh_fn(sx), iters=1, warmup=0)
        single_ms = cuda_ms(lambda: dev_fn(x), iters=1, warmup=1)
        rows[name] = {"level": level,
                      "first_s": first_s, "ms": ms, "single_ms": single_ms, "launches": per,
                      "peak": peaks[name]}
        print(f"mesh_n16 {name}: == the single device; first call {first_s:.3f} s, steady "
              f"{ms:.2f} ms by CUDA events against the single device's {single_ms:.2f} ms "
              f"({ms / single_ms:.2f}x); launches {per}; peak "
              f"{gib(rows[name]['peak'])}  [{smi}]", flush=True)
        return want

    if chest.eph is None:
        raise AssertionError(f"{DW_PRESET} keygen drew no encapsulation keys")
    # each program at the reference's level label (run_parity's)
    full = params.num_limbs
    ct_t = step("eph_ks_to", params.scale_words, lambda c: dev_be.key_switch(c, "to_eph"),
                lambda c: shb.key_switch(c, "to_eph"), ct_w)
    raised = step("mod_raise2", full, dev_be.mod_raise, shb.mod_raise, ct_t)
    ct_f = step("eph_ks_from", full, lambda c: dev_be.key_switch(c, "from_eph"),
                lambda c: shb.key_switch(c, "from_eph"), raised)
    plan_dev, plan_sh = fb.DiagPlan(dev_be, diags0, full), fb.DiagPlan(shb, diags0, full)
    step(f"fan_{len(offsets)}off", full, plan_dev.apply_multi, plan_sh.apply_multi, ct_f,
         multi=True)
    ct_mid = dev_be.drop_to_level(ct_f, MESH_N16_MID)
    step("mult_rescale", MESH_N16_MID, lambda c: dev_be.mul(c, c), lambda c: shb.mul(c, c),
         ct_mid)
    launches["mesh_n16"] = counts()
    del chest, dev_be, shb, plan_dev, plan_sh
    gc.collect()
    say("mesh_n16", f"at {DW_PRESET} (N={params.n}, L={full}) on {MESH_SHAPE[0]} x "
        f"{MESH_SHAPE[1]} shards on {dev}: keygen (rlk, eph, Galois {offsets}) and setup "
        f"{setup_s:.2f} s; " + "; ".join(
            f"{k} == single device, first {v['first_s']:.2f} s, steady {v['ms']:.1f} ms "
            f"against {v['single_ms']:.1f} ms" for k, v in rows.items()), t)
    return rows


def mesh_ci_run(device, names=MESH_CI_ITEMS) -> dict:
    """The mesh at CI size on `device` (eight shards on it), keys and data
    from numpy seeds: {item: [output tensors on the host]}: the dw
    bootstrap at boot_dw_ci over ShardedBackend (with the single-device
    bootstrap's output beside it, "... single"), and the BGV and BFV
    rotation and hoisted fan at bgv_ci / bfv_ci."""
    from gpufhe_tpu_torch.ciphertext import bfv as dbfv
    from gpufhe_tpu_torch.ciphertext import bgv as dbgv
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
    from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.golden import bfv as gbfv
    from gpufhe_tpu_torch.golden import bgv as gbgv
    from gpufhe_tpu_torch.golden import ckks as gckks
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.parallel import sharded as sh
    from gpufhe_tpu_torch.parallel.backend import ShardedBackend
    from gpufhe_tpu_torch.parallel.bfv_sharded import (make_sharded_bfv_hoisted_fan,
                                                       make_sharded_bfv_rotation)
    from gpufhe_tpu_torch.params.params import preset

    mesh = mesh_of(torch.device(device))
    out = {}

    def host(grids):
        return [sh.unshard_ct_component(g) for g in grids]

    if "bootstrap boot_dw_ci" in names:
        params = preset("boot_dw_ci")
        ctx = make_context(params, device=device)
        rots = tuple(bootstrap_rotations(params, "factored", 6))
        chest = dkeys.keygen(params, np.random.default_rng(7), rotations=rots, conjugation=True,
                             ctx=ctx)
        kw = dict(transform="factored", radix_log=6, evalmod="cheb", k_bound=5.0)
        shb = ShardedBackend(params, mesh, chest)
        zr = np.random.default_rng(0)
        z = (zr.normal(size=params.slots) + 1j * zr.normal(size=params.slots)) * 0.2
        ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx,
                         np.random.default_rng(1), params.scale, level=2)
        got = Bootstrapper(shb, **kw)(shb.from_single(ct))
        single = Bootstrapper(DeviceBackend(params, ctx, chest), **kw)(ct)
        err = float(np.abs(shb.decrypt_decode(got) - z).max())
        if err >= BOOT_TOL:
            raise AssertionError(f"mesh_ci bootstrap decodes off by {err}")
        out["bootstrap boot_dw_ci"] = host(got.c) + [torch.tensor([got.level, got.scale])]
        out["bootstrap boot_dw_ci single"] = [c.cpu() for c in single.c] + [
            torch.tensor([single.level, single.scale])]
    for scheme, mod, gold in (("bgv", dbgv, gbgv), ("bfv", dbfv, gbfv)):
        todo = [n for n in names if n.startswith(f"{scheme}_ci")]
        if not todo:
            continue
        params = preset(f"{scheme}_ci")
        ctx = make_context(params, device=device)
        chest = mod.keygen(params, np.random.default_rng(7), rotations=(3, 5), ctx=ctx)
        z = np.random.default_rng(8).integers(0, params.plain_modulus, size=params.n)
        ct = mod.encrypt(gold.encode(z, params), params, chest.device_pk, ctx,
                         np.random.default_rng(33))
        c0, c1 = (sh.shard_ct_component(c, params, mesh) for c in ct.c)
        gks = [chest.galois[s][1] for s in (3, 5)]
        if f"{scheme}_ci rotation" in todo:
            make = sh.make_sharded_rotation if scheme == "bgv" else make_sharded_bfv_rotation
            run, prepare = make(params, ct.level, mesh, 3)
            out[f"{scheme}_ci rotation"] = host(run(c0, c1, prepare(gks[0])))
        if f"{scheme}_ci hoisted fan" in todo:
            make = (sh.make_sharded_hoisted_fan if scheme == "bgv"
                    else make_sharded_bfv_hoisted_fan)
            run, prepare = make(params, ct.level, mesh, 2)
            lins = sh._lin_blocks(np.stack([sh._perm_lin_e3(gckks.galois_exponent(s, params.n),
                                                            ctx.n1, ctx.n2) for s in (3, 5)]),
                                  mesh)
            out[f"{scheme}_ci hoisted fan"] = [x for pair in run(c0, c1, lins, prepare(gks))
                                               for x in host(pair)]
    return out


def mesh_ci(dev, smi, counts, reset, launches: dict, cpu: dict) -> None:
    """Phase mesh_ci: mesh_ci_run on the card and on the CPU, every output
    == limb for limb, and the sharded bootstrap == the single-device one."""
    t = time.perf_counter()
    reset()
    mcounts = mesh_counts(counts)
    got = mesh_ci_run(dev)
    per = mcounts()
    launches["mesh_ci"] = counts()
    card_s = time.perf_counter() - t
    want = cpu  # mesh_ci_run("cpu"), run in the CPU twins' process
    for name, outs in got.items():
        for i, (g, w) in enumerate(zip(outs, want[name], strict=True)):
            if not torch.equal(g, w):
                raise AssertionError(f"mesh_ci {name} [{i}]: the card differs from the CPU")
    for g, w in zip(got["bootstrap boot_dw_ci"], got["bootstrap boot_dw_ci single"], strict=True):
        if not torch.equal(g, w):
            raise AssertionError("mesh_ci: the sharded bootstrap differs from the single device")
    if min(per[k] for k in ("ntt_pass", "convert", "mac")) <= 0:
        raise AssertionError(f"mesh_ci: a kernel did not run ({per})")
    say("mesh_ci", f"{', '.join(MESH_CI_ITEMS)} on {MESH_SHAPE[0]} x {MESH_SHAPE[1]} shards: card "
        f"({card_s:.2f} s) == CPU; the sharded bootstrap == the single device's; launches "
        f"{per}", t)


RESCALE_NAME = r"rescale_kernel<[^>]*>"


def rescale_kernel_run(dev, smi) -> dict:
    """The rescale kernel (csrc/rescale.cu) == its plain version
    (rescale_cuda.drop_limbs_plain, one call a dropped limb) at the paths'
    shapes, in each of its three instances: config5_boot_dw's double-word
    rescale of both components at the multiply's levels 48 .. 34 (dw), its
    one-limb rescale at the refresh's EvalMod levels 38 .. 25 (backend.rescale,
    one drop a word) and PRESET's at its multiply levels 30 .. 26 (ckks), and
    the BGV ModSwitch at INT_PRESET's levels 30 .. 26 (bgv); each with the
    largest residues (q - 1) in one column and the centred lift's tie (q_l //
    2, q_l // 2 + 1; for BGV through [-t^-1]) in two, on a leading-K view of
    a larger stack and at K = words + 1. Then each instance's top shape timed
    alone: CUDA events, the profiler's kernel time, the plain version, and the
    bound by bytes (each input residue read once and each output written
    once, at 4 B a residue as every bound of the kernels line counts them;
    the bytes the int64 interface moves, 8 B a residue, beside it)."""
    from gpufhe_tpu_torch.ops import probes, rescale_cuda
    from gpufhe_tpu_torch.params.params import preset

    rng = np.random.default_rng(SEED)
    # the instance: (preset, limbs dropped a launch, [levels checked], the level timed)
    chains = {"dw": (DW_PRESET, 2, [*range(48, 33, -2)], 48),
              "ckks": (DW_PRESET, 1, [*range(38, 24, -1)], 38),
              "bgv": (INT_PRESET, 1, [*range(30, 25, -1)], 30)}

    def data(params, level, limbs):
        q = np.asarray(params.q_primes[:limbs], dtype=np.int64)[:, None]
        x = rng.integers(0, q, size=(2, limbs, params.n), dtype=np.int64)
        x[..., 0] = q[:, 0] - 1
        t, q_l = params.plain_modulus, params.q_primes[level - 1]
        for col, want in ((1, q_l // 2), (2, q_l // 2 + 1)):
            x[:, level - 1, col] = want * (-t) % q_l if t else want
        return torch.from_numpy(x).to(dev)

    def tables(params, level, words):
        return rescale_cuda.drop_tables(params.q_primes[:level], words, params.plain_modulus,
                                        dev)

    def kernel(x, params, level, words):
        return rescale_cuda.drop_limbs(x, level, tables(params, level, words),
                                       bool(params.plain_modulus))

    def plain(x, params, level, words):
        for d, tab in enumerate(tables(params, level, words)):
            x = rescale_cuda.drop_limbs_plain(x, level - d, [tab], bool(params.plain_modulus))
        return x

    checked = []
    cases = [(tag, name, words, levels) for tag, (name, words, levels, _) in chains.items()]
    cases.append(("ckks", PRESET, 1, [*range(30, 25, -1)]))
    for tag, name, words, levels in cases:
        params = preset(name)
        top = params.num_limbs
        # each level with its own limbs; a leading-K view; the edge
        for level, limbs in [(lv, lv) for lv in levels] + [(top - words, top),
                                                          (words + 1, words + 1)]:
            x = data(params, level, limbs)
            exact(kernel(x, params, level, words), plain(x, params, level, words),
                  f"rescale kernel {tag} at {name} level {level} of {limbs} limbs")
            checked.append(f"{tag} {name} {level}/{limbs}")
    timing = {}
    for tag, (name, words, _, level) in chains.items():
        params = preset(name)
        x = data(params, level, level)
        residues = x.shape[0] * (2 * level - words) * params.n
        row = {"shape": [x.shape[0], level, params.n], "words": words,
               "ms": probes.cuda_ms(lambda: kernel(x, params, level, words), iters=50),
               "plain_ms": probes.cuda_ms(lambda: plain(x, params, level, words), iters=10),
               "bound_ms": 4 * residues / HBM_BYTES_PER_S * 1e3,
               "int64_bytes_ms": 8 * residues / HBM_BYTES_PER_S * 1e3}
        row["device_ms"], _ = kernel_ms(lambda: kernel(x, params, level, words), RESCALE_NAME)
        timing[tag] = row
        print(f"rescale kernel {tag} [2, {level}, 2^{params.n.bit_length() - 1}] drop {words}: "
              f"events {row['ms']:.4f} ms, device {row['device_ms']:.4f}, bound "
              f"{row['bound_ms']:.4f} ({4 * residues / 1e6:.1f} MB at 4 B a residue; the "
              f"int64 interface's {8 * residues / 1e6:.1f} MB {row['int64_bytes_ms']:.4f}), "
              f"plain {row['plain_ms']:.4f} ms  [{smi}]", flush=True)
    return {"checked": checked, "timing": timing}


TENSOR_NAME = r"tensor_kernel"


def tensor_kernel_run(dev, smi) -> dict:
    """The tensor kernel (csrc/tensor.cu) == its plain version
    (tensor_cuda.tensor_plain) at the cells' shapes: DW_PRESET's 48 Q limbs
    (mul8, the refresh's multiplies), INT_PRESET's 30 Q limbs (bgv_mul5,
    bfv_mul8) and its 34-limb auxiliary basis (bfv_mul8), N = 2^16; the
    first 81 columns run through every combination of 0, 1 and q - 1 over
    the four operands. Then each shape timed alone: CUDA events, the
    profiler's kernel time, the plain version, and the bound by bytes (four
    residues read and three written a coefficient-limb: 28 B at 4 B a
    residue, as every bound of the kernels line counts them; the 56 B the
    int64 interface moves beside it)."""
    from gpufhe_tpu_torch.golden.bfv import bfv_aux_params
    from gpufhe_tpu_torch.ops import probes, tensor_cuda
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.params.params import preset

    rng = np.random.default_rng(SEED + 25)
    int_params = preset(INT_PRESET)
    chains = {"dw_q": preset(DW_PRESET), "int_q": int_params,
              "bfv_aux": bfv_aux_params(int_params)}
    timing = {}
    for tag, params in chains.items():
        ctx = make_context(params, device=dev)
        k_dim, n = params.num_limbs, params.n
        q = np.asarray(params.q_primes, dtype=np.int64)[:, None]
        x = rng.integers(0, q, size=(4, k_dim, n), dtype=np.int64)
        edge = np.stack([np.zeros_like(q), np.ones_like(q), q - 1])[..., 0]
        for col in range(81):
            for op in range(4):
                x[op, :, col] = edge[col // 3**op % 3]
        a0, a1, b0, b1 = torch.from_numpy(x).to(dev)
        qcol = ctx.col("q", range(k_dim))

        def kernel():
            return tensor_cuda.tensor((a0, a1), (b0, b1), ctx, k_dim)

        def plain():
            return tensor_cuda.tensor_plain(a0, a1, b0, b1, qcol)

        exact(kernel(), plain(), f"tensor kernel {tag} [{k_dim}, 2^{n.bit_length() - 1}]")
        cells = k_dim * n
        row = {"shape": [k_dim, n], "ms": probes.cuda_ms(kernel, iters=50),
               "plain_ms": probes.cuda_ms(plain, iters=10),
               "bound_ms": 28 * cells / HBM_BYTES_PER_S * 1e3,
               "int64_bytes_ms": 56 * cells / HBM_BYTES_PER_S * 1e3}
        row["device_ms"], _ = kernel_ms(kernel, TENSOR_NAME)
        timing[tag] = row
        print(f"tensor kernel {tag} [{k_dim}, 2^{n.bit_length() - 1}]: events {row['ms']:.4f} "
              f"ms, device {row['device_ms']:.4f}, bound {row['bound_ms']:.4f} "
              f"({28 * cells / 1e6:.1f} MB at 4 B a residue; the int64 interface's "
              f"{56 * cells / 1e6:.1f} MB {row['int64_bytes_ms']:.4f}, "
              f"{row['int64_bytes_ms'] / row['device_ms']:.1%} of it), plain "
              f"{row['plain_ms']:.4f} ms  [{smi}]", flush=True)
    return {"timing": timing}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    from gpufhe_tpu_torch.ciphertext import ct as dct
    from gpufhe_tpu_torch.encoding import encoder
    from gpufhe_tpu_torch.golden import ckks as gckks
    from gpufhe_tpu_torch.keys import keys as dkeys
    from gpufhe_tpu_torch.ops import (convert_cuda, cuda_build, mac_cuda, ntt_cuda, probes,
                                      rescale_cuda, tensor_cuda)
    from gpufhe_tpu_torch.ops.context import make_context
    from gpufhe_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
    from gpufhe_tpu_torch.params.params import preset
    from gpufhe_tpu_torch.primitives import keyswitch, rns

    cuda_ms = probes.cuda_ms
    dev = torch.device(DEVICE)
    # the CPU twins of the N=2^16 paths, of the CI-size items and of the
    # golden model (golden_n16), in three processes of their own from the
    # start (CpuTwins); the checks against them are deferred to
    # join_cpu_twins, near the end of the run
    twins, ci_twins, gold_twins = CpuTwins("n16"), CpuTwins("ci"), CpuTwins("golden")
    # "mod_down": the fused ModDown's launches (K3 with its epilogue, also
    # counted under "convert"), printed beside K3's in every launches line
    kernels = {"ntt": ntt_cuda.KERNEL, "convert": convert_cuda.KERNEL, "mac": mac_cuda.KERNEL,
               "rescale": rescale_cuda.KERNEL, "tensor": tensor_cuda.KERNEL,
               "mod_down": convert_cuda.MOD_DOWN}

    def reset() -> None:
        for k in (*kernels.values(), ntt_cuda.PASS_KERNEL):
            k.reset()

    def counts() -> dict:
        return {name: k.launches for name, k in kernels.items()}

    # 0. the card
    t = time.perf_counter()
    smi, kind = card()
    print(smi, flush=True)
    int_peak, int_peak_text = int_peak_ops_per_s()
    say("card", f"{kind}; name, power.limit = {smi}; peak 32-bit integer multiply-add rate "
        f"{int_peak / 1e12:.2f} T ops/s ({int_peak_text})", t)

    # 1. build every library (one nvcc per library, all at once)
    t = time.perf_counter()
    logs = cuda_build.build_all()
    for name, log in logs.items():
        print(f"nvcc {name} -Xptxas -v:\n{log.strip()}", flush=True)
    say("build", f"built {sorted(logs)} into {cuda_build.BUILD_DIR.name}/", t)

    # 2. P2: the integer rates that every bound's operation side divides by
    t = time.perf_counter()
    rates, rate_rows = {}, {}
    for mix in probes.MIXES:
        small = (mix, 4, 16, dev)
        err = exact(probes.int_rate_cuda(*small), probes.int_rate_plain(*small), f"int_rate {mix}")
        probes.INT_RATE.reset()  # count the measurement's launches, not the check's
        r = probes.int_rate(mix, dev)
        n_launch = probes.INT_RATE.launches
        work = (mix, r["blocks"], r["depth"], dev)
        plain = cuda_ms(lambda: probes.int_rate_plain(*work), iters=1, warmup=0)
        rates[mix] = r["rate"]
        rate_rows[mix] = (r, err, plain, n_launch)
        print(f"int_rate {mix}: {r['rate'] / 1e12:.4f} T steps/s ({r['blocks']} blocks x "
              f"{probes.THREADS} threads x {probes.CHAINS} chains x ({r['depth']} - "
              f"{r['floor_depth']}) steps in {r['ms'] - r['floor_ms']:.4f} ms; full "
              f"{r['ms']:.4f}, floor {r['floor_ms']:.4f}; {n_launch} launches; plain "
              f"{plain:.2f} ms)  [{smi}]", flush=True)
    # a modular product of 30-bit residues at the card's best measured rate
    mod_rate = max(rates["modmul"], rates["shoup32"])
    say("int_rate", "== plain at depth 16; " + ", ".join(
        f"{mix} {rates[mix] / 1e12:.4f} T/s" for mix in probes.MIXES), t)

    params = preset(PRESET)
    ctx = make_context(params, device=dev)
    n, L = params.n, params.num_limbs
    qp = L + len(params.p_primes)
    dw = preset(DW_PRESET)
    ctx_dw = make_context(dw, device=dev)
    L_dw = dw.num_limbs
    qp_dw = L_dw + len(dw.p_primes)
    rng = np.random.default_rng(SEED)
    bounds = Bounds(n, ctx.n1, ctx.n2, mod_rate, rates["muladd"])

    def rand_limbs(c, rows, lead=()):
        q = np.asarray([c.primes[r] for r in rows], dtype=np.int64)[:, None]
        x = rng.integers(0, q, size=(*lead, len(rows), c.n), dtype=np.int64)
        return torch.from_numpy(x).to(c.device)

    # 3. K1 against its plain version, exact, at N = 2^16, at every shape that
    #    the paths launch it with: at config5_boot the Q+P chain (single, and
    #    the dnum=2 raised digits), the level, the P limbs, both components at
    #    the level and after the rescale; at config5_boot_dw the same with the
    #    dnum=5 raised digits and both components after two rescales
    t = time.perf_counter()
    ntt_err = 0
    ntt_cases = (
        [(ctx, sel, batch) for sel, batch in (
            (range(qp), 1), (range(L), 1), (range(L, qp), 1),
            (range(qp), 2), (range(L), 2), (range(L - 1), 2))]
        + [(ctx_dw, sel, batch) for sel, batch in (
            (range(qp_dw), 1), (range(L_dw), 1), (range(qp_dw), 2), (range(qp_dw), dw.dnum),
            (range(L_dw), 2), (range(L_dw - 1), 2), (range(L_dw - 2), 2))]
    )
    for c, sel, batch in ntt_cases:
        idx = c.index(sel, torch.int32)
        x = rand_limbs(c, list(sel) * batch)
        what = f"NTT N={c.n} limbs {sel} x {batch} of {len(c.primes)}"
        for inverse in (False, True):
            got = ntt_cuda.fourstep_cuda(x, idx, c, inverse)
            want = ntt_cuda.fourstep_plain(x, idx, c, inverse)
            ntt_err = max(ntt_err, exact(got, want, f"{what} inverse={inverse}"))
        back = ntt_cuda.fourstep_cuda(ntt_cuda.fourstep_cuda(x, idx, c, False), idx, c, True)
        exact(back, x, f"{what} round trip")
    say("ntt_vs_plain", "== fwd, inv and round trip at (limbs x batch) "
        + ", ".join(f"{len(sel)}x{b}" for _, sel, b in ntt_cases), t)

    # 4. K3 against its plain version, exact, at every ModUp group and the
    #    ModDown of both presets at their top level (config5_boot: 15->45 x2,
    #    15->30; config5_boot_dw: 10->58 x4, 8->58, 10->48)
    t = time.perf_counter()
    ksc = rns.make_ks_context(params, L, device=dev)
    ksc_dw = rns.make_ks_context(dw, L_dw, device=dev)
    conv_err = 0
    conv_cases = {}
    for tag, pr, c, k in (("", params, ctx, ksc), ("_dw", dw, ctx_dw, ksc_dw)):
        lv, top = pr.num_limbs, pr.num_limbs + len(pr.p_primes)
        for g, (d0, d1) in enumerate(rns.ks_groups(pr, lv)):
            conv_cases[f"modup{tag} {g}"] = (c, k.modup[g], range(d0, d1))
        conv_cases[f"moddown{tag}"] = (c, k.p2q, range(lv, top))
    for what, (c, tabs, rows) in conv_cases.items():
        x = rand_limbs(c, rows)
        got = convert_cuda.base_convert_cuda(x, tabs)
        want = convert_cuda.base_convert_plain(x, tabs)
        conv_err = max(conv_err, exact(got, want, f"base conversion {what}"))
    worst = ("modup 0", "modup_dw 0")  # 15->45 and 10->58 at the largest residues, q - 1
    for what in worst:
        c, tabs, rows = conv_cases[what]
        top = (tabs.sq[:, None] - 1).expand(len(rows), c.n).contiguous()
        conv_err = max(conv_err, exact(convert_cuda.base_convert_cuda(top, tabs),
                                       convert_cuda.base_convert_plain(top, tabs),
                                       f"base conversion {what} at q - 1"))
    # the fused ModDown (K3 with its epilogue) at the dw key switch's shape:
    # both components and a two-row addend in one launch == the plain
    # ModDown and add_mod
    acc_dw, add_dw = rand_limbs(ctx_dw, range(qp_dw), (2,)), rand_limbs(ctx_dw, range(L_dw), (2,))
    before = convert_cuda.MOD_DOWN.launches
    fused = rns.mod_down(acc_dw, dw, L_dw, ctx_dw, ksc_dw, addend=add_dw)
    fused_launches = convert_cuda.MOD_DOWN.launches - before
    conv_err = max(conv_err, exact(fused, convert_cuda.mod_down_plain(
                                       acc_dw, ksc_dw.p2q, ksc_dw.p2q_epilogue, add_dw),
                                   f"fused ModDown {qp_dw}->{L_dw} x 2 with an addend"))
    if fused_launches != 1:
        raise AssertionError(f"fused ModDown: {fused_launches} launches, not 1")
    say("convert_vs_plain", "== at " + ", ".join(
        f"{k} {len(r)}->{tb.dq.numel()}" for k, (_, tb, r) in conv_cases.items())
        + f"; and at x = q - 1 at {', '.join(worst)}; fused ModDown [2, {qp_dw}] -> {L_dw} "
        f"with a two-row addend == plain in {fused_launches} launch", t)

    # 5. K4 against its plain version, exact, at the shapes the paths launch:
    #    the relinearisation at config5_boot (a key stored at the level) and one
    #    level down (stored above it), the dw key switch, a hoisted rotation's
    #    (with the automorphism folded in), ct_plain_mac over 3 ciphertexts and
    #    the single-output launch of ct_mul_plain on a third component
    t = time.perf_counter()
    perm1 = dct.galois_perm(gckks.galois_exponent(1, n), ctx, torch.int32)

    def mac_case(c, pr, level, d_dim, with_perm=False, plain_mac=False, one=False):
        """Random canonical K4 operands; keys are stored over the full chain."""
        if plain_mac:
            rows = chain = c.index(range(level), torch.int32)
            y_rows = range(level)
        else:
            rows = c.index(keyswitch.key_row_index(pr, level, c.num_total), torch.int32)
            chain = c.index(keyswitch.qp_indices(pr, level), torch.int32)
            y_rows = range(c.num_total)
        x = rand_limbs(c, chain.tolist(), (d_dim,))
        y0, y1 = rand_limbs(c, y_rows, (d_dim,)), rand_limbs(c, y_rows, (d_dim,))
        return x, y0, None if one else y1, rows, chain, c, perm1 if with_perm else None

    mac_cases = {
        f"D=2 T={qp}": mac_case(ctx, params, L, 2),
        f"D=2 T={qp - 1} (key stored above the level)": mac_case(ctx, params, L - 1, 2),
        f"D=5 T={qp_dw}": mac_case(ctx_dw, dw, L_dw, 5),
        f"D=2 T={qp} perm": mac_case(ctx, params, L, 2, with_perm=True),
        f"D=3 T={L} (ct_plain_mac)": mac_case(ctx, params, L, 3, plain_mac=True),
        f"D=1 T={L} one output (ct_mul_plain, c2)": mac_case(ctx, params, L, 1, plain_mac=True,
                                                           one=True),
    }
    mac_err = 0
    for what, args in mac_cases.items():
        mac_err = max(mac_err, exact(mac_cuda.mac_cuda(*args), mac_cuda.mac_plain(*args),
                                     f"K4 {what}"))
    mac_inputs = {"mul": mac_cases[f"D=2 T={qp}"], "dw": mac_cases[f"D=5 T={qp_dw}"]}
    say("mac_vs_plain", "== at " + "; ".join(mac_cases), t)

    # 5a. the rescale kernel against its plain versions, and timed alone
    t = time.perf_counter()
    resc = rescale_kernel_run(dev, smi)
    say("rescale_vs_plain", "== at (chain level/limbs) " + ", ".join(resc["checked"]), t)

    # 5b. the tensor kernel against its plain version, and timed alone
    t = time.perf_counter()
    tens = tensor_kernel_run(dev, smi)
    say("tensor_vs_plain", "== at " + ", ".join(
        f"{tag} {r['shape']}" for tag, r in tens["timing"].items()), t)

    # 6. P1: K1 and its ablation builds at the 45-limb forward shape; the
    #    copy_only build == its plain version (two bit-reversed transposes),
    #    the natural_store build (the unpadded exchange tile) and the
    #    narrow_tfast build (one word per thread on pass B's t-fast side)
    #    == the NTT, forward and inverse
    t = time.perf_counter()
    idx45 = ctx.index(range(qp), torch.int32)
    x45 = rand_limbs(ctx, range(qp))
    copy_kernel = probes.ABLATION_KERNELS["copy_only"]
    copy_err = exact(ntt_cuda.fourstep_cuda(x45, idx45, ctx, False, copy_kernel),
                     probes.copy_only_plain(x45, ctx), "K1 copy_only build")
    for name in ("natural_store", "narrow_tfast"):
        for inverse in (False, True):
            exact(ntt_cuda.fourstep_cuda(x45, idx45, ctx, inverse, probes.ABLATION_KERNELS[name]),
                  ntt_cuda.fourstep_plain(x45, idx45, ctx, inverse), f"K1 {name} build")
    copy_kernel.reset()  # count the timing's launches, not the check's
    ablation = probes.ntt_ablation(x45, idx45, ctx)
    copy_launches = copy_kernel.launches
    ablation["copy_only_plain"] = cuda_ms(lambda: probes.copy_only_plain(x45, ctx), iters=5)
    print(f"ntt_ablation fwd x {qp} limbs, ms per call: " + ", ".join(
        f"{k} {v:.4f}" for k, v in ablation.items()) + f"  [{smi}]", flush=True)
    ablation_dev = {}
    # the inverse too where the t-fast side's width is what differs: there
    # pass B writes the scratch t-fast (kind 2), forward pass B reads it (kind 1)
    for name, kernel in {"full": ntt_cuda.KERNEL, **probes.ABLATION_KERNELS}.items():
        for inverse in (False, True) if name in ("full", "narrow_tfast") else (False,):
            tag = f"{name} inv" if inverse else name
            ablation_dev[tag], passes = kernel_ms(
                lambda: ntt_cuda.fourstep_cuda(x45, idx45, ctx, inverse, kernel), K1_NAME, 2)
            print(f"ntt_ablation {tag}: device {ablation_dev[tag]:.4f} ms per call; per pass "
                  f"(kind 0 = fwd A, 1 = fwd B, 2 = inv B, 3 = inv A): {passes}  [{smi}]",
                  flush=True)
    say("ntt_ablation", f"device ms per call: full {ablation_dev['full']:.4f}, copy_only "
        f"{ablation_dev['copy_only']:.4f} (== its plain version), natural_store "
        f"{ablation_dev['natural_store']:.4f}, narrow_tfast {ablation_dev['narrow_tfast']:.4f} "
        f"/ inv {ablation_dev['narrow_tfast inv']:.4f} against full inv "
        f"{ablation_dev['full inv']:.4f} (both == the NTT)", t)

    # 6a. K1's pass entry point (ntt_pass) and the distributed four-step
    meshk = mesh_kernels(dev, smi, params, ctx)
    pass_launches = {}

    # 6b. path "golden_vectors": the five device-reachable known-answer
    #     vectors of tests/vectors, on the card from their stored seeds
    launches = {}
    golden_vectors(dev, smi, counts, reset, launches)

    # 7. path "mul": the config5_boot multiply, through the entry points
    za, zb = mul_inputs(params)
    t = time.perf_counter()
    reset()
    chest, cts, prod, per_mul = mul_path(ctx, counts)
    got = dct.decrypt_decode(prod, params, chest.device_sk, ctx)
    launches["mul"] = counts()
    say("mul_path", f"keygen (rlk, Galois {ROTATIONS}, conj), encode, encrypt x2, ct_mul_full, "
        f"decrypt_decode at {PRESET}; launches {launches['mul']}, per ct_mul_full {per_mul}", t)
    err = decode_err(got, za * zb, params.slots, "ct_mul_full")
    if kernel_missing(per_mul) or per_mul["rescale"] != 1 or per_mul["tensor"] != 1:
        raise AssertionError(f"ct_mul_full: a kernel did not run, or the rescale or tensor "
                             f"kernel not once: {per_mul}")

    # 8. path "dw": the config5_boot_dw multiply
    da, db = dw_inputs(dw)
    t = time.perf_counter()
    reset()
    chest_dw, cts_dw, prod_dw, per_dw = dw_path(ctx_dw, counts)
    got_dw = dct.decrypt_decode(prod_dw, dw, chest_dw.device_sk, ctx_dw)
    launches["dw"] = counts()
    if chest_dw.eph is None:
        raise AssertionError("config5_boot_dw keygen drew no encapsulation keys")
    say("dw_path", f"keygen (rlk + eph h={dw.eph_hamming_weight}), encode, encrypt x2, "
        f"ct_mul_full, decrypt_decode at {DW_PRESET}; launches {launches['dw']}, per "
        f"ct_mul_full {per_dw}", t)
    ctx_dw_cpu = make_context(dw, device="cpu")
    err_dw = decode_err(got_dw, da * db, dw.slots, "dw ct_mul_full")
    if kernel_missing(per_dw) or per_dw["rescale"] != 1 or per_dw["tensor"] != 1:
        raise AssertionError(f"dw ct_mul_full: a kernel did not run, or the rescale (both limbs "
                             f"in one launch) or tensor kernel not once: {per_dw}")

    # 9. path "rotate" at config5_boot, on the mul path's keys: three fresh
    #    ciphertexts at 2^ROT_SCALE_BITS and three plaintexts at the preset's scale
    zs, ws = rotate_inputs(params)
    want_rot = {
        "ct_rotate 1": [np.roll(zs[0], -1)],
        "ct_conjugate": [np.conj(zs[0])],
        f"ct_rotate_hoisted {list(ROTATIONS)}": [np.roll(zs[0], -s) for s in ROTATIONS],
        "ct_mul_plain": [zs[0] * ws[0]],
        "ct_plain_mac x3": [sum(z * w for z, w in zip(zs, ws))],
    }
    # K4 launches per op: one per key switch, one per plaintext MAC or product
    k4_launches = {name: 1 for name in want_rot}
    k4_launches[f"ct_rotate_hoisted {list(ROTATIONS)}"] = len(ROTATIONS)
    t = time.perf_counter()
    reset()
    outs, per_op = rotate_path(ctx, chest, counts)
    decoded = {name: [dct.decrypt_decode(o, params, chest.device_sk, ctx) for o in os_]
               for name, os_ in outs.items()}
    launches["rotate"] = counts()
    say("rotate_path", f"encode, encrypt x3 at 2^{ROT_SCALE_BITS}, {', '.join(outs)} at {PRESET}; "
        f"launches {launches['rotate']}; "
        f"per op {per_op}", t)
    errs = {}
    for name, os_ in outs.items():
        errs[name] = max(decode_err(g, w, params.slots, name)
                         for g, w in zip(decoded[name], want_rot[name]))
        if per_op[name]["mac"] != k4_launches[name]:
            raise AssertionError(f"{name}: K4 launched {per_op[name]['mac']} times, not "
                                 f"{k4_launches[name]}")

    def join_cpu_twins():
        """mul_check, dw_check, rotate_check and the deferred checks (bgv,
        bfv, golden_n16, int_ci, boot_ci, boot, boot_h_ring, models_ci,
        session_ci): the card's limbs == the CPU twins' (computed in their
        own processes since the run began, or in a background thread)."""
        t = time.perf_counter()
        cpu = twins.result()
        wait_s = time.perf_counter() - t
        ci = ci_twins.result()
        wait_ci_s = time.perf_counter() - t - wait_s
        gold = gold_twins.result()
        wait_gold_s = time.perf_counter() - t - wait_s - wait_ci_s
        same_limbs(prod, cpu["mul"], "ct_mul_full")
        say("mul_check", f"ct_mul_full limbs == the CPU path ({prod.level} limbs x 2); max "
            f"|dec - za*zb| = {err:.3e} < {DECODE_TOL}; launches in ct_mul_full {per_mul} > 0 "
            f"(the CPU twins joined after {wait_s:.2f}, {wait_ci_s:.2f} and {wait_gold_s:.2f} s "
            f"(n16, ci, golden); their seconds "
            + ", ".join(f"{k} {v:.1f}" for k, v in (cpu["secs"] | ci["secs"]).items())
            + ")", t)
        t = time.perf_counter()
        same_limbs(prod_dw, cpu["dw"], "dw ct_mul_full")
        say("dw_check", f"ct_mul_full limbs == the CPU path ({prod_dw.level} limbs x 2, scale "
            f"2^{np.log2(prod_dw.scale):.3f}); max |dec - za*zb| = {err_dw:.3e} < "
            f"{DECODE_TOL}; launches in ct_mul_full {per_dw} > 0", t)
        t = time.perf_counter()
        for name, os_ in outs.items():
            for i, (o, oc) in enumerate(zip(os_, cpu["rotate"][name])):
                same_limbs(o, oc, f"{name} [{i}]")
        say("rotate_check", "limbs == the CPU path; max |dec - want| " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()) + f" < {DECODE_TOL}; K4 launches per op "
            + ", ".join(f"{k} {v['mac']}" for k, v in per_op.items()), t)
        for check in deferred:
            check(cpu | ci | {"golden": gold})

    # 9a. the integer schemes at INT_PRESET: their kernels' new shapes, the
    #     BGV and BFV paths (each checked == the CPU path on one ct_mul),
    #     every op at CI size on the card and the CPU, and their timing
    ik = int_kernels(dev, smi)
    bgv = bgv_path(dev, smi, counts, reset, launches)
    bfv = bfv_path(dev, smi, counts, reset, launches, bgv)
    deferred = [bgv.pop("check"), bfv.pop("check")]
    # golden_n16: the card's N=2^16 products against the golden model's (its
    # CPU twins), after cli
    gold_card = {"mul": prod, "bgv": bgv["mul"][0], "bfv": bfv["mul"][0],
                 "ct_mod_raise": [card_mod_raise(params, ctx, chest)]}
    gold_card.update({k: outs[k] for k in GOLDEN_ROTATE_OPS[:3]})
    deferred.append(golden_n16(gold_card, smi))
    deferred.append(int_ci(dev, smi, counts, reset, launches))
    int_times = int_timing(bgv, bfv, ik, bounds, counts, smi)
    # 9b'. the sharded multiplies on a (2, 4) mesh of shards on the card
    mesh_rows = mesh_mul(dev, smi, counts, reset, launches, params, ctx, chest, cts, prod,
                         bgv, bfv)
    pass_launches["mesh_mul"] = ntt_cuda.PASS_KERNEL.launches
    del bgv, bfv  # their keys

    # 9b. paths "boot_ci" and "boot": the bootstrap at CI size (card == CPU)
    #     and the config5_boot_dw flagship
    deferred.append(boot_ci_path(dev, counts, reset, launches))
    boot = boot_path(dev, smi, counts, reset, launches, ctx_dw_cpu)
    deferred.append(boot.pop("check"))

    # 10. times on the card (CUDA events, after warm-up; K3 and K4 also by
    #     profiler kernel time, as `dev_times`)
    t = time.perf_counter()
    times = {
        "ntt_plain": cuda_ms(lambda: ntt_cuda.fourstep_plain(x45, idx45, ctx, False), iters=5),
    }
    dev_times = {}
    shapes = {"modup": (ctx, ksc.modup[0], range(params.alpha)),
              "moddown": (ctx, ksc.p2q, range(L, qp)),
              "modup_dw": (ctx_dw, ksc_dw.modup[0], range(dw.alpha))}
    for what, (c, tabs, rows) in shapes.items():
        x = rand_limbs(c, rows)
        times[f"convert_{what}"] = cuda_ms(lambda: convert_cuda.base_convert_cuda(x, tabs))
        dev_times[f"convert_{what}"], _ = kernel_ms(
            lambda: convert_cuda.base_convert_cuda(x, tabs), K3_NAME)
        times[f"convert_{what}_plain"] = cuda_ms(
            lambda: convert_cuda.base_convert_plain(x, tabs), iters=5)
    # the fused ModDown on phase 4's operands (the dw key switch's top shape)
    fused_down = lambda: rns.mod_down(acc_dw, dw, L_dw, ctx_dw, ksc_dw, addend=add_dw)  # noqa: E731
    times["mod_down_dw"] = cuda_ms(fused_down)
    dev_times["mod_down_dw"], _ = kernel_ms(fused_down, K3_NAME)
    times["mod_down_dw_plain"] = cuda_ms(lambda: convert_cuda.mod_down_plain(
        acc_dw, ksc_dw.p2q, ksc_dw.p2q_epilogue, add_dw), iters=5)
    for key, args in mac_inputs.items():
        times[f"mac_{key}"] = cuda_ms(lambda: mac_cuda.mac_cuda(*args))
        dev_times[f"mac_{key}"], _ = kernel_ms(lambda: mac_cuda.mac_cuda(*args), K4_NAME)
        times[f"mac_{key}_plain"] = cuda_ms(lambda: mac_cuda.mac_plain(*args), iters=5)

    def stage_leaves(pr, c, ch, a, b, tag):
        level = pr.num_limbs
        k_ctx = rns.make_ks_context(pr, level, device=c.device)
        xk = rand_limbs(c, range(level))
        xqp = rand_limbs(c, keyswitch.qp_indices(pr, level))
        raised = keyswitch.hoist(xk, pr, level, c, k_ctx)
        return {
            f"ntt_fwd_k{tag}": lambda: ntt_fwd(xk, c, limbs=range(level)),
            f"ntt_inv_qp{tag}": lambda: ntt_inv(xqp, c, limbs=keyswitch.qp_indices(pr, level)),
            f"mod_up{tag}": lambda: rns.mod_up(xk, pr, level, c, k_ctx),
            f"ks_mac{tag}": lambda: keyswitch.gadget_mac(raised, pr, level, c, ch.device_rlk),
            f"mod_down{tag}": lambda: rns.mod_down(xqp, pr, level, c, k_ctx),
            f"rescale{tag}": lambda: rns.rescale(torch.stack([xk, xk]), pr, level, c, k_ctx),
            f"key_switch{tag}": lambda: keyswitch.key_switch_core(xk, pr, level, c, k_ctx,
                                                                  ch.device_rlk, eval_out=False),
            f"mul_full{tag}": lambda: dct.ct_mul_full(a, b, pr, c, ch.device_rlk),
        }

    leaves = stage_leaves(params, ctx, chest, cts[0], cts[1], "")
    leaves.update(stage_leaves(dw, ctx_dw, chest_dw, *cts_dw, "_dw"))
    gks = {s: chest.galois_key(s) for s in ROTATIONS}
    ksc_l = rns.make_ks_context(params, L, device=dev)
    leaves.update({
        "ct_rotate": lambda: dct.ct_rotate(cts[0], 1, params, ctx, gks[1]),
        "hoist": lambda: keyswitch.hoist(cts[0].c[1], params, L, ctx, ksc_l),
        "ct_rotate_hoisted_x2": lambda: dct.ct_rotate_hoisted(cts[0], list(ROTATIONS), params,
                                                              ctx, gks),
    })
    for name, fn in leaves.items():
        times[name] = cuda_ms(fn, iters=10)
    times["hoisted_per_step"] = (times["ct_rotate_hoisted_x2"] - times["hoist"]) / len(ROTATIONS)
    for name, ms in times.items():
        print(f"time {name}: {ms:.4f} ms  [{smi}]", flush=True)
    for name, ms in dev_times.items():
        print(f"device time {name}: {ms:.4f} ms  [{smi}]", flush=True)
    groups = {"K1": "k1_pass", "K3": K3_NAME, "K4": K4_NAME}
    for tag, per in (("", per_mul), ("_dw", per_dw)):
        iters = 5
        busy, span, top = device_profile(leaves[f"mul_full{tag}"], iters)
        # a trace that dropped launches reads low: compare with the launch counts
        want = {"K1": 2 * per["ntt"] * iters, "K3": per["convert"] * iters,
                "K4": per["mac"] * iters}
        seen = {g: sum(c for _, name, c in top if key in name) for g, key in groups.items()}
        print(f"profile mul_full{tag} launches traced {seen}, expected {want}", flush=True)
        event_share = busy / times[f"mul_full{tag}"]
        print(f"profile mul_full{tag}: device busy {busy:.4f} ms per call, {event_share:.1%} of "
              f"the CUDA-event time of 10 calls unprofiled, {busy / span:.1%} of the profiled "
              f"calls' own CUDA-event time ({span:.4f} ms)  [{smi}]", flush=True)
        per_group = {g: sum(ms for ms, name, _ in top if key in name) for g, key in groups.items()}
        print(f"profile mul_full{tag} per kernel, ms per call: " + ", ".join(
            f"{g} {ms:.4f}" for g, ms in per_group.items())
            + f", the rest {busy - sum(per_group.values()):.4f}", flush=True)
        for ms, name, _ in top[:10]:
            print(f"profile mul_full{tag} kernel {ms:.4f} ms/call  {name[:90]}", flush=True)
    say("timing", f"mul_full {times['mul_full']:.3f} ms, mul_full_dw {times['mul_full_dw']:.3f} "
        f"ms, ct_rotate {times['ct_rotate']:.3f} ms, hoisted {times['hoisted_per_step']:.3f} "
        f"ms per step, K4 {times['mac_mul']:.4f} / {times['mac_dw']:.4f} ms", t)

    ntt_work, conv_work, mac_work, bound = bounds.ntt, bounds.conv, bounds.mac, bounds.ms
    log_n = n.bit_length() - 1
    per_call = {
        "ct_mul_full": lambda: dct.ct_mul_full(cts[0], cts[1], params, ctx, chest.device_rlk),
        "ct_mul_full_dw": lambda: dct.ct_mul_full(*cts_dw, dw, ctx_dw, chest_dw.device_rlk),
        "ct_rotate": leaves["ct_rotate"],
        f"bootstrap at {BOOT_PRESET} (steady)": boot.pop("call"),
    }
    for what, fn in per_call.items():
        bounds.report(what, fn)
    del per_call, fn  # the flagship's keys and plans
    gc.collect()  # the plans and the backend refer to each other
    if torch.cuda.memory_allocated(dev) > 8 * 2**30:
        raise AssertionError(f"{gib(torch.cuda.memory_allocated(dev))} still allocated: the "
                             "flagship's chest outlived its path")

    # 10a. path "boot_h": the single-word bootstrap at config5_boot_h (its
    #      own keys, drawn after the flagship's were freed)
    boot_h = boot_h_path(dev, smi, counts, reset, launches, bounds)
    deferred.append(boot_h.pop("ring_check"))

    # 10b. the models: "deep_mlp" (its own chest at config5_boot_dw, drawn after
    #      boot_h's keys were freed), "mlp_n15" at N=2^15 and "models_ci"
    gc.collect()
    if torch.cuda.memory_allocated(dev) > 8 * 2**30:
        raise AssertionError(f"{gib(torch.cuda.memory_allocated(dev))} still allocated: the "
                             "boot_h path's chest outlived its path")
    # 10c. the Session facade at PRESET ("session_ckks"), whose save (zlib
    #      over its keys on the host, in a background thread) runs beside the
    #      models; "session_io" joins it below
    sess = session_ckks(dev, smi, counts, reset, launches, times)
    saving = session_save(sess)
    deep = deep_mlp_path(dev, smi, counts, reset, launches)
    gc.collect()
    ctx15 = make_context(preset(MLP_PRESET), device=dev)
    bounds15 = Bounds(ctx15.n, ctx15.n1, ctx15.n2, mod_rate, rates["muladd"])
    mlp = mlp_n15_path(dev, smi, counts, reset, launches, bounds15)
    ci_items, check = models_ci(dev, smi, counts, reset, launches)
    deferred.append(check)

    # 10d. the rest of the Session facade and the CLI: "session_bfv" at
    #      INT_PRESET, "session_ci" (card == CPU at CI size), "session_io"
    #      at PRESET, "cli" (the subcommands, in process)
    gc.collect()
    sess_bfv = session_bfv(dev, smi, counts, reset, launches)
    sess_ci, check = session_ci(dev, smi, counts, reset, launches)
    deferred.append(check)
    io_stats = session_io(dev, smi, counts, reset, launches, sess, saving)
    sess_stats = {k: sess[k] for k in ("create_s", "op_ms", "turns", "errs")}
    del sess, saving  # the config5_boot session's keys
    cli_rows = cli_phase(dev, smi, counts, reset, launches, bounds, params)
    bench_line = bench_phase(dev, smi, counts, reset, launches, params, ctx)
    # the CPU twins, computed in their own process since the run began
    join_cpu_twins()
    # 10e. the mesh at full width (config5_boot_dw) and at CI size
    gc.collect()
    n16 = mesh_n16(dev, smi, counts, reset, launches, dw, ctx_dw)
    pass_launches["mesh_n16"] = ntt_cuda.PASS_KERNEL.launches
    mesh_ci(dev, smi, counts, reset, launches, ci_twins.result()["mesh_ci"])
    pass_launches["mesh_ci"] = ntt_cuda.PASS_KERNEL.launches
    ntt45 = ntt_work(qp, qp)
    s_up, t_up = params.alpha, qp
    conv_up = conv_work(s_up, t_up)
    s_dn, t_dn = len(params.p_primes), L
    mac_mul, mac_dw = mac_work(2, qp), mac_work(5, qp_dw)
    def sides(work):
        b, by = bound(*work)
        nbytes, nmod, nmuladd = work
        return (f"{b:.5f} ms ({by}; bytes {nbytes / HBM_BYTES_PER_S * 1e3:.5f}, operations "
                f"{(nmod / mod_rate + nmuladd / rates['muladd']) * 1e3:.5f})")

    conv_dw = conv_work(dw.alpha, qp_dw)
    print(f"bound per call (modular products at {mod_rate / 1e12:.4f} T/s, multiply-adds at "
          f"{rates['muladd'] / 1e12:.4f} T/s): ntt[{qp}] {sides(ntt45)}; convert ModUp "
          f"{s_up}->{t_up} {sides(conv_up)}; ModDown {s_dn}->{t_dn} "
          f"{sides(conv_work(s_dn, t_dn))}; ModUp {dw.alpha}->{qp_dw} {sides(conv_dw)}; "
          f"K4 D=2 T={qp} {sides(mac_mul)}; K4 D=5 T={qp_dw} {sides(mac_dw)}", flush=True)

    # 11. K1 alone, forward and inverse, at config5_boot's Q+P chain (45 x 1)
    #     and the dw key switch's raised digits (58 x 5): the CUDA-event time
    #     per call (host launch included) and the device time (profiler
    #     kernel time, both passes), each beside the bound and the achieved
    #     bandwidth, for the data in and out once (16 bytes per residue) and
    #     for the two passes' traffic (int64 in, u32 scratch out and back in,
    #     int64 out: 24 bytes per residue)
    t = time.perf_counter()
    k1_times, k1_events = {}, {}
    for c, limbs, batch in ((ctx, qp, 1), (ctx_dw, qp_dw, dw.dnum)):
        idx_k = c.index(range(limbs), torch.int32)
        xk = rand_limbs(c, list(range(limbs)) * batch)
        rows_k = limbs * batch
        b_ms, b_by = bound(*ntt_work(rows_k, limbs))
        once, passes = 16 * rows_k * n, 24 * rows_k * n
        for inverse in (False, True):
            call = lambda: ntt_cuda.fourstep_cuda(xk, idx_k, c, inverse)  # noqa: E731
            tag = f"{'inv' if inverse else 'fwd'} {limbs}x{batch}"
            event_ms = cuda_ms(call, iters=50)
            dev_ms, per_pass = kernel_ms(call, K1_NAME, 2)
            k1_times[tag], k1_events[tag] = dev_ms, event_ms
            for what, ms in (("event", event_ms), ("device", dev_ms)):
                print(f"K1 {tag} x 2^{n.bit_length() - 1} {what}: {ms:.4f} ms; bound "
                      f"{b_ms:.5f} ms ({b_by}), {ms / b_ms:.2f}x; data in and out once "
                      f"{once / 1e6:.1f} MB at {once / ms / 1e9:.3f} TB/s (floor "
                      f"{once / HBM_BYTES_PER_S * 1e3:.5f} ms); two passes {passes / 1e6:.1f} MB "
                      f"at {passes / ms / 1e9:.3f} TB/s (floor "
                      f"{passes / HBM_BYTES_PER_S * 1e3:.5f} ms)  [{smi}]", flush=True)
            print(f"K1 {tag} device per pass, ms per call: {per_pass}", flush=True)
    say("ntt_timing", "event / device ms per call: " + ", ".join(
        f"{k} {k1_events[k]:.4f} / {v:.4f}" for k, v in k1_times.items()), t)

    # 12. K3 alone at ModUp 15->45, ModDown 15->30 and ModUp 10->58: the
    #     event and device time per call at the wrapper's defaults (phase 10),
    #     the bound, the bandwidth on the data in and out once (8 (S + T) N
    #     bytes), a sweep of the launch (destinations per block, coefficients
    #     per thread; the group of all T destinations at one coefficient per
    #     thread is the kernel without either), each launch == the plain
    #     version, and each instantiation's registers and spills from the
    #     -Xptxas -v log
    t = time.perf_counter()
    for key, (c, tabs, rows) in shapes.items():
        s_dim, t_dim = len(rows), tabs.dq.numel()
        b_ms, b_by = bound(*conv_work(s_dim, t_dim))
        once = 8 * (s_dim + t_dim) * n
        for what, ms in (("event", times[f"convert_{key}"]), ("device", dev_times[f"convert_{key}"])):
            print(f"K3 {s_dim}->{t_dim} x 2^{log_n} {what}: {ms:.4f} ms (group "
                  f"{convert_cuda.GROUP}, cpt {convert_cuda.CPT}); bound {b_ms:.5f} ms ({b_by}), "
                  f"{ms / b_ms:.2f}x; data in and out once {once / 1e6:.1f} MB at "
                  f"{once / ms / 1e9:.3f} TB/s  [{smi}]", flush=True)
        x = rand_limbs(c, rows)
        want = convert_cuda.base_convert_plain(x, tabs)
        sweep = {}
        for group in dict.fromkeys(g for g in (t_dim, 16, 8, 4) if g <= t_dim):
            for cpt in (1, 2):
                call = lambda: convert_cuda.base_convert_cuda(x, tabs, group, cpt)  # noqa: E731
                exact(call(), want, f"K3 {s_dim}->{t_dim} at group {group}, cpt {cpt}")
                sweep[group, cpt], _ = kernel_ms(call, K3_NAME)
        print(f"K3 {s_dim}->{t_dim} sweep, device ms per call by (group, cpt): " + ", ".join(
            f"({g}, {k}) {ms:.4f}" for (g, k), ms in sweep.items())
            + f"; best {min(sweep, key=sweep.get)}  [{smi}]", flush=True)
    # the fused ModDown: its least bytes read each input residue (P and Q
    # rows, the addend) and write each output once, at 4 B a residue
    down_bytes = 4 * 2 * (dw.alpha + 3 * L_dw) * n
    down_b = down_bytes / HBM_BYTES_PER_S * 1e3
    for what, ms in (("event", times["mod_down_dw"]), ("device", dev_times["mod_down_dw"])):
        print(f"K3 fused ModDown [2, {qp_dw}] -> {L_dw} + two-row addend {what}: {ms:.4f} ms; "
              f"bound {down_b:.5f} ms (bytes, {down_bytes / 1e6:.1f} MB at 4 B), "
              f"{ms / down_b:.2f}x; plain ModDown and add_mod {times['mod_down_dw_plain']:.4f} ms"
              f"  [{smi}]", flush=True)
    spills = ptxas_summary(logs.get("convert", ""),
                           r"base_convert_kernelILi(\d+)ELi(\d+)ELb(\d)E")
    print("K3 -Xptxas -v (s4, cpt, ModDown): " + ("; ".join(spills) or "not rebuilt in this run"),
          flush=True)
    say("convert_timing", "event / device ms per call: " + ", ".join(
        f"{len(r)}->{tb.dq.numel()} {times[f'convert_{k}']:.4f} / {dev_times[f'convert_{k}']:.4f}"
        for k, (_, tb, r) in shapes.items()), t)

    ntt_err, conv_err = max(ntt_err, ik["ntt_err"]), max(conv_err, ik["conv_err"])
    total = {key: sum(launches[p][key] for p in launches) for key in kernels}
    by_path = {key: {p: launches[p][key] for p in launches} for key in kernels}
    rows = []
    for name, key, src, repl, err, work, ms, dev_ms, plain in (
        ("ntt_fourstep", "ntt", "gpufhe_tpu_torch/csrc/ntt.cu",
         "gpufhe_tpu/ops/ntt_pallas.py:601", ntt_err, ntt45, k1_events[f"fwd {qp}x1"],
         k1_times[f"fwd {qp}x1"], times["ntt_plain"]),
        ("base_convert", "convert", "gpufhe_tpu_torch/csrc/convert.cu",
         "gpufhe_tpu/ops/convert_pallas.py:152", conv_err, conv_up, times["convert_modup"],
         dev_times["convert_modup"], times["convert_modup_plain"]),
        ("key_switch_mac", "mac", "gpufhe_tpu_torch/csrc/mac.cu",
         "scripts/dw_mac_probe.py:112", mac_err, mac_mul, times["mac_mul"],
         dev_times["mac_mul"], times["mac_mul_plain"]),
    ):
        b_ms, b_by = bound(*work)
        prefix = {"ntt": "ntt", "convert": "convert", "mac": None}[key]
        group = {"ntt": "K1", "convert": "K3", "mac": "K4"}[key]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": total[key], "launches_by_path": by_path[key], "max_abs_err": err, "ms": ms, "device_ms": or_null(dev_ms),
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            # the integer schemes at INT_PRESET level 30: launches and summed
            # bound per ct_mul, and this kernel alone at their new shapes
            "integer": {
                **{f"{s}_ct_mul": {"launches": int_times[s]["per_mul"][key],
                                   "bound_ms": int_times[s]["bounds"][key][0]}
                   for s in ("bgv", "bfv")},
                "shapes": {k: v for k, v in int_times["shapes"].items()
                           if prefix and k.startswith(prefix)},
            },
            # the boot_h path: launches, summed bound and device ms per steady
            # call, and this kernel alone at its shapes there
            "boot_h": {
                "launches_per_call": boot_h["per_call"][key],
                "bound_ms_per_call": boot_h["bound"][key][0],
                "device_ms_per_call": boot_h["per_group"][group],
                "shapes": {k: v for k, v in boot_h["shapes"].items()
                           if k.startswith(key)},
            },
            # the models: launches, summed bound and device ms per steady
            # forward of the MNIST MLP at config3_ckks (N=2^15) and this kernel
            # alone at its shapes there; launches and device ms per steady
            # forward of the deep MLP (two bootstraps); launches per item of
            # models_ci
            "mlp_n15": {
                "launches_per_forward": mlp["per_forward"][key],
                "bound_ms_per_forward": mlp["bound"][key][0],
                "device_ms_per_forward": mlp["prof"]["per_group"][group],
                "shapes": {k: v for k, v in mlp["shapes"].items() if k.startswith(key)},
            },
            "deep_mlp": {
                "launches_per_forward": deep["per_forward"][key],
                "device_ms_per_forward": deep["prof"]["per_group"][group],
            },
            "models_ci": {name: per[key] for name, per in ci_items.items()},
            # the Session facade: launches per path (session_ckks, session_io at
            # PRESET, session_bfv at INT_PRESET) and per session_ci item
            "session": {**{p: launches[p][key]
                           for p in ("session_ckks", "session_io", "session_bfv", "cli")},
                        "session_ci": {name: per[key] for name, per in sess_ci.items()}},
        })
    # K1's pass entry point: its launches on the mesh paths, one forward
    # pass A over a block of PRESET's Q+P chain (1/C of each limb) timed
    # alone, its bound that block's bytes in and out once
    fa = meshk["timing"]["fwd A"]
    rows.append({
        "name": "ntt_pass", "route": "cuda", "source": "gpufhe_tpu_torch/csrc/ntt.cu",
        "replaces": "gpufhe_tpu/ops/ntt_pallas.py:601", "launches": sum(pass_launches.values()),
        "launches_by_path": pass_launches, "max_abs_err": meshk["err"], "ms": fa["ms"],
        "device_ms": or_null(fa["device_ms"]), "plain_ms": fa["plain_ms"],
        "bound_ms": fa["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "per_kind": {k: {**v, "device_ms": or_null(v["device_ms"])}
                     for k, v in meshk["timing"].items()},
        "mesh_mul": {k: {"ms": v["ms"], "single_ms": v["single_ms"], "per_call": v["per_call"]}
                     for k, v in mesh_rows.items() if v},
        "mesh_n16": n16,
    })
    # the rescale kernel: its launches on the paths; the dw instance timed
    # alone at the top of the mul8 cell, each instance in "shapes"
    r = resc["timing"]["dw"]
    rows.append({
        "name": "rescale", "route": "cuda", "source": "gpufhe_tpu_torch/csrc/rescale.cu",
        "replaces": None, "launches": total["rescale"], "launches_by_path": by_path["rescale"],
        "max_abs_err": 0, "ms": r["ms"], "device_ms": or_null(r["device_ms"]),
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "shapes": {tag: {**v, "device_ms": or_null(v["device_ms"])}
                   for tag, v in resc["timing"].items()},
    })
    # the tensor kernel: its launches on the paths and per request of the
    # cells (8 dw multiplies in mul8, 5 BGV in bgv_mul5, 8 BFV in bfv_mul8);
    # the dw shape timed alone, each shape in "shapes"
    r = tens["timing"]["dw_q"]
    per_req = {"mul8": 8 * per_dw["tensor"],
               "bgv_mul5": 5 * int_times["bgv"]["per_mul"]["tensor"],
               "bfv_mul8": 8 * int_times["bfv"]["per_mul"]["tensor"]}
    if per_req != {"mul8": 8, "bgv_mul5": 5, "bfv_mul8": 16}:
        raise AssertionError(f"tensor kernel launches per request {per_req}")
    print(f"tensor kernel launches per request: {per_req}  [{smi}]", flush=True)
    rows.append({
        "name": "tensor", "route": "cuda", "source": "gpufhe_tpu_torch/csrc/tensor.cu",
        "replaces": None, "launches": total["tensor"], "launches_by_path": by_path["tensor"],
        "launches_per_request": per_req, "max_abs_err": 0, "ms": r["ms"],
        "device_ms": or_null(r["device_ms"]), "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "shapes": {tag: {**v, "device_ms": or_null(v["device_ms"])}
                   for tag, v in tens["timing"].items()},
    })
    for mix in probes.MIXES:
        r, err, plain, n_launch = rate_rows[mix]
        ops = r["blocks"] * probes.THREADS * probes.CHAINS * r["depth"] * (2 if mix == "muladd" else 1)
        rows.append({
            "name": f"int_rate_{mix}", "route": "cuda", "source": "gpufhe_tpu_torch/csrc/int_rate.cu",
            "replaces": "scripts/vpu_peak.py:84", "launches": n_launch, "max_abs_err": err,
            "ms": r["ms"], "device_ms": None, "plain_ms": plain,
            "bound_ms": ops / int_peak * 1e3,
            "bound_by": "operations", "library_ms": None,
        })
    copy_bytes = 8 * 2 * qp * n
    rows.append({
        "name": "ntt_ablate_copy_only", "route": "cuda",
        "source": "gpufhe_tpu_torch/csrc/ntt.cu", "replaces": "scripts/ntt_ablate.py:176",
        "launches": copy_launches, "max_abs_err": copy_err, "ms": ablation["copy_only"],
        "device_ms": or_null(ablation_dev["copy_only"]), "plain_ms": ablation["copy_only_plain"],
        "bound_ms": copy_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", "library_ms": None,
    })
    print(f"# launches per path {launches}; ms: CUDA events per call (the host's launch "
          f"included), as in earlier runs; device_ms: the profiler's kernel time per call (no "
          f"host time; null for the int_rate probe, whose ms is its own event timing); shapes: "
          f"ntt_fourstep fwd {qp} x 2^{log_n}; base_convert ModUp {s_up}->{t_up}; key_switch_mac D=2 T={qp}; rescale [2, 48, 2^16] "
          f"dropping 2 limbs (its other instances in its shapes); bounds with modular "
          f"products at the shoup32 rate measured here; int_rate "
          f"{probes.CHAINS} chains x {rate_rows['modmul'][0]['depth']} steps per thread (bound: "
          f"one op per modular product, two per multiply-add, at {int_peak / 1e12:.2f} T/s: "
          f"{int_peak_text}); "
          f"ntt_ablate_copy_only (-DNTT_ABLATE=3) fwd {qp} x 2^{log_n}. The probes lie on no "
          f"path: their launches are those of their own timing phase (int_rate, ntt_ablation). "
          f"No single PyTorch call computes any of these functions mod q, so library_ms is null; "
          f"total {time.perf_counter() - T0:.1f} s, of it {PROFILER['s']:.1f} s in "
          f"{PROFILER['windows']} profiled windows (device_profile)", flush=True)
    print(f"# boot_h path at {BOOT_H_PRESET}: device_keygen {boot_h['keygen_s']:.2f} s (threefry "
          f"at its shapes, alone, {boot_h['threefry_s']:.3f} s), plans {boot_h['plan_s']:.2f} s, first call "
          f"{boot_h['first_s']:.3f} s, steady calls {[round(x, 3) for x in boot_h['event_ms']]} "
          f"ms by CUDA events (median {np.median(boot_h['event_ms']):.3f}); one profiled call "
          f"{boot_h['busy_ms']:.3f} ms device busy in {boot_h['span_ms']:.3f} ms; each phase "
          f"against its function " + ", ".join(f"{k} {v:.3e}" for k, v in boot_h["phase_err"].items())
          + f"; end to end max |dec - z| {boot_h['max_err']:.6e} (printed), at N=2^"
          f"{BOOT_H_RING_LOGN} {boot_h['ring_err']:.6e} (gated); peak device memory "
          + ", ".join(f"{k} {gib(v)}" for k, v in boot_h["peak"].items()) + f"  [{smi}]",
          flush=True)
    print(f"# boot path at {BOOT_PRESET}: device_keygen {boot['keygen_s']:.2f} s (threefry "
          f"at its shapes, alone, {boot['threefry_s']:.3f} s), plans "
          f"{boot['plan_s']:.2f} s, first call {boot['first_s']:.3f} s, steady calls "
          f"{[round(x, 4) for x in boot['steady_s']]} s on the host clock, "
          f"{[round(x, 3) for x in boot['event_ms']]} ms by CUDA events (median "
          f"{np.median(boot['event_ms']):.3f}); one profiled call {boot['busy_ms']:.3f} ms device "
          f"busy in {boot['span_ms']:.3f} ms of its own event time; max |dec - z| "
          f"{boot['max_err']:.3e}  [{smi}]", flush=True)
    for what, m, record in (("mlp_n15", mlp, MLP_RECORD), ("deep_mlp", deep, DEEP_RECORD)):
        ms = m["event_ms"]
        print(f"# {what} path: device_keygen {m['keygen_s']:.2f} s ({m['keys']} Galois keys), "
              f"plans {m['plan_s']:.2f} s, first forward {m['first_s']:.3f} s, steady forwards "
              f"{[round(x, 3) for x in ms]} ms by CUDA events (median {np.median(ms):.3f}); one "
              f"profiled forward {m['prof']['busy_ms']:.3f} ms device busy in "
              f"{m['prof']['span_ms']:.3f} ms; launches per forward {m['per_forward']}; max "
              f"|logit - reference| {m['max_err']!r} (the reference's record {record!r}); peak "
              f"device memory " + ", ".join(f"{k} {gib(v)}" for k, v in m["peak"].items())
              + f"  [{smi}]", flush=True)
    print(f"# session paths: Session.create at {PRESET} {sess_stats['create_s']:.2f} s, ms per op "
          "by CUDA events " + ", ".join(f"{k} {v:.4f}" for k, v in sess_stats["op_ms"].items())
          + " (in turns, Session / the call below it: " + ", ".join(
              f"{k} {v[1]:.4f} / {v[0]:.4f}" for k, v in sess_stats["turns"].items())
          + f"; phase timing's ct_mul_full {times['mul_full']:.4f}, ct_rotate "
          f"{times['ct_rotate']:.4f}); decode errors "
          + ", ".join(f"{k} {v:.3e}" for k, v in sess_stats["errs"].items())
          + "; save/load " + ", ".join(f"{k} {v:.2f} s" for k, v in io_stats["secs"].items())
          + ", files " + ", ".join(f"{k} {v} bytes" for k, v in io_stats["sizes"].items())
          + f"; at {INT_PRESET} (BFV) Session.create {sess_bfv['create_s']:.2f} s, noise_budget "
          f"{sess_bfv['budgets'][0]:.2f} -> {sess_bfv['budgets'][1]:.2f} bits; cli kernels rows "
          + ", ".join(f"{r['kernel']} {r['ms']} ms / bound {r['bound_ms']} ms" for r in cli_rows)
          + f"; bench ct_mul_full chain {bench_line['ms_per_mult']} ms per multiply (HBM floor "
          f"{bench_line['hbm_floor_ms']} ms)  [{smi}]", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
