"""gpufhe_tpu_torch/bench.py, the counterpart of the reference's root bench.py,
on the CPU: its multiply chain == the reference's chain of _mul_full_core
limb for limb from the same draws (ci_small, and boot_dw_ci, whose carry
pads two rows); each line function's keys at a CI preset; `cli bench`'s
lines in the reference's order, the --preset line last; and no fallback to
the CPU without --cpu."""

import io
import json
import os
import pathlib
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from gpufhe_tpu_torch import bench, cli

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's PyTorch CPU work: its tensors are
    small (N <= 2^10), and tier-1 runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_chain(preset_name: str, steps: int):
    """The reference bench's chain as a Python loop: _mul_full_core on
    __graft_entry__'s draws from default_rng(0), each output padded back to
    the level with the old operand's top scale_words rows. Returns the
    inputs and the final carry as numpy."""
    import jax.numpy as jnp

    from __graft_entry__ import _random_ct, _random_key, _setup
    from gpufhe_tpu.ciphertext.ct import _mul_full_core
    from gpufhe_tpu.primitives.rns import make_ks_context

    params, ctx, level, _ = _setup(preset_name)
    w = params.scale_words
    kscs = tuple(make_ks_context(params, level - i) for i in range(w))
    rng = np.random.default_rng(0)
    rlk = _random_key(params, rng)
    a, b = _random_ct(params, level, rng), _random_ct(params, level, rng)
    inputs = [np.asarray(x) for x in (rlk.b_mont, rlk.a_mont, *a, *b)]
    for _ in range(steps):
        r = _mul_full_core(a, b, ctx, kscs, rlk, params)
        a, b = tuple(jnp.concatenate([r[i], a[i][level - w:]]) for i in range(2)), a
    return inputs, [np.asarray(x) for x in (*a, *b)]


@pytest.mark.parametrize("preset_name", ["ci_small", "boot_dw_ci"])
def test_mult_chain_equals_the_reference_chain(preset_name):
    out = {}
    line = bench.bench_mult(preset_name, 3, 1, bench.PEAK_HBM_GBPS, device="cpu", out=out)
    assert line["device"] == "cpu" and out["steps"] == 6
    inputs, carry = _reference_chain(preset_name, out["steps"])
    got_inputs = [out["rlk"].b_mont, out["rlk"].a_mont, *out["a"].c, *out["b"].c]
    got_carry = [c for ct in out["carry"] for c in ct.c]
    for got, want in zip(got_inputs + got_carry, inputs + carry, strict=True):
        assert got.dtype == torch.int64 and (got.numpy() == want.astype(np.int64)).all()


MULT_KEYS = ["metric", "value", "unit", "ms_per_mult", "vs_baseline", "sol_kind", "sol_ms",
             "rebuild_overhead_ms", "traffic_model_mb", "implied_bw_frac_of_peak",
             "hbm_floor_ms", "device"]
LINES = {
    "mult": (lambda: bench.bench_mult("ci_small", 2, 1, bench.PEAK_HBM_GBPS, device="cpu"),
             MULT_KEYS, "ckks_mult_relin_rescale_N1024_L6"),
    "mult_dw": (lambda: bench.bench_mult("boot_dw_ci", 2, 1, bench.PEAK_HBM_GBPS, device="cpu"),
                MULT_KEYS, "ckks_mult_relin_rescale_N128_L24_dw"),
    "bgv": (lambda: bench.bench_int_mult("bgv", "bgv_ci", 2, 1, device="cpu"),
            ["metric", "value", "unit", "ms_per_mult", "chain", "device"],
            "bgv_mult_relin_modswitch_N1024_L6"),
    "bfv": (lambda: bench.bench_int_mult("bfv", "bfv_ci", 2, 1, device="cpu"),
            ["metric", "value", "unit", "ms_per_mult", "chain", "aux_limbs", "device"],
            "bfv_mult_relin_N1024_L6"),
    "ntt": (lambda: bench.bench_ntt("ci_small", 2, 1, device="cpu"),
            ["metric", "value", "unit", "us_per_limb_transform", "limb_transforms_per_s",
             "kernel", "chain", "device"], "ntt_fwd_polys_N1024_L6"),
    "bootstrap": (lambda: bench.bench_bootstrap("boot_dw_ci_enc", k_bound=5.0, steady=1,
                                                device="cpu"),
                  ["metric", "value", "unit", "vs_baseline", "max_err", "first_s", "device"],
                  "ckks_bootstrap_N128_doubleword_steady"),
    "mlp": (lambda: bench.bench_mlp("ci_small", dims=(12, 8, 4), steady=1, device="cpu"),
            ["metric", "value", "unit", "arch", "max_logit_err", "device"],
            "encrypted_mlp_inference_N1024"),
    "deep_mlp": (lambda: bench.bench_deep_mlp("boot_ci_deep", layers=3, d=4, in_level=3,
                                              k_bound=5.0, steady=1, device="cpu"),
                 ["metric", "value", "unit", "layers", "mid_inference_bootstraps",
                  "logits_max_err", "device"], "deep_mlp_bootstrap_N128_dw"),
    "mesh": (lambda: bench.bench_mesh_parity("boot_dw_ci_enc", mid_level=10, k_bound=5.0,
                                             device="cpu"),
             ["metric", "value", "unit", "programs", "device"], "n7_dw_mesh_numeric_execution"),
}


@pytest.mark.parametrize("name", list(LINES))
def test_line_keys_at_a_ci_preset(name):
    fn, keys, metric = LINES[name]
    line = fn()
    assert list(line) == keys and line["metric"] == metric and line["device"] == "cpu"
    json.dumps(line)
    assert all(np.isfinite(v) and v >= 0 for v in line.values()
               if isinstance(v, float | int) and not isinstance(v, bool))
    if name == "mesh":
        assert line["value"] == 1.0 and line["programs"] == [
            "eph_ks_to", "mod_raise2", "eph_ks_from", "fan_7off", "mult_rescale"]
    if name == "deep_mlp":
        assert line["mid_inference_bootstraps"] >= 1 and line["logits_max_err"] <= 1e-2
    if name == "bootstrap":
        assert line["max_err"] < 1e-3


def test_cli_bench_prints_the_reference_order_with_the_preset_last(monkeypatch):
    """--cpu bench --preset ci_small: the ci_small multiply and its stage rows
    run for real; the other lines are stubs, so the run takes seconds."""
    calls = []

    def stub(metric, **extra):
        return {"metric": metric, "value": 1.0, "unit": "u", "ms_per_mult": 2.0,
                "device": "cpu", **extra}

    real_mult = bench.bench_mult

    def mult(preset_name, chain, iters, hbm_bw, *, device="cuda", out=None):
        calls.append(("mult", preset_name, chain, iters, device))
        if preset_name == "ci_small":
            return real_mult(preset_name, chain, iters, hbm_bw, device=device)
        return stub(f"mult_{preset_name}")

    def stage_rows(preset_name, device):
        calls.append(("stages", preset_name, device))

    monkeypatch.setattr(bench, "bench_mult", mult)
    monkeypatch.setattr(bench, "_stage_rows", stage_rows)
    monkeypatch.setattr(bench, "bench_bootstrap", lambda *, device: stub("boot"))
    monkeypatch.setattr(bench, "bench_deep_mlp", lambda *, device: stub("deep"))
    monkeypatch.setattr(bench, "bench_mlp", lambda *, device: stub("mlp"))
    monkeypatch.setattr(bench, "bench_ntt",
                        lambda p, chain, iters, *, device: stub(f"ntt_{p}"))
    monkeypatch.setattr(bench, "bench_mesh_parity", lambda *, device: stub("mesh"))
    monkeypatch.setattr(bench, "bench_int_mult",
                        lambda scheme, *, chain, iters, device: stub(scheme))
    monkeypatch.setenv("BENCH_PRESET", "unset")
    monkeypatch.delenv("BENCH_PRESET")
    monkeypatch.setenv("BENCH_CHAIN", "2")
    monkeypatch.setenv("BENCH_ITERS", "1")
    out = io.StringIO()
    with redirect_stdout(out):
        cli.main(["--cpu", "bench", "--preset", "ci_small"])
    lines = [json.loads(t) for t in out.getvalue().splitlines() if not t.startswith("#")]
    assert [x["metric"] for x in lines] == [
        "boot", "deep", "mlp", "ntt_ci_small", "ntt_config5_boot_s29_s29_lazy",
        "mult_config5_boot_s29_s29_lazy", "mesh", "bfv", "bgv", "mult_config5_boot_dw",
        "ckks_mult_relin_rescale_N1024_L6"]
    assert list(lines[-1]) == MULT_KEYS and lines[-1]["device"] == "cpu"
    assert lines[7]["vs_ckks_mult"] == round(2.0 / lines[-1]["ms_per_mult"], 3)
    assert calls[0] == ("mult", "ci_small", 2, 1, "cpu")
    assert ("stages", "ci_small", "cpu") in calls and ("stages", "config5_boot_dw", "cpu") in calls
    assert os.environ["BENCH_PRESET"] == "ci_small"


def test_bench_without_a_card_and_without_cpu_fails():
    run = subprocess.run([sys.executable, "-m", "gpufhe_tpu_torch.cli", "bench"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                              "PYTHONPATH": str(ROOT)})
    assert run.returncode != 0
    assert "needs a CUDA device" in run.stderr and "--cpu" in run.stderr
    assert not [t for t in run.stdout.splitlines() if t.startswith("{")]
