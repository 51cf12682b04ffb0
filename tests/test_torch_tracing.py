"""The port's spans (utils/profiling.py `stage`) on the CPU.

With no profiler, `stage` is one shared no-op. Under torch.profiler with
CPU activity, every span the program opens at a layer boundary is recorded
as a `cpu_op` (never a `user_annotation`, which kineto mirrors onto the
card's timeline) on the profiler's clock, nested as the layers nest: the
CKKS multiply (ct_mul_full), BGV's and BFV's ct_mul, the single-shot ops
that open a span of their own, and a bootstrap at the CI preset
boot_dw_ci_enc (factored transforms, Chebyshev EvalMod, encapsulation).
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpufhe_tpu_torch.ciphertext import bfv, bgv
from gpufhe_tpu_torch.ciphertext import ct as dct
from gpufhe_tpu_torch.ciphertext.backend import DeviceBackend
from gpufhe_tpu_torch.ciphertext.bootstrap import Bootstrapper, bootstrap_rotations
from gpufhe_tpu_torch.encoding import encoder
from gpufhe_tpu_torch.keys.device_keygen import device_keygen
from gpufhe_tpu_torch.ops.context import make_context
from gpufhe_tpu_torch.params.params import preset
from gpufhe_tpu_torch.utils import profiling

SPANS = {"ckks.mul", "bgv.mul", "bfv.mul", "boot", "tensor", "ks.mod_up", "ks.inner",
         "ks.mod_down", "rescale", "boot.mod_raise", "boot.coeff_to_slot", "boot.evalmod",
         "boot.slot_to_coeff", "fan", "galois"}
PHASES = ["boot.mod_raise", "boot.coeff_to_slot", "boot.evalmod", "boot.slot_to_coeff"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file's PyTorch CPU work: its tensors are
    small (N <= 2^10), and tier-1 runs several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spans_of(fn) -> list:
    """[(name, start_ns, end_ns)] of the program's spans recorded while fn
    runs under a CPU profiler, in start order; asserts each is a cpu_op."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in SPANS:
            assert not ev.is_user_annotation(), ev.name()
            assert ev.device_type() == torch.autograd.DeviceType.CPU
            out.append((ev.name(), ev.start_ns(), ev.end_ns()))
    return sorted(out, key=lambda s: (s[1], -s[2]))


def parent(spans: list, i: int):
    """The name of the innermost span holding spans[i], or None."""
    _, s, e = spans[i]
    holders = [(ps, pe, pn) for j, (pn, ps, pe) in enumerate(spans)
               if j != i and ps <= s and e <= pe and (ps, -pe) < (s, -e)]
    return max(holders)[2] if holders else None


def names(spans: list) -> list:
    return [n for n, _, _ in spans]


def nesting(spans: list) -> set:
    return {(n, parent(spans, i)) for i, (n, _, _) in enumerate(spans)}


def test_stage_off_is_one_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.stage("a"), profiling.stage("b")
    assert a is b
    with a as entered:
        assert entered is None
        with b:  # reentrant
            pass
    # opened before the profiler starts: not in its trace
    with profiling.stage("opened_off"):
        got = spans_of(lambda: None)
    assert got == []


def test_stage_on_is_a_cpu_op_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        span = profiling.stage("on_span")
        assert span is not profiling.stage("on_span")
        t0 = time.time_ns()
        with span:
            torch.arange(8).sum()
        t1 = time.time_ns()
    got = [ev for ev in prof.profiler.kineto_results.events() if ev.name() == "on_span"]
    assert len(got) == 1
    assert not got[0].is_user_annotation()
    assert t0 <= got[0].start_ns() <= got[0].end_ns() <= t1


@pytest.fixture(scope="module")
def ckks():
    params = preset("boot_dw_ci_enc")
    ctx = make_context(params, device="cpu")
    chest = device_keygen(params, np.random.default_rng(3), ctx=ctx)
    rng = np.random.default_rng(4)
    z = np.exp(1j * rng.uniform(0, 2 * np.pi, params.slots))
    ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx, rng,
                     params.scale)
    return params, ctx, chest, ct


def _integer(mod, name):
    params = preset(name)
    ctx = make_context(params, device="cpu")
    chest = mod.keygen(params, np.random.default_rng(5), ctx=ctx)
    rng = np.random.default_rng(6)
    m = rng.integers(0, params.plain_modulus, params.n)
    return params, ctx, chest, mod.encrypt(m, params, chest.device_pk, ctx, rng)


def test_ckks_multiply_spans(ckks):
    params, ctx, chest, ct = ckks
    spans = spans_of(lambda: dct.ct_mul_full(ct, ct, params, ctx, chest.device_rlk))
    assert names(spans) == ["ckks.mul", "tensor", "ks.mod_up", "ks.inner", "ks.mod_down",
                            "rescale"]
    assert nesting(spans) == {("ckks.mul", None), ("tensor", "ckks.mul"),
                              ("ks.mod_up", "ckks.mul"), ("ks.inner", "ckks.mul"),
                              ("ks.mod_down", "ckks.mul"), ("rescale", "ckks.mul")}


def test_bgv_multiply_spans():
    params, ctx, chest, ct = _integer(bgv, "bgv_ci")
    spans = spans_of(lambda: bgv.ct_mul(ct, ct, params, ctx, chest.device_rlk))
    assert names(spans) == ["bgv.mul", "tensor", "ks.mod_up", "ks.inner", "ks.mod_down",
                            "rescale"]
    assert {p for _, p in nesting(spans)} == {None, "bgv.mul"}


def test_bfv_multiply_spans():
    params, ctx, chest, ct = _integer(bfv, "bfv_ci")
    spans = spans_of(lambda: bfv.ct_mul(ct, ct, params, ctx, chest.device_rlk))
    # _tensor_coeff's span holds tensor_core's two (over Q, over the aux basis)
    assert names(spans) == ["bfv.mul", "tensor", "tensor", "tensor", "ks.mod_up", "ks.inner",
                            "ks.mod_down"]
    assert nesting(spans) == {("bfv.mul", None), ("tensor", "bfv.mul"), ("tensor", "tensor"),
                              ("ks.mod_up", "bfv.mul"), ("ks.inner", "bfv.mul"),
                              ("ks.mod_down", "bfv.mul")}


@pytest.mark.parametrize("op", ["ckks.ct_mul", "ckks.ct_rescale", "ckks.rotate_hoisted",
                                "bgv.ct_modswitch", "bfv.ct_mod_reduce"])
def test_single_op_spans(op, ckks):
    if op.startswith("ckks"):
        params, ctx, chest, ct = ckks
        sq = dct.ct_tensor(ct, ct, ctx)
        run = {"ckks.ct_mul": lambda: dct.ct_mul(ct, ct, params, ctx, chest.device_rlk),
               "ckks.ct_rescale": lambda: dct.ct_rescale(sq, params, ctx),
               "ckks.rotate_hoisted": lambda: dct.ct_rotate_hoisted(
                   ct, [1, 2], params, ctx, {1: chest.device_rlk, 2: chest.device_rlk})}[op]
    elif op.startswith("bgv"):
        params, ctx, chest, ct = _integer(bgv, "bgv_ci")
        run = lambda: bgv.ct_modswitch(ct, params, ctx)  # noqa: E731
    else:
        params, ctx, chest, ct = _integer(bfv, "bfv_ci")
        run = lambda: bfv.ct_mod_reduce(ct, params, ctx)  # noqa: E731
    want = {"ckks.ct_mul": ["ckks.mul", "tensor", "ks.mod_up", "ks.inner", "ks.mod_down",
                            "rescale"],
            # one ModUp for both steps, then per step an automorphism with
            # its key and ModDown
            "ckks.rotate_hoisted": ["ks.mod_up", "galois", "ks.inner", "ks.mod_down",
                                    "galois", "ks.inner", "ks.mod_down"]}.get(op, ["rescale"])
    assert names(spans_of(run)) == want


@pytest.mark.parametrize("op", ["rotate", "conjugate", "rotate_hoisted"])
def test_galois_span_holds_its_key_switch(op):
    """A CKKS rotation or conjugation opens one `galois` span, with the key
    applied (`ks.inner`) and the ModDown inside it; a hoisted rotation's
    shared ModUp stays outside."""
    params = preset("ci_small")
    ctx = make_context(params, device="cpu")
    chest = device_keygen(params, np.random.default_rng(9), rotations=(3,), conjugation=True,
                          ctx=ctx)
    rng = np.random.default_rng(10)
    ct = dct.encrypt(encoder.encode(rng.normal(size=params.slots), params), params,
                     chest.device_pk, ctx, rng, params.scale)
    run = {"rotate": lambda: dct.ct_rotate(ct, 3, params, ctx, chest.galois_key(3)),
           "conjugate": lambda: dct.ct_conjugate(ct, params, ctx, chest.conj_key()),
           "rotate_hoisted": lambda: dct.ct_rotate_hoisted(ct, [3], params, ctx,
                                                           {3: chest.galois_key(3)})}[op]
    spans = spans_of(run)
    assert names(spans).count("galois") == 1
    nest = nesting(spans)
    assert ("ks.inner", "galois") in nest and ("ks.mod_down", "galois") in nest
    assert ("galois", None) in nest
    assert ("ks.mod_up", None if op == "rotate_hoisted" else "galois") in nest


@pytest.fixture(scope="module")
def boot_spans():
    params = preset("boot_dw_ci_enc")
    ctx = make_context(params, device="cpu")
    rots = bootstrap_rotations(params, transform="factored", radix_log=3)
    chest = device_keygen(params, np.random.default_rng(7), rotations=tuple(rots),
                          conjugation=True, ctx=ctx)
    bs = Bootstrapper(DeviceBackend(params, ctx, chest), transform="factored", radix_log=3,
                      evalmod="cheb", k_bound=5.0)
    rng = np.random.default_rng(8)
    z = (rng.normal(size=params.slots) + 1j * rng.normal(size=params.slots)) * 0.2
    ct = dct.encrypt(encoder.encode(z, params), params, chest.device_pk, ctx, rng,
                     params.scale, level=params.scale_words)
    bs(ct)  # the first call builds what later calls reuse
    phases = []
    spans = spans_of(lambda: bs(ct, _phase=lambda name, outs: phases.append(name)))
    return spans, phases


def test_bootstrap_spans(boot_spans):
    spans, phases = boot_spans
    assert phases == [p.split(".")[1] for p in PHASES]
    assert [n for i, (n, _, _) in enumerate(spans) if parent(spans, i) is None] == ["boot"]
    assert [n for i, (n, _, _) in enumerate(spans) if parent(spans, i) == "boot"] == PHASES
    nest = nesting(spans)
    assert ("fan", "boot.coeff_to_slot") in nest and ("fan", "boot.slot_to_coeff") in nest
    assert ("ks.inner", "fan") in nest and ("ks.mod_up", "fan") in nest
    assert ("rescale", "fan") in nest
    # the encapsulation's two key switches around ModRaise
    assert sum(1 for i, (n, _, _) in enumerate(spans)
               if n == "ks.inner" and parent(spans, i) == "boot.mod_raise") == 2
    # EvalMod's products are CKKS multiplies, each with its key switch
    assert ("ckks.mul", "boot.evalmod") in nest and ("ks.inner", "ckks.mul") in nest
    # the fans apply their Galois keys themselves: no single-key automorphism
    assert ("galois", "fan") not in nest
