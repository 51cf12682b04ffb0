"""The span readers (fhebench/spans.py and the four metrics that read it) on
hand-built traces: launch calls paired with device events in start order,
sync events left out, nested spans counted once, a launch outside every
span given to none, and a slice whose counts do not pair read as nothing."""

from __future__ import annotations

import pytest

from fhebench import harness, spans
from fhebench.trace import Trace


def trace(host_ops, gap_kernels) -> Trace:
    return Trace(1, 1.0, [], {"K1": 0, "K3": 0, "K4": 0}, {}, [], gap_kernels, host_ops)


def read(name: str, tr: Trace):
    return harness.load_module("metrics", name).read(tr)


# one request, times in seconds: a multiply holding the tensor (with a
# nested tensor inside it), the three key-switch spans and a rescale, then
# one launch outside every span; an aten op and non-launch runtime calls
# among the host ops, a sync event among the device events
HOST = [
    ("bfv.mul", 1.000, 0.100),
    ("tensor", 1.001, 0.020),
    ("aten::mul", 1.0015, 0.001),
    ("cudaLaunchKernel", 1.002, 0.0004),  # 0: tensor
    ("tensor", 1.005, 0.005),
    ("cudaLaunchKernel", 1.006, 0.0004),  # 1: tensor, nested
    ("cudaMemcpyAsync", 1.015, 0.0004),  # 2: tensor
    ("cudaStreamIsCapturing", 1.016, 0.0001),
    ("ks.mod_up", 1.030, 0.010),
    ("cudaLaunchKernel", 1.031, 0.0004),  # 3: ks
    ("cuLaunchKernel", 1.032, 0.0004),  # 4: ks
    ("ks.inner", 1.045, 0.005),
    ("cudaLaunchKernel", 1.046, 0.0004),  # 5: ks
    ("ks.mod_down", 1.055, 0.010),
    ("cudaMemsetAsync", 1.056, 0.0004),  # 6: ks
    ("rescale", 1.070, 0.010),
    ("cudaLaunchKernel", 1.071, 0.0004),  # 7: rescale
    ("cudaStreamSynchronize", 1.110, 0.002),
    ("cudaLaunchKernel", 1.120, 0.0004),  # 8: outside every span
]
# device events start later than their launches, in the same order
DEVICE = [
    ("k_tensor_a", 1.010, 0.001),
    ("k_tensor_b", 1.012, 0.002),
    ("Memcpy HtoD (Pageable -> Device)", 1.0201, 0.0005),
    ("k1_pass<8, 0>", 1.040, 0.003),
    ("base_convert_kernel", 1.044, 0.0025),
    ("Stream Sync", 1.045, 0.009),
    ("mac_kernel", 1.050, 0.004),
    ("Memset (Device)", 1.060, 0.0002),
    ("rescale_kernel", 1.080, 0.0015),
    ("late_kernel", 1.130, 0.007),
]


def test_launches_pair_with_device_work_in_order():
    got = spans.pairs(trace(HOST, DEVICE))
    assert [round(d, 6) for _, d in got] == [0.001, 0.002, 0.0005, 0.003, 0.0025, 0.004,
                                             0.0002, 0.0015, 0.007]
    assert got[0][0] == pytest.approx(1.0022)


def test_card_clock_ahead_of_the_hosts_still_pairs():
    # the profiler may place every device event before its launch call
    early = [(n, s - 0.004, d) for n, s, d in DEVICE]
    assert spans.pairs(trace(HOST, early)) == spans.pairs(trace(HOST, DEVICE))
    assert read("ks.ms_per_req", trace(HOST, early)) == pytest.approx(9.7)


def test_sync_calls_and_events_are_not_paired():
    assert not spans.is_launch("cudaStreamSynchronize")
    assert not spans.is_launch("cudaLaunchHostFunc")
    assert not spans.is_launch("aten::copy_")
    assert spans.is_launch("cuLaunchKernel") and spans.is_launch("cudaMemcpyAsync")
    for name in ("Stream Sync", "Event Sync", "Context Sync", "Stream Wait Event"):
        assert not spans.is_device_work(name)
    assert [spans.kind(n) for n in ("cudaMemcpyAsync", "Memcpy DtoD (Device -> Device)",
                                    "cudaMemsetAsync", "Memset (Device)", "cudaLaunchKernel",
                                    "mac_kernel")] == ["copy"] * 2 + ["set"] * 2 + ["kernel"] * 2


def test_nested_spans_count_once():
    tr = trace(HOST, DEVICE)
    assert spans.outermost(tr, {"tensor"}) == [(1.001, pytest.approx(1.021))]
    seconds, count = spans.within(tr, ("tensor",))
    assert count == 1 and seconds == pytest.approx(0.001 + 0.002 + 0.0005)
    seconds, count = spans.within(tr, ("bfv.mul",))
    assert count == 1 and seconds == pytest.approx(0.0147)  # all but the last launch


def test_a_launch_outside_every_span_is_given_to_none():
    tr = trace(HOST, DEVICE)
    named = ("tensor", "ks.mod_up", "ks.inner", "ks.mod_down", "rescale")
    assert spans.within(tr, named)[0] == pytest.approx(0.0147)
    total = sum(d for _, d in spans.pairs(tr))
    assert total == pytest.approx(0.0147 + 0.007)


def test_counts_that_do_not_pair_read_nothing():
    # a device event lost at the end or in the middle: aligned from the end,
    # a copy launch would meet a kernel
    for tr in (trace(HOST, DEVICE[:-1]), trace(HOST, DEVICE[:3] + DEVICE[4:]),
               trace(HOST[:-1], DEVICE)):
        assert spans.pairs(tr) is None
        assert spans.within(tr, ("tensor",)) is None
        for m in ("tensor.ms_per_req", "ks.ms_per_req", "ks.per_req", "rescale.ms_per_req"):
            assert read(m, tr) is None


def test_device_events_lost_at_the_start_leave_their_launches_out():
    tr = trace(HOST, DEVICE[2:])
    got = spans.pairs(tr)
    assert [round(d, 6) for _, d in got] == [0.0005, 0.003, 0.0025, 0.004, 0.0002, 0.0015,
                                             0.007]
    assert read("tensor.ms_per_req", tr) == pytest.approx(0.5)
    assert read("ks.ms_per_req", tr) == pytest.approx(9.7)
    assert read("ks.per_req", tr) == 1.0


def test_no_device_event_or_no_span_reads_nothing():
    # the CPU tests' traced slices hold no device event
    assert read("ks.per_req", trace(HOST, [])) is None
    # a program without spans (the launches pair, nothing is named)
    bare = trace([op for op in HOST if op[0].startswith("cu")], DEVICE)
    assert spans.pairs(bare) is not None
    for m in ("tensor.ms_per_req", "ks.ms_per_req", "ks.per_req", "rescale.ms_per_req"):
        assert read(m, bare) is None


def test_the_four_readers():
    tr = trace(HOST, DEVICE)
    assert read("tensor.ms_per_req", tr) == pytest.approx(3.5)
    assert read("ks.ms_per_req", tr) == pytest.approx(3.0 + 2.5 + 4.0 + 0.2)
    assert read("ks.per_req", tr) == 1.0
    assert read("rescale.ms_per_req", tr) == pytest.approx(1.5)


def test_ks_per_req_counts_every_key_applied():
    # a fan: one ModUp, then three keys and two ModDowns
    host = [("fan", 2.0, 0.05), ("ks.mod_up", 2.001, 0.001)]
    host += [("ks.inner", 2.01 + 0.005 * i, 0.002) for i in range(3)]
    host += [("ks.mod_down", 2.03 + 0.005 * i, 0.002) for i in range(2)]
    host += [("cudaLaunchKernel", 2.0105 + 0.005 * i, 0.0001) for i in range(3)]
    dev = [(f"mac_kernel_{i}", 2.1 + i * 0.01, 0.001) for i in range(3)]
    tr = trace(host, dev)
    assert read("ks.per_req", tr) == 3.0
    assert read("ks.ms_per_req", tr) == pytest.approx(3.0)
    assert read("rescale.ms_per_req", tr) is None
