"""Tracing and profiling utilities.

Counterpart of gpufhe_tpu/utils/profiling.py on torch.profiler: `stage`
names a region (torch.profiler.record_function, where the reference opens a
jax.named_scope), so every pipeline stage shows up as a named range in a
trace; `trace` captures the enclosed region, the card's kernels included,
and writes it to `log_dir` as a Chrome trace (chrome://tracing, Perfetto);
`Timer` is a structured wall-clock timer for per-op throughput logging.

Usage:
    from gpufhe_tpu_torch.utils.profiling import stage, trace, Timer

    with trace("fhe-trace"):                 # a Chrome trace of a region
        with stage("keyswitch"):             # a named range inside it
            ...

    t = Timer()
    with t.measure("ct_mul"):
        out = ct_mul(...)
        torch.cuda.synchronize()
    print(t.report())
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def stage(name: str):
    """A named range that shows up in torch.profiler traces."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace of the enclosed region (host ranges, and the card's
    kernels when a card is present) into log_dir/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Structured wall-clock timing with per-key aggregation."""

    def __init__(self):
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def measure(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[key].append(time.perf_counter() - t0)

    def report(self) -> list[dict]:
        out = []
        for key, xs in sorted(self.samples.items()):
            out.append({
                "op": key,
                "n": len(xs),
                "mean_ms": round(1e3 * sum(xs) / len(xs), 3),
                "min_ms": round(1e3 * min(xs), 3),
                "total_s": round(sum(xs), 3),
            })
        return out
