"""Tracing and profiling utilities.

Counterpart of gpufhe_tpu/utils/profiling.py on torch.profiler: `stage`
names a region (a span; the reference opens a jax.named_scope), `trace`
captures the enclosed region, the card's kernels included, and writes it to
`log_dir` as a Chrome trace (chrome://tracing, Perfetto); `Timer` is a
structured wall-clock timer for per-op throughput logging.

The program opens spans at its layer boundaries (the multiplies, the
tensor, the key switch's ModUp, inner product and ModDown, the rescales,
each single-key automorphism, the bootstrap and its phases, each fan);
PERF.md names them all. A span is
recorded only while a torch.profiler profile records:

- no profiler: `stage` returns one shared no-op context manager. It reads
  one flag and allocates nothing: about 0.3 us a span on a CPU core, where
  torch.profiler.record_function costs about 10 us even with no profiler;
- a profiler recording: `stage` opens torch's fast record function, a
  `cpu_op` whose parent is given by nesting and whose start is on the
  profiler's host clock (time.time_ns), the clock of the CUDA runtime calls
  that launch the card's work; about 1 us a span with the host traced. It
  is not a `user_annotation`: kineto mirrors every user annotation as a
  `gpu_user_annotation` event on the device's timeline, which reads as
  device time to anything that unions the device's events.

So spans appear in any torch.profiler trace taken with CPU activity, such
as `trace` below, and nowhere else.

Usage:
    from gpufhe_tpu_torch.utils.profiling import stage, trace, Timer

    with trace("fhe-trace"):                 # a Chrome trace of a region
        with stage("keyswitch"):             # a named span inside it
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
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()  # reentrant: one instance serves every span


def stage(name: str):
    """A named span (a `cpu_op`) in torch.profiler traces; a shared no-op
    while no profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


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
