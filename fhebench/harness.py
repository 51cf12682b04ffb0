"""One run of one cell: set-up, warm-up, a closed loop of one client for the
window, the reference's check, and the result line.

A cell is a workload of BENCHMARK.json: a configuration (configs/<name>.json,
the deployment), a traffic mix (traffic/<name>.json, which names its circuit
in circuits/<circuit>.py) and what belongs to the pair (cells/<workload>.json:
the limits, plan parameters). Per-layer metrics are read by
metrics/<metric>.py. Everything is found by name; nothing here names a cell.

The functions take a `device` so that the tests can run them on the CPU at
CI presets; the command (run.py) runs only on the card.
"""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np

from fhebench import inputs
from fhebench.trace import PASSES_PER_LAUNCH, Trace, events

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gpufhe_tpu")
GIB = 2.0**30
# the traced run's first slice: from this share of the window, until it
# holds this many seconds and requests, or at most this many requests
TRACE_SLICE = (0.25, 0.5, 3, 40)


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """fhebench/<kind>/<name>.py as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"fhebench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_files(w: dict) -> tuple[dict, dict, dict]:
    """(configuration, traffic mix, cell) of a workload entry."""
    return (load_json(HERE / "configs" / f"{w['config']}.json"),
            load_json(HERE / "traffic" / f"{w['traffic']}.json"),
            load_json(HERE / "cells" / f"{w['name']}.json"))


def applies(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


class Marks:
    """Phase times of one request: CUDA events on the card (no sync inside
    the request), the host clock on the CPU."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.names, self.stamps = [], []
        self.mark("start")

    def mark(self, name: str) -> None:
        if self.cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.stamps.append(ev)
        else:
            self.stamps.append(time.perf_counter())
        self.names.append(name)

    def ms(self) -> dict:
        """{phase: ms from the previous mark}, once the request has synced."""
        if self.cuda:
            gaps = [a.elapsed_time(b) for a, b in zip(self.stamps, self.stamps[1:])]
        else:
            gaps = [(b - a) * 1e3 for a, b in zip(self.stamps, self.stamps[1:])]
        return dict(zip(self.names[1:], gaps))


def keep(out, slot=None):
    """A copy of a request's output (its components in `out.c`) that the
    library can no longer touch: cloned the first time, then copied into
    the same buffers, so that which requests the sample keeps changes no
    allocation (the allocator's layout, and with it the peak, would
    otherwise depend on the seed)."""
    if slot is None or [t.shape for t in slot.c] != [t.shape for t in out.c]:
        slot = copy.copy(out)
        slot.c = [t.clone() for t in out.c]
        return slot
    for dst, src in zip(slot.c, out.c):
        dst.copy_(src)
    for name, value in vars(out).items():
        if name != "c":
            setattr(slot, name, value)
    return slot


def _launch_counts(cuda: bool) -> dict:
    """The library's launch counters of K1, K3 and K4, as kernels launched."""
    if not cuda:
        return dict.fromkeys(PASSES_PER_LAUNCH, 0)
    from gpufhe_tpu_torch.ops import convert_cuda, mac_cuda, ntt_cuda

    k = {"K1": ntt_cuda.KERNEL, "K3": convert_cuda.KERNEL, "K4": mac_cuda.KERNEL}
    return {g: kern.launches * PASSES_PER_LAUNCH[g] for g, kern in k.items()}


class Slices:
    """The traced run's two profiled slices (fhebench/trace.py): the first,
    of the card's activity, from start_share of the window until it holds
    at least least_requests requests and least_s seconds, or most_requests;
    then the second, host ops as well, for one request."""

    def __init__(self, seconds: float, trace_slice: tuple, cuda: bool, sync):
        self.start_at = trace_slice[0] * seconds
        self.least_s, self.least_req, self.most_req = trace_slice[1:]
        self.cuda, self.sync = cuda, sync
        self.stage = 0  # 0 before, 1 first slice, 2 second slice, 3 done
        self.prof = self.first = self.second = None
        self.requests = 0

    def warm(self, request) -> None:
        """Profile one request during set-up, so that the profiler's first
        start (CUPTI's initialisation, seconds long) falls outside the window."""
        from torch.profiler import ProfilerActivity

        self._start([ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])
        request()
        self.sync()
        self.prof.__exit__(None, None, None)
        self.prof = None

    def _start(self, activities):
        from torch.profiler import profile

        self.sync()
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        return time.perf_counter()

    def before(self, elapsed: float) -> bool:
        """Called before each request; True while the request is profiled."""
        from torch.profiler import ProfilerActivity

        if self.stage == 0 and elapsed >= self.start_at:
            self.counts0 = _launch_counts(self.cuda)
            # (the CPU tests have no card to trace: they trace the host)
            self.t_from = self._start([ProfilerActivity.CUDA if self.cuda else
                                       ProfilerActivity.CPU])
            self.stage = 1
        elif self.stage == 2 and self.second is None and self.prof is None:
            self._start([ProfilerActivity.CPU, ProfilerActivity.CUDA])
        return self.stage in (1, 2)

    def after(self, t_end: float) -> None:
        """Called after each request has synchronised."""
        self.t_last = t_end
        if self.stage == 1:
            self.requests += 1
            if self.requests >= self.most_req or (self.requests >= self.least_req
                                                  and t_end - self.t_from >= self.least_s):
                self._end_first()
        elif self.stage == 2 and self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.second, self.prof, self.stage = events(self.prof), None, 3

    def _end_first(self) -> None:
        self.prof.__exit__(None, None, None)
        counts = _launch_counts(self.cuda)
        self.first = (events(self.prof)[0], self.t_last - self.t_from,
                      {g: v - self.counts0[g] for g, v in counts.items()})
        self.prof, self.stage = None, 2

    def trace(self, least: dict, phases: list) -> Trace:
        if self.stage == 1:  # the window closed inside the first slice
            self._end_first()
        if self.first is None:
            return Trace(0, 0.0, [], _launch_counts(False), least, phases)
        kernels, span, counts = self.first
        if kernels:  # the device's own span of the slice
            span = (max(start + dur for _, start, dur in kernels)
                    - min(start for _, start, _ in kernels))
        gap_kernels, host = self.second or ([], [])
        return Trace(self.requests, span, kernels, counts, least, phases, gap_kernels, host)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_start: float | None = None, files: tuple | None = None) -> dict:
    """One run; returns the result line's object. `files` overrides the
    (configuration, mix, cell) read for the workload (the tests' CI presets)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest()
    w = workload(man, name)
    cfg, mix, cell = files or cell_files(w)
    circuit_mod = load_module("circuits", mix["circuit"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    stamps = {"imports": time.perf_counter()}
    if cuda:
        from gpufhe_tpu_torch.ops import cuda_build

        cuda_build.build_all(("ntt", "convert", "mac"))
        stamps["build"] = time.perf_counter()
    circuit = circuit_mod.Circuit(cfg, cell, mix, seed, device)
    sync()
    stamps["keys_plans_pool"] = time.perf_counter()
    pool = circuit.pool
    for i in range(min(2, len(pool))):  # every shape the window uses
        circuit.request(pool[i])
        sync()
    slices = Slices(seconds, TRACE_SLICE, cuda, sync) if trace else None
    if trace:
        slices.warm(lambda: circuit.request(pool[0]))
    # The client collects the garbage in reference cycles at the end of
    # each request, with automatic collection off in the window and the
    # set-up's objects frozen (so that a collection walks only what the
    # window made). A bootstrap leaves about 0.7 GB of device tensors in
    # cycles a request; left to the automatic collector, they were freed
    # at points that drift against the requests, so the peak rose with
    # the number of requests a window fitted (28.13 to 28.87 GiB on an
    # H100) and a full collection stalled a request for 0.1 s now and then.
    gc.collect()
    gc.freeze()
    stamps["warm_up"] = time.perf_counter()
    setup_s = stamps["warm_up"] - t_start
    log("setup " + _steps(stamps, t_start))

    marked = hasattr(circuit, "request_marked")
    k_sample = mix["sample"]
    pick = inputs.stream(seed, "sample")
    lat, kept, phases = [], [], []
    gc_s = 0.0
    gc.disable()
    t_win = time.perf_counter()
    t_end = t_win
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 - t_win >= seconds and i > 0:
            break
        profiled = slices.before(t0 - t_win) if trace else False
        if profiled:
            t0 = time.perf_counter()
        idx = i % len(pool)
        if trace and marked and not profiled:  # phases of unprofiled requests only
            m = Marks(cuda)
            out = circuit.request_marked(pool[idx], m.mark)
        else:
            m = None
            out = circuit.request(pool[idx])
        sync()
        t_end = time.perf_counter()
        lat.append(t_end - t0)
        if m is not None:
            phases.append(m.ms())
        if trace:
            slices.after(t_end)
        # the checked requests: a uniform sample of those the window
        # completes, drawn from the seed (reservoir sampling)
        if i < k_sample:
            kept.append((idx, keep(out)))
        else:
            j = int(pick.integers(0, i + 1))
            if j < k_sample:
                kept[j] = (idx, keep(out, kept[j][1]))
        t_gc = time.perf_counter()
        gc.collect()
        gc_s += time.perf_counter() - t_gc
        i += 1
    window_s = t_end - t_win
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    gc.enable()
    gc.unfreeze()

    samples = [(idx, circuit.export(out)) for idx, out in kept]
    result_trace = (slices.trace(circuit_mod.work(cfg, cell, mix).least_s(), phases)
                    if trace else None)
    del circuit, pool, kept, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checked = circuit_mod.judge(cfg, cell, mix, seed, samples, device)
    correct = all(value <= limit for _, value, limit in checked)
    log(f"check {time.perf_counter() - t_check:.3f} s over {len(samples)} requests")

    e2e = {
        "req_per_s": len(lat) / window_s,
        "latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "latency_p95_ms": float(np.percentile(lat, 95)) * 1e3,
        "peak_mem_gib": peak / GIB,
        "setup_s": setup_s,
    }
    metrics = {}
    if not trace:
        for m in man["end_to_end"]:
            if applies(m, name):
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        for m in man["per_layer"]:
            if applies(m, name):
                value = load_module("metrics", m["name"]).read(result_trace)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": w["chips"], "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": len(lat), "failed": 0, "metrics": metrics,
            "device": dev}
    if trace:
        dev["busy_s"] = result_trace.busy_s()
        dev["window_s"] = result_trace.window_s
        line["breakdown"] = result_trace.breakdown()
    log(f"window {window_s:.3f} s, {len(lat)} requests, {gc_s:.3f} s collecting; " + ", ".join(
        f"{k} {v}" for k, v in e2e.items()))
    line["checked"] = {n: {"value": v, "limit": lim} for n, v, lim in checked}
    for n, v, lim in checked:
        log(f"checked {n} {v} limit {lim}")
    return line


def _steps(stamps: dict, t_start: float) -> str:
    parts, prev = [], t_start
    for k, v in stamps.items():
        parts.append(f"{k} {v - prev:.3f} s")
        prev = v
    return ", ".join(parts)


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the run may not hold, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
