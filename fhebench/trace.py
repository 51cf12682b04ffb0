"""The traced slices: what torch.profiler saw of a few steady requests,
reduced in memory to what the per-layer readers (fhebench/metrics/) need.
No Chrome trace is written.

Two slices, one after the other: the first traces the card's activity only
(the kernels and the CUDA calls that launch them), which every metric and
the device's busy and idle time read; the second, one request long, traces
the host's ops as well, and only names the idle gaps of the breakdown (host
tracing slows the host several times over, so its gaps are longer than the
first slice's)."""

from __future__ import annotations

import dataclasses

# the profiler's names of the library's hand-written kernels; the launch
# counters (ops/cuda_build.py CudaKernel.launches) count K1's entry calls,
# each of which launches two passes
KERNELS = {"K1": "k1_pass", "K3": "base_convert_kernel", "K4": "mac_kernel"}
PASSES_PER_LAUNCH = {"K1": 2, "K3": 1, "K4": 1}


@dataclasses.dataclass
class Trace:
    requests: int  # requests inside the first slice
    window_s: float  # its length: the device's span from its first kernel to its last
    kernels: list  # (name, start_s, seconds) of every device kernel it traced
    launches: dict  # "K1"/"K3"/"K4" -> kernels launched in it, counted
    least_s: dict  # "K1"/"K3"/"K4" -> (least seconds per request, bound)
    phases: list = dataclasses.field(default_factory=list)  # per request {phase: ms}
    gap_kernels: list = dataclasses.field(default_factory=list)  # the second slice's
    host_ops: list = dataclasses.field(default_factory=list)  # (name, start_s, seconds)

    def group(self, name: str) -> str | None:
        return next((g for g, k in KERNELS.items() if k in name), None)

    def kernel_s_per_request(self, g: str) -> float | None:
        """Device seconds per request of kernel group g: the traced mean per
        launch times the launches counted (the profiler can drop launches
        from a trace), over the slice's requests."""
        durs = [d for name, _, d in self.kernels if self.group(name) == g]
        if not durs or not self.requests:
            return None
        return sum(durs) / len(durs) * self.launches[g] / self.requests

    def busy_s(self) -> float:
        """Seconds in which some kernel ran: the union of kernel intervals."""
        return sum(b - a for a, b in self.busy_intervals())

    def busy_intervals(self, kernels=None) -> list:
        out = []
        for _, start, dur in sorted(self.kernels if kernels is None else kernels,
                                    key=lambda k: k[1]):
            end = start + dur
            if out and start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([start, end])
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, by name (cut to 160
        characters), and the second slice's longest idle gaps between
        kernels, each named by the innermost host op running at its middle."""
        by_name: dict = {}
        for name, _, dur in self.kernels:
            by_name[name[:160]] = by_name.get(name[:160], 0.0) + dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals(self.gap_kernels)
        gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(busy, busy[1:])),
                      reverse=True)[:top]
        idle = []
        for length, mid in gaps:
            inside = [(d, name) for name, s, d in self.host_ops if s <= mid <= s + d]
            idle.append([min(inside)[1] if inside else "host, outside any traced op", length])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}


def events(prof) -> tuple[list, list]:
    """(kernels, host ops) of a finished torch.profiler.profile, each as
    (name, start_s, seconds), from the profiler's raw events (building its
    FunctionEvents takes far longer and is not needed)."""
    from torch.autograd import DeviceType

    kernels, host = [], []
    for ev in prof.profiler.kineto_results.events():
        rec = (ev.name(), ev.start_ns() / 1e9, ev.duration_ns() / 1e9)
        if ev.device_type() == DeviceType.CUDA:
            kernels.append(rec)
        elif ev.device_type() == DeviceType.CPU:
            host.append(rec)
    return kernels, host
