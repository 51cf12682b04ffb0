"""The program's spans in the second traced slice: device time by the layer
that launched it.

The program opens spans (torch.profiler `cpu_op`s named by the library's
`utils.profiling.stage`) at its layer boundaries: the multiply, the tensor,
the key switch's ModUp, inner product and ModDown, the rescale, the
bootstrap and its phases. The second slice of a traced run (one request,
host and card traced; fhebench/trace.py) holds them among its host ops,
beside the CUDA runtime calls that launch the card's work.

The slice's launch calls (kernel launches, copies and sets, in start order)
pair one to one with its device events (kernels, copies and sets, in start
order; synchronisation events left out): the library runs on one stream, so
the n-th launch is the n-th device event. Each device event is then given
to the spans open at its launch call's midpoint, the innermost and every
one around it.

On an H100 the profiler now and then records no device event for the first
launches of a trace: the first 2, 7 and 27 launches (all within its first
millisecond) in 3 of about 60 traced requests, and no other record lost.
So where there are k more launch calls than device events, the first k
calls are left out. The card's timestamps cannot check a pairing: they lie
up to 4 ms before their launch calls' in some traces (the profiler's
offset between the two clocks). What each launch put on the card can: a
pairing is kept only if every kernel launch meets a kernel, every copy a
copy and every set a set; otherwise nothing is read rather than a guess.
"""

from __future__ import annotations

import bisect

# CUDA calls (cuda* and the lower-level cu*) that put one event on the device's timeline
LAUNCH_WORDS = ("LaunchKernel", "Memcpy", "Memset")
# device events that are no work of their own (kineto's synchronisation records)
SYNC_WORDS = ("Sync", "Wait Event")


def is_launch(name: str) -> bool:
    return name.startswith("cu") and any(w in name for w in LAUNCH_WORDS)


def is_device_work(name: str) -> bool:
    return not any(w in name for w in SYNC_WORDS)


def kind(name: str) -> str:
    """What a launch call or a device event moves: a copy, a set or a kernel."""
    return "copy" if "Memcpy" in name else "set" if "Memset" in name else "kernel"


def pairs(tr) -> list | None:
    """[(launch midpoint s, device seconds)] of the second slice, launches
    in start order; None where it traced no device event, has fewer launch
    calls than device events, or a launch meets a device event of another
    kind."""
    launches = sorted((s, d, name) for name, s, d in tr.host_ops if is_launch(name))
    work = sorted((s, d, name) for name, s, d in tr.gap_kernels if is_device_work(name))
    if not work or len(launches) < len(work):
        return None
    launches = launches[len(launches) - len(work):]
    if any(kind(lname) != kind(dname) for (_, _, lname), (_, _, dname) in zip(launches, work)):
        return None
    return [(s + d / 2, dev) for (s, d, _), (_, dev, _) in zip(launches, work)]


def outermost(tr, names) -> list:
    """[(start, end)] of the spans named in `names` that no other span named
    there holds, in start order (on one thread, spans nest)."""
    out = []
    for s, end in sorted((s, s + d) for name, s, d in tr.host_ops if name in names):
        if out and s < out[-1][1]:
            continue
        out.append((s, end))
    return out


def within(tr, names) -> tuple[float, int] | None:
    """(device seconds of the events launched inside the outermost spans
    named in `names`, the number of those spans) over the second slice's
    one request; None where it pairs no launches or holds no such span."""
    paired = pairs(tr)
    spans = outermost(tr, set(names))
    if paired is None or not spans:
        return None
    mids = [m for m, _ in paired]
    cum = [0.0]
    for _, d in paired:
        cum.append(cum[-1] + d)
    total = 0.0
    for s, e in spans:
        total += cum[bisect.bisect_right(mids, e)] - cum[bisect.bisect_left(mids, s)]
    return total, len(spans)
