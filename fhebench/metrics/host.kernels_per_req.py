"""host.kernels_per_req: device kernels launched per request in the traced
slice, the hand-written kernels by the library's launch counters and the
rest as traced. Each launch costs the host a dispatch, so this moves
latency_p50_ms where the host holds the card back."""

from fhebench.trace import KERNELS


def read(tr):
    if not tr.requests or not tr.kernels:
        return None
    rest = sum(1 for name, _, _ in tr.kernels if tr.group(name) is None)
    return (rest + sum(tr.launches[g] for g in KERNELS)) / tr.requests
