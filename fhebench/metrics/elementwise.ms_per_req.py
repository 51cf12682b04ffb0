"""elementwise.ms_per_req: device time per request of every kernel that is
not K1, K3 or K4 (the int64 torch ops of ops/modops.py, gathers and copies)
in the traced slice, in ms. Moves latency_p50_ms."""


def read(tr):
    if not tr.requests or not tr.kernels:
        return None
    return sum(d for name, _, d in tr.kernels if tr.group(name) is None) / tr.requests * 1e3
