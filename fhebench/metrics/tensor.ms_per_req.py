"""tensor.ms_per_req: device time per request of the work launched inside
the program's outermost `tensor` spans (the CKKS and BGV tensor; BFV's
auxiliary-basis tensor with its conversions and its t/Q rounding), in the
traced request (fhebench/spans.py), in ms. Moves latency_p50_ms."""

from fhebench.spans import within


def read(tr):
    got = within(tr, ("tensor",))
    return None if got is None else got[0] * 1e3
