"""rescale.ms_per_req: device time per request of the work launched inside
the program's outermost `rescale` spans (the CKKS rescales, BGV's
ModSwitch), in the traced request (fhebench/spans.py), in ms. Moves
latency_p50_ms."""

from fhebench.spans import within


def read(tr):
    got = within(tr, ("rescale",))
    return None if got is None else got[0] * 1e3
