"""ks.ms_per_req: device time per request of the work launched inside the
program's key-switch spans, `ks.mod_up` (iNTT, ModUp, NTT of the digits),
`ks.inner` (one key applied: K4) and `ks.mod_down` (iNTT, ModDown, NTT), in
the traced request (fhebench/spans.py), in ms. Moves latency_p50_ms."""

from fhebench.spans import within


def read(tr):
    got = within(tr, ("ks.mod_up", "ks.inner", "ks.mod_down"))
    return None if got is None else got[0] * 1e3
