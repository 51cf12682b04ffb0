"""linear.kernels_per_req: device events (kernels, copies and sets) launched
inside the program's outermost `linear` spans (ciphertext/linalg.py
BsgsPlan.apply) in the traced request, each paired with its launch call as
fhebench/spans.py pairs them. Each launch costs the host a dispatch, so
this moves latency_p50_ms where the host holds the card back in the linear
layers."""

import bisect

from fhebench.spans import outermost, pairs


def read(tr):
    paired = pairs(tr)
    spans = outermost(tr, {"linear"})
    if paired is None or not spans:
        return None
    mids = [m for m, _ in paired]
    return float(sum(bisect.bisect_right(mids, e) - bisect.bisect_left(mids, s)
                     for s, e in spans))
