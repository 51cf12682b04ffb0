"""linear.ms_per_req: device time per request of the work launched inside
the program's outermost `linear` spans (ciphertext/linalg.py BsgsPlan.apply:
one BSGS plaintext-matrix product with its hoists, plaintext products and
adds, giant rotations and rescale), in the traced request
(fhebench/spans.py), in ms. Moves latency_p50_ms."""

from fhebench.spans import within


def read(tr):
    got = within(tr, ("linear",))
    return None if got is None else got[0] * 1e3
