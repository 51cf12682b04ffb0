"""galois.per_req: single-key automorphisms per request (rotations and
conjugations, each with its key switch), the number of the program's
`galois` spans in the traced request (fhebench/spans.py). Moves
latency_p50_ms: each costs a K4 launch, a ModDown and two gathers."""

from fhebench.spans import within


def read(tr):
    got = within(tr, ("galois",))
    return None if got is None else float(got[1])
