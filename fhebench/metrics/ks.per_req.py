"""ks.per_req: key switches per request, the number of the program's
`ks.inner` spans (keys applied: relinearisations, rotations, conjugations,
the encapsulation's switches) in the traced request (fhebench/spans.py).
Moves latency_p50_ms: each costs a K4 launch and its ModDown."""

from fhebench.spans import within


def read(tr):
    got = within(tr, ("ks.inner",))
    return None if got is None else float(got[1])
