"""galois.ms_per_req: device time per request of the work launched inside
the program's `galois` spans (ciphertext/ct.py galois_core and
hoisted_galois_core: one automorphism with its key switch; a hoisted
rotation's shared ModUp lies outside), in the traced request
(fhebench/spans.py), in ms, at the pool's mean work. Moves latency_p50_ms.

The traced request's pool entry sets its level, and with it the time of
its rotations (37.5 to 100.9 ms over the five entries of the
logistic-regression step on an H100). Where the circuit names the entry's
factor in a span around the request (circuits/logreg_step.py GALOIS_NORM:
the pool's mean Galois time over this entry's, by the time's model in the
rotations' level), the time is scaled by it, so that the reading does not
depend on which entry was traced (67.0 to 69.6 ms over the same five)."""

from fhebench.spans import within

NORM = "fhebench.galois_norm="


def read(tr):
    got = within(tr, ("galois",))
    if got is None:
        return None
    norms = [float(name[len(NORM):]) for name, _, _ in tr.host_ops if name.startswith(NORM)]
    return got[0] * 1e3 * (norms[0] if len(norms) == 1 else 1.0)
