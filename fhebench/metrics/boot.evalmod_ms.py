"""boot.evalmod_ms: the median per request of the bootstrap's EvalMod (the
Chebyshev sine of both halves; CUDA events at the Bootstrapper's phase
marks), in ms. Moves latency_p50_ms."""

import statistics


def read(tr):
    got = [p["evalmod"] for p in tr.phases if "evalmod" in p]
    return statistics.median(got) if got else None
