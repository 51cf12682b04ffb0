"""boot.transforms_ms: the median per request of the bootstrap's two linear
transforms, CoeffToSlot and SlotToCoeff (CUDA events at the Bootstrapper's
phase marks), in ms. Moves latency_p50_ms."""

import statistics


def read(tr):
    got = [p["coeff_to_slot"] + p["slot_to_coeff"] for p in tr.phases
           if "coeff_to_slot" in p and "slot_to_coeff" in p]
    return statistics.median(got) if got else None
