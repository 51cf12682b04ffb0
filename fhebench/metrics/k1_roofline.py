"""k1_roofline: the least time of the algorithm's limb-NTTs per
request (fhebench/work/: bytes at 4 per residue over HBM, or the modular
products over the integer peak, whichever is larger) over the device time
of kernel K1 per request in the traced slice, in %. Moves latency_p50_ms."""


def read(tr):
    spent = tr.kernel_s_per_request("K1")
    least = tr.least_s["K1"][0]
    if not spent or not least:
        return None
    return 100.0 * least / spent
