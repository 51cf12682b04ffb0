"""linear.roofline: the least time of what the `linear` spans hold per
request (fhebench/work/mlp.py: the BSGS products' transforms, conversions,
inner products with their keys, and plaintext products and adds, at 4 B a
residue over HBM or the modular products over the integer peak) over the
device time launched inside those spans (linear.ms_per_req), in %. Moves
latency_p50_ms."""

from fhebench.spans import within


def read(tr):
    got = within(tr, ("linear",))
    least = tr.least_s.get("linear")
    if got is None or not got[0] or least is None:
        return None
    return 100.0 * least[0] / got[0]
