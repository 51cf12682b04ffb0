"""device.idle_pct: the share of the traced slice in which no kernel ran on
the card (100 minus the union of kernel intervals over the slice's span,
its first kernel's start to its last kernel's end), in %.
Moves req_per_s: what the card idles, the host is spending."""


def read(tr):
    if not tr.kernels or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
