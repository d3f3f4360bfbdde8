"""Idle share of the device over the traced training window: the wall time
that no kernel, copy or set covers (the union of the device's intervals)."""


def read(v):
    t = v.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t["window_s"] > 0 else None
