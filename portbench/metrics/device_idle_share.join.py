"""Device: 1 less the union of device activity over the profiled part of
a join window, in %."""


def read(t):
    if not t.traced or not t.device_ops or t.hi <= t.lo:
        return None
    return 100.0 * (1.0 - t.busy_s() / ((t.hi - t.lo) / 1e9))
