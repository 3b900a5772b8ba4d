"""Sampling: the share of the profiled device time spent in operations
that are not the program's own kernels (library kernels, copies and
fills: the per-node route's float64 torch work), in %."""


def read(t):
    if not t.traced:
        return None
    total = t.device_s()
    if total <= 0:
        return None
    return 100.0 * t.device_s(lambda n: not t.is_own(n)) / total
