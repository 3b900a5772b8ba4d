"""The 95th percentile (nearest rank) of every update's latency in the
window, submit of the ``UpdateRequest`` to its version applied and the
card done with it, in ms."""
from portbench.metrics._yardstick import percentile


def read(win):
    xs = win.latencies.get("update", [])
    return percentile(xs, 0.95) * 1e3 if xs else None
