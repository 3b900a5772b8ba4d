"""The 95th percentile (nearest rank) of every draw's latency in the
window, submit to the draw's count on the host, in ms."""
from portbench.metrics._yardstick import percentile


def read(win):
    xs = win.latencies.get("draw", [])
    return percentile(xs, 0.95) * 1e3 if xs else None
