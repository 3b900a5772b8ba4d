"""Poisson draws completed in the window over the window's seconds."""


def read(win):
    n = len(win.latencies.get("draw", []))
    return n / win.seconds if n else None
