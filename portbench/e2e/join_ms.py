"""The window's seconds over the full joins it completed, in ms."""


def read(win):
    n = len(win.latencies.get("join", []))
    return win.seconds / n * 1e3 if n else None
