"""Serving: a flush's wall time less the ``sample_batch`` calls inside it
(each synchronised in the traced run), the mean over the window's
flushes that dispatched, in ms."""


def read(t):
    flushes = [s for s in t.spans if s[0] == "flush"]
    calls = [s for s in t.spans if s[0] == "sample_batch"]
    own, i = [], 0
    for _, a, b, _ in flushes:
        inner = 0.0
        while i < len(calls) and calls[i][1] < b:
            if calls[i][1] >= a:
                inner += calls[i][2] - calls[i][1]
            i += 1
        if inner:
            own.append((b - a) - inner)
    return sum(own) / len(own) * 1e3 if own else None
