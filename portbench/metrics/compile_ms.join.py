"""Index: ``QueryEngine.compile`` in a join request (the index build;
synchronised in the traced run), the mean over the window, in ms."""


def read(t):
    xs = [b - a for n, a, b, _ in t.spans if n == "compile"]
    return sum(xs) / len(xs) * 1e3 if xs else None
