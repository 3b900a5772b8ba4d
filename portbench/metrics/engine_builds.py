"""Engine: index builds and plan misses inside the window (the engine's
``CacheStats``; an update's upgrades are not builds)."""


def read(t):
    a, b = t.counters.get("stats_before"), t.counters.get("stats_after")
    if a is None or b is None:
        return None
    return float((b.shred_builds - a.shred_builds)
                 + (b.plan_misses - a.plan_misses))
