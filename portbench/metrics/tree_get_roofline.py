"""GET: the full joins' GET share of its bound, in %: the bound of every
profiled join (``_yardstick.get_work``: every position, the tables'
sizes, the searches its key groups need) over the device time of
``tree_get_kernel``."""
from portbench.metrics import _yardstick as ys


def read(t):
    if not t.traced:
        return None
    kernel = t.device_s(lambda n: "tree_get_kernel" in n)
    joins = [s for s in t.spans if s[0] == "full_join" and s[3].get("profiled")]
    if kernel <= 0 or not joins:
        return None
    nbytes, nops = ys.get_work(t.sizes["relations"], t.sizes["join"],
                               t.sizes["get_search_steps"])
    return 100.0 * len(joins) * ys.bound_s(nbytes, nops) / kernel
