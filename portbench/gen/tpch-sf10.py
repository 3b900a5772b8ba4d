"""Tables of the ``tpch-sf10`` configuration from a seed, by numpy alone.

TPC-H's ``part``, ``partsupp`` and ``lineitem`` at scale factor 10, with
only the columns the query names, by the specification's rules (clause
4.2.3): four ``partsupp`` rows a part with the specification's supplier
keys, a line item's part key uniform over the parts, sizes and
quantities uniform in 1 .. 50; ``p`` ~ Beta(2, 10). Keys are zero-based.
``scale`` multiplies every row count (the CPU tests run at a small one).
"""
import numpy as np


def make(cfg: dict, seed: int, scale: float = 1.0) -> dict:
    t = cfg["tables"]
    n_part = max(1, round(t["Part"]["rows"] * scale))
    n_line = max(1, round(t["Lineitem"]["rows"] * scale))
    s = max(1, round(cfg["suppliers"] * scale))
    rng = np.random.default_rng(seed)
    part = np.arange(n_part, dtype=np.int64)
    ps_part = np.repeat(part, 4)
    key = ps_part + 1
    i = np.tile(np.arange(4, dtype=np.int64), n_part)
    return {
        "Part": {"pk": part,
                 "size": rng.integers(1, 51, n_part),
                 "p": rng.beta(2.0, 10.0, n_part)},
        "PartSupp": {"pk": ps_part,
                     "supp": (key + i * (s // 4 + (key - 1) // s)) % s + 1},
        "Lineitem": {"pk": rng.integers(0, n_part, n_line),
                     "qty": rng.integers(1, 51, n_line)},
    }
