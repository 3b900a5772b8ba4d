"""The 95th percentile (nearest rank) of the churn cell's draw latencies:
``draw_p95_ms``, under a name of its own so that its bound follows its
own spread."""
from portbench.lib.manifest import HERE, load_module

read = load_module(HERE / "e2e" / "draw_p95_ms.py").read
