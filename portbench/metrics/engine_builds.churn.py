"""Engine, in the churn cell: index builds and plan misses inside the
window, as ``engine_builds`` (an update that forced a rebuild shows here
and in the next draw's latency)."""
from portbench.lib.manifest import HERE, load_module

read = load_module(HERE / "metrics" / "engine_builds.py").read
